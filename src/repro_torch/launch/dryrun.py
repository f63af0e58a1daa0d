"""Dry run: a FLOP and memory estimate of every (architecture × input shape)
cell for one NVIDIA H100, on the meta device.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
for a 16×16 (or 2×16×16) TPU mesh and reads XLA's memory and cost
analyses.  Here each cell's model is built on the meta device (shapes and
dtypes, no storage), and its train step (loss, backward, ``optim.update``),
``prefill`` or ``decode_step`` runs there under
``launch.cost_analysis.analyze``: the FLOPs of its products, its argument
bytes (params, optimizer state, batch, cache) and the peak of its live
bytes, and a bound in ms at the H100's peak rates.  These are estimates
for that card, not measurements.  One JSON per cell under
``build/dryrun/`` so reruns are incremental:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

A train cell that does not fit ``HBM_BUDGET`` doubles its microbatches
until it fits or the batch will not split (the reference's auto-fit, with a
data-parallel degree of 1).  From the second microbatch on a step repeats
itself (the same products, the same live bytes above the accumulator), so
a cell of ``microbatches >= 2`` runs two of them, on a batch of two
microbatches' rows, and counts its FLOPs ``microbatches / 2`` times; the
rest of the batch is added to the argument bytes
(``tests/test_torch_dryrun.py`` holds that peak to a run of every
microbatch).  ``--multi-pod`` and ``--both-meshes`` pick TPU meshes and
have no meaning on one card, ``--fsdp`` has none without data-parallel
shards, and ``--layout`` picks sharding rules that change nothing on one
card (the port's models place no constraint): they are left out.
``lower_cell(..., data_replicas=D)`` estimates the hybrid step of D data
replicas on the card instead of the plain one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.registry import ARCH_IDS, canonical, get_config
from repro_torch.core.distributed import DeviceMesh
from repro_torch.distribution import partition
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.cost_analysis import analyze, bound_ms, storage_bytes
from repro_torch.launch.specs import batch_logical, input_specs
from repro_torch.models.api import build_model
from repro_torch.models.common import SHAPES
from repro_torch.models.convert import param_shapes
from repro_torch.training import optim
from repro_torch.training.trainer import make_hybrid_train_step, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

# long_500k needs sub-quadratic attention / bounded state.
LONG_OK = {"xlstm_350m", "zamba2_7b", "h2o_danube_3_4b"}

# NVIDIA H100 80GB HBM3, 700.00 W: torch.cuda.get_device_properties(0)
# .total_memory, 85,017,493,504 B, less the CUDA context that
# torch.cuda.mem_get_info() shows taken before anything is allocated,
# 552,402,944 B (chip_smoke.py, path 14, prints both).
HBM_BUDGET = 84_465_090_560


def skip_reason(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and canonical(arch) not in LONG_OK:
        return ("pure full attention: 500k-token KV cache / O(S^2) prefill "
                "exceeds HBM")
    return None


def lower_cell(arch: str, shape_name, microbatches: int = 1, overrides: dict | None = None,
               data_replicas: int = 1) -> dict:
    """Estimate one cell on the meta device; returns the result record.
    ``shape_name`` names a ``SHAPES`` entry or is a ``ShapeSpec``; a train
    cell with ``data_replicas > 1`` runs ``make_hybrid_train_step`` on a
    (``data_replicas``, 1) ("data", "model") mesh on the card."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    spec = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rules = partition.get_axis_rules()
    try:
        return _lower_cell(cfg, spec, microbatches, data_replicas)
    finally:
        partition.set_axis_rules(rules)


def _lower_cell(cfg, spec, microbatches: int, data_replicas: int) -> dict:
    t0 = time.time()
    model = build_model(cfg, device="meta")
    full_batch = input_specs(cfg, spec)
    extra_bytes = 0
    if spec.kind == "train":
        state = optim.state_shapes(dict(model.named_parameters()))
        run_mb, batch = microbatches, full_batch
        if data_replicas > 1:
            # the ZeRO and batch specs under the standard tp rules
            mesh = meshlib.NamedMesh((data_replicas, 1), ("data", "model"),
                                     DeviceMesh.local(data_replicas, "meta"))
            partition.set_axis_rules(meshlib.axis_rules(layout="tp"))
            shapes = param_shapes(model)
            pspecs = partition.param_specs(shapes, mesh)
            zspecs = partition.zero_specs(pspecs, shapes, mesh)
            bspecs = partition.resolve_spec_tree(batch, batch_logical(cfg, spec), mesh)
            step = make_hybrid_train_step(model, optim.OptConfig(), mesh, zspecs, bspecs,
                                          microbatches=microbatches, pspecs=pspecs)
        else:
            run_mb = min(microbatches, 2)
            rows = spec.global_batch // microbatches * run_mb
            batch = input_specs(cfg, dataclasses.replace(spec, global_batch=rows))
            extra_bytes = storage_bytes(full_batch) - storage_bytes(batch)
            step = make_train_step(model, optim.OptConfig(), microbatches=run_mb)
        cost = analyze(lambda m, s, b: step(s, b), model, state, batch)
        scale = microbatches / run_mb
        cost["flops"] *= scale
        cost["flops_by_op"] = {op: n * scale for op, n in cost["flops_by_op"].items()}
        cost["flops_by_dtype"] = {dt: n * scale for dt, n in cost["flops_by_dtype"].items()}
        for key in ("argument_bytes", "peak_bytes"):
            cost[key] += extra_bytes
    elif spec.kind == "prefill":
        with torch.no_grad():
            cost = analyze(lambda m, b: m.prefill(b), model, full_batch)
    else:
        cache = model.cache_shape(spec.global_batch, spec.seq_len)
        with torch.no_grad():
            cost = analyze(lambda m, c, b: m.decode_step(c, b), model, cache, full_batch)
    bound, bound_by = bound_ms(cost)
    return {
        "arch": canonical(cfg.name),
        "shape": spec.name,
        "data_replicas": data_replicas,
        "status": "ok",
        "seconds": round(time.time() - t0, 1),
        "num_params": cfg.num_params(),
        "num_active_params": cfg.num_active_params(),
        "num_param_leaves": sum(p.numel() for p in model.parameters()),
        "memory": {
            "argument_bytes": cost["argument_bytes"],
            "output_bytes": cost["output_bytes"],
            "temp_bytes": cost["temp_peak_bytes"],
            "peak_estimate_bytes": cost["peak_bytes"],
        },
        "cost": {key: cost[key] for key in ("flops", "flops_by_op", "flops_by_dtype")},
        "bound_ms": bound,
        "bound_by": bound_by,
        "n_chips": 1,
        "microbatches": microbatches,
    }


def cell_path(arch, shape_name, tag=""):
    suffix = f"_{tag}" if tag else ""
    return os.path.join(OUT_DIR, f"{canonical(arch)}__{shape_name}__1xH100{suffix}.json")


def run_one(arch, shape_name, force=False, microbatches=1, tag="", overrides=None,
            auto_fit=True):
    os.makedirs(OUT_DIR, exist_ok=True)
    path = cell_path(arch, shape_name, tag)
    if os.path.exists(path) and not force:
        print(f"[skip] {path} exists")
        with open(path) as f:
            return json.load(f)
    reason = skip_reason(arch, shape_name)
    if reason:
        record = {"arch": canonical(arch), "shape": shape_name, "status": "skipped",
                  "reason": reason}
    else:
        print(f"[run ] {canonical(arch)} × {shape_name} × 1xH100 ...", flush=True)
        try:
            attempts = []
            mb = microbatches
            while True:
                record = lower_cell(arch, shape_name, microbatches=mb, overrides=overrides)
                peak = record["memory"]["peak_estimate_bytes"]
                attempts.append({"microbatches": mb, "peak_bytes": peak})
                # microbatch rows must still divide the data-parallel degree
                # (1 on one card: every split of the batch does)
                dp = 1
                gb = SHAPES[shape_name].global_batch
                can_split = (SHAPES[shape_name].kind == "train" and auto_fit
                             and gb % (mb * 2) == 0 and (gb // (mb * 2)) % dp == 0)
                if peak <= HBM_BUDGET or not can_split:
                    break
                mb *= 2
                print(f"       peak {peak/2**30:.1f}GiB > budget; retry mb={mb}", flush=True)
            record["fit_attempts"] = attempts
            record["fits_hbm"] = attempts[-1]["peak_bytes"] <= HBM_BUDGET
            print(f"       ok: {record['seconds']}s flops={record['cost']['flops']:.3e} "
                  f"bound={record['bound_ms']:.3f}ms ({record['bound_by']}) "
                  f"peak_mem={record['memory']['peak_estimate_bytes']/2**30:.2f}GiB",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — record the failure, keep going
            record = {"arch": canonical(arch), "shape": shape_name, "status": "failed",
                      "error": f"{type(e).__name__}: {e}",
                      "trace": traceback.format_exc()[-2000:]}
            print(f"       FAILED: {type(e).__name__}: {str(e)[:200]}", flush=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-auto-fit", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            rec = run_one(arch, shape_name, force=args.force, microbatches=args.microbatches,
                          tag=args.tag, auto_fit=not args.no_auto_fit)
            failures += rec.get("status") == "failed"
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
