"""The port's dry run (``repro_torch.launch.cost_analysis`` and
``launch.dryrun``) against the JAX package's ``launch.hlo_analysis`` on a
single-device compile.

- A loop of 6 products of 32 × 64 by 64 × 64 counts exactly 6·2·32·64·64
  FLOPs, as ``test_hlo_analyzer_counts_scan_loops`` holds the reference's
  loop-aware count.
- For each of the ten smoke configs at 4 × 64, the FLOPs of the train step
  (loss, backward, ``optim.update``), ``prefill`` and ``decode_step`` on
  the meta device equal the reference's HLO count exactly, and the train
  step's argument bytes equal the compile's
  ``memory_analysis().argument_size_in_bytes``.  Three train steps differ
  by products one package computes and the other does not, each named and
  held exactly:
  * qwen2-vl-72b: the reference's ``lm_head`` product runs over the
    patch prefix's positions too and drops their logits after it; the
    port takes the text tail first (3 products of 2·B·S_vis·D·V: forward,
    ∂W, ∂h);
  * zamba2-7b: ``ssd_chunked`` under the reference's per-chunk
    ``jax.checkpoint`` recomputes part of each chunk in the backward, which
    the port keeps from the forward: a Mamba2 layer's gap is one
    ``ssd_chunked`` call's, measured in isolation in both packages;
  * xlstm-350m: the same for ``mlstm_chunked`` in each mLSTM layer, and
    each sLSTM layer's first recurrent step, whose ∂h₀ product the
    reference's uniform ``lax.scan`` body computes and the port skips (h₀
    is a constant zero): 2·B·H·hd·4hd.
- ``run_one`` doubles a train cell's microbatches until its estimated peak
  fits a small budget, and the FLOPs of a cell do not change with its
  microbatches.
- ``lower_cell(..., data_replicas=2)`` estimates the hybrid step: the same
  FLOPs and argument bytes as the plain step, a higher peak (the
  exchange's fp32 blocks), and the axis rules it installs for the specs
  are taken out again.
- ``lower_cell`` runs two microbatches of a cell of four or eight and
  scales them up; its argument bytes and FLOPs equal a run of every
  microbatch, and its peak is within a millionth of that run's, which
  also keeps each microbatch's loss and metric scalars until their mean
  (one layer at full width, 16 × 1,024, where a microbatch's logits and
  gradients set the peak).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro.models import ssd as jssd
from repro.models.api import build_model as jax_build_model
from repro.models.common import ShapeSpec as JShapeSpec
from repro.training import optim as joptim
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import registry
from repro_torch.configs.registry import get_config
from repro_torch.distribution import partition
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.specs import input_specs
from repro_torch.models import ssd
from repro_torch.models.api import build_model
from repro_torch.models.common import ShapeSpec
from repro_torch.training import optim, trainer

torch.set_num_threads(1)

B, S = 4, 64


def test_cost_analysis_counts_loops():
    d = 64

    def f(h, ws):
        for w in ws:
            h = torch.tanh(h @ w)
        return h.sum()

    got = analyze(f, torch.empty(32, d, device="meta"), torch.empty(6, d, d, device="meta"))
    assert got["flops"] == 6 * 2 * 32 * d * d == got["flops_by_op"]["aten.mm"]
    assert got["flops_by_dtype"] == {"float32": 6 * 2 * 32 * d * d}

    def body(h, w):
        return jnp.tanh(h @ w), None

    c = jax.jit(lambda h, ws: jax.lax.scan(body, h, ws)[0].sum()).lower(
        jax.ShapeDtypeStruct((32, d), jnp.float32),
        jax.ShapeDtypeStruct((6, d, d), jnp.float32)).compile()
    assert hlo_analysis.analyze(c.as_text())["flops"] == got["flops"]


def _core_gap(jax_core, port_core, shapes, chunk):
    """The reference's gradient FLOPs of a chunked core less the port's, on
    inputs of ``shapes`` and a nonlinear loss of the output."""
    def jloss(*a):
        return jnp.tanh(jax_core(*a, chunk=chunk)[0].astype(jnp.float32)).sum()

    grad = jax.grad(jloss, argnums=tuple(range(len(shapes))))
    compiled = jax.jit(grad).lower(
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]).compile()
    ref = hlo_analysis.analyze(compiled.as_text())["flops"]
    args = [torch.empty(s, device="meta", requires_grad=True) for s in shapes]
    port = analyze(lambda *a: torch.autograd.grad(
        torch.tanh(port_core(*a, chunk=chunk)[0].float()).sum(), a), *args)["flops"]
    return ref - port


def train_gap(arch: str, cfg) -> float:
    """The products the reference's train step computes beyond the port's
    (the module docstring names each)."""
    if arch == "qwen2_vl_72b":
        s_vis = S // 4
        return 3 * 2 * B * s_vis * cfg.d_model * cfg.vocab
    if arch == "zamba2_7b":
        h, n, p = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim, cfg.ssm.d_state, \
            cfg.ssm.head_dim
        n_mamba = round(cfg.n_layers / (cfg.attn_every + 1)) * cfg.attn_every
        per_layer = _core_gap(jssd.ssd_chunked, ssd.ssd_chunked,
                              [(B, S, h), (B, S, n), (B, S, n), (B, S, h, p)], cfg.ssm.chunk)
        return n_mamba * per_layer
    if arch == "xlstm_350m":
        h = cfg.n_heads
        d_in = int(cfg.d_model * cfg.xlstm.proj_factor)
        n_macro = max(1, cfg.n_layers // cfg.xlstm.slstm_every)
        per_mlstm = _core_gap(jssd.mlstm_chunked, ssd.mlstm_chunked,
                              [(B, S, h), (B, S, h)] + [(B, S, h, d_in // h)] * 3,
                              cfg.xlstm.chunk)
        hd = cfg.d_model // h
        return (n_macro * (cfg.xlstm.slstm_every - 1) * per_mlstm
                + n_macro * 2 * B * h * hd * 4 * hd)
    return 0.0


def reference_cost(arch: str, kind: str):
    model = jax_build_model(jreg.get_smoke_config(arch))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = jspecs.input_specs(model.cfg, JShapeSpec("smoke", S, B, kind))
    if kind == "train":
        step = jax_make_train_step(model, joptim.OptConfig())
        lowered = jax.jit(step).lower(params, joptim.state_shapes(params), batch)
    elif kind == "prefill":
        lowered = jax.jit(lambda p, b: model.prefill(p, b)).lower(params, batch)
    else:
        lowered = jax.jit(lambda p, c, b: model.decode_step(p, c, b)).lower(
            params, model.cache_shape(B, S), batch)
    compiled = lowered.compile()
    return (hlo_analysis.analyze(compiled.as_text())["flops"],
            compiled.memory_analysis().argument_size_in_bytes)


def port_cost(arch: str, kind: str) -> dict:
    cfg = registry.get_smoke_config(arch)
    model = build_model(cfg, device="meta")
    batch = input_specs(cfg, ShapeSpec("smoke", S, B, kind))
    if kind == "train":
        state = optim.state_shapes(dict(model.named_parameters()))
        step = trainer.make_train_step(model, optim.OptConfig())
        return analyze(lambda m, s, b: step(s, b), model, state, batch)
    with torch.no_grad():
        if kind == "prefill":
            return analyze(lambda m, b: m.prefill(b), model, batch)
        return analyze(lambda m, c, b: m.decode_step(c, b), model, model.cache_shape(B, S),
                       batch)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_flops_equal_the_reference(arch, kind):
    ref_flops, ref_arg_bytes = reference_cost(arch, kind)
    got = port_cost(arch, kind)
    gap = train_gap(arch, registry.get_smoke_config(arch)) if kind == "train" else 0.0
    assert got["flops"] + gap == ref_flops, (got["flops"], gap, ref_flops)
    assert got["flops"] == sum(got["flops_by_op"].values()) == sum(
        got["flops_by_dtype"].values())
    if kind == "train":
        assert got["argument_bytes"] == ref_arg_bytes


def test_auto_fit_doubles_microbatches_until_the_cell_fits(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(dryrun, "HBM_BUDGET", 60e9)
    one_layer = {"n_layers": 1}
    rec = dryrun.run_one("qwen3-0.6b", "train_4k", overrides=one_layer)
    mbs = [a["microbatches"] for a in rec["fit_attempts"]]
    peaks = [a["peak_bytes"] for a in rec["fit_attempts"]]
    assert mbs == [2 ** i for i in range(len(mbs))] and len(mbs) > 2
    assert all(a > b for a, b in zip(peaks, peaks[1:]))
    assert rec["fits_hbm"] and peaks[-1] <= 60e9 < peaks[-2]
    assert rec["microbatches"] == mbs[-1]
    assert (tmp_path / "qwen3_0_6b__train_4k__1xH100.json").exists()
    whole = dryrun.lower_cell("qwen3-0.6b", "train_4k", overrides=one_layer)
    assert rec["cost"]["flops"] == whole["cost"]["flops"]
    assert rec["memory"]["argument_bytes"] == whole["memory"]["argument_bytes"]
    assert rec["bound_ms"] == whole["bound_ms"] and rec["bound_by"] == "operations"
    skipped = dryrun.run_one("qwen3-0.6b", "long_500k")
    assert skipped["status"] == "skipped"


@pytest.mark.parametrize("microbatches", [4, 8])
@pytest.mark.parametrize("arch, one_layer", [("qwen3-0.6b", {"n_layers": 1}),
                                             ("whisper-medium", {"n_layers": 1, "n_enc_layers": 1})])
def test_two_microbatches_stand_for_all(arch, one_layer, microbatches):
    spec = ShapeSpec("mb", 1024, 16, "train")
    est = dryrun.lower_cell(arch, spec, microbatches=microbatches, overrides=one_layer)
    cfg = dataclasses.replace(get_config(arch), **one_layer)
    model = build_model(cfg, device="meta")
    step = trainer.make_train_step(model, optim.OptConfig(), microbatches=microbatches)
    whole = analyze(lambda m, s, b: step(s, b), model,
                    optim.state_shapes(dict(model.named_parameters())), input_specs(cfg, spec))
    assert est["memory"]["peak_estimate_bytes"] == pytest.approx(whole["peak_bytes"], rel=1e-6)
    assert est["memory"]["argument_bytes"] == whole["argument_bytes"]
    assert est["cost"]["flops"] == whole["flops"]


def test_hybrid_estimate_restores_the_axis_rules():
    spec, one_layer = ShapeSpec("h", 64, 8, "train"), {"n_layers": 1}
    plain = dryrun.lower_cell("qwen3-0.6b", spec, overrides=one_layer)
    rules = {"tp": "model"}
    partition.set_axis_rules(rules)
    try:
        hybrid = dryrun.lower_cell("qwen3-0.6b", spec, overrides=one_layer, data_replicas=2)
        assert partition.get_axis_rules() is rules
    finally:
        partition.set_axis_rules(None)
    assert hybrid["data_replicas"] == 2 and plain["data_replicas"] == 1
    assert hybrid["cost"]["flops"] == plain["cost"]["flops"]
    assert hybrid["memory"]["argument_bytes"] == plain["memory"]["argument_bytes"]
    assert hybrid["memory"]["peak_estimate_bytes"] > plain["memory"]["peak_estimate_bytes"]
