#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DynLP on one NVIDIA GPU and check it.

    python3 chip_smoke.py                                         # full run
    python3 chip_smoke.py --vertices 10000 --stream-vertices 20000   # shorter

Phases (each prints its lines and its seconds; any failed check raises):

1. Card and build: the card's name and power limit, and the build of the
   CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per source, all
   started together) with each kernel's registers, stack frame and spills
   from ptxas; the argkmin tile kernel at TK <= 16 must keep its lists in
   registers (no stack frame, no spill) at D = 16 and D = 128, and both
   Shiloach–Vishkin kernels (step and fixpoint) must have none either.
2. Kernels against their plain PyTorch versions on the card: the frontier
   sweep ``ell_propagate_step``, the argkmin kernel, the BSR SpMV
   ``bsr_spmv`` and the Shiloach–Vishkin step ``cc_hook_step``, on edge
   cases and at the main paths' widths, must give the same bits.  The
   sweep's cases include K = 1, 24, 32, 33, 64 with the frontier all on,
   all off, one row a warp or random, all-PAD rows, the row_offset clamp,
   both walks of a column chunk on either side of their switch and arrays
   that do not start on 16 bytes; argkmin's every list bound (TK = 1, 8,
   9, 13, 16, 17, 32) with the top-TK in the first split, in the last
   split or tied at the threshold, C below one split and M off the block
   rows; the hook step's K = 0, 1, 3, 4, 24, 33, 36, N below and off 32,
   all-PAD rows and ``nbr`` views off 16 bytes, where the whole fixpoint
   ``connected_components_cuda`` must also equal the host loop of the
   plain step (labels and step count, one launch), as on a path of 300
   vertices, a graph with no edges and with ``max_iters`` = 1 and 2, and
   at N = 1,000,000, where no warp keeps its lanes in shared memory.
   Components and the supernode init agree with the CPU; small streams
   through ``DynLP`` (default backend, and ``backend="bsr"``) on the card
   agree with the CPU within 20·δ.  For the baselines and the landmark
   backend: argkmin at the landmark assignment's geometry (C = 64 with 64
   or 37 rows sampled, and C = 37; D = 16, M = 1,024 with 1,024 or 300
   real rows, ``base_id = C``, k = 4, kth ``-inf``) bitwise;
   ``propagate_full_ell`` against ``propagate_full`` (F bitwise and the
   iteration count, launches = iterations) on a seeded problem and on a
   kNN snapshot with padding rows; ``harmonic_solve`` on the card within
   1e-4 of the CPU's.  For the mesh: argkmin at a global row offset
   ``row0`` on a 131,072-row store cut 8 ways (a shard whose block holds
   ``base_id``, one below it, one above it; duplicates tied across two
   shards), each launch bitwise to its plain version, and ``shard_sweep``'s
   merged lists and mask (one launch a shard) bitwise to one unsharded
   launch.
3. Path 1: ``DynLP`` (default backend, which must resolve to ``ell_cuda``)
   over a ``gaussian_mixture_stream`` of 5,000-vertex batches under the
   paper's 90/1/9 protocol (``--vertices``, 20,000 by default).  The sweep
   kernel's launches must equal the sweeps; the last batch's solve, run
   again with ``backend="ref"``, must agree within 20·δ; accuracy against
   the ground truth must reach 0.99.
4. Path 2: ``StreamEngine(g, delta=1e-4, ingest="device")`` (default
   backend, ``ell_cuda``) over the same stream and the same number of
   vertices, batch t+1 submitted before batch t is drained.  argkmin
   launches must equal the batches with insertions and sweep launches the
   sweeps; every batch must converge; accuracy must reach 0.99; after the
   last batch the engine's graph arrays and committed labels must equal
   path 1's byte for byte.
5. Path 3: ``StreamEngine(g, delta=1e-4, ingest="device", backend="bsr")``
   over the same stream at 100,000 vertices (``--stream-vertices``),
   pipelined.  Every solved batch must run on ``bsr`` with no slot-budget
   overflow; SpMV launches must equal the sweeps, argkmin launches the
   batches with insertions, sweep-kernel launches zero; every batch must
   converge; accuracy must reach 0.99; after path 2's last batch the
   graph arrays must equal path 2's byte for byte and the committed labels
   agree within 2e-3 (the reference's bound between ``bsr`` and ``ref``).
   Per batch it prints submit, host update, reorder + layout and solve
   times, the slot budget and the tile fill.
6. Path 4, serving and persistence, on path 3's engine at its full size:
   ``checkpoint()`` it; ``StreamEngine.restore(dir, backend=None)`` (so
   ``ell_cuda`` with device ingest, path 3's ``bsr`` rung metadata dropped)
   must give its graph arrays and store byte for byte, and
   ``device_view().query`` over every id, dead and unknown ones included,
   the host view's answers exactly.  Then ``LPService`` with its driver
   and a checkpoint cadence over the restored engine: reader threads query
   1,024 random ids in a closed loop while ``add_points`` (50 points a
   call), ``remove_points`` and ``relabel`` admit ~22 windows of 250 ops
   from the stream's next batch.  Every answer must equal the host view of
   its own commit; reads must have been served while a solve was in
   flight; every window must commit; argkmin launches must equal the
   windows with insertions and sweep launches the sweeps; an async
   checkpoint must be written.  It prints reads a second (tickets and ids,
   overall and while a solve was in flight), read and mutation commit
   latency p50/p99, view publication time, checkpoint and restore times.
   ``shutdown()`` writes the final checkpoint; an engine restored from it
   and its twin replay three windows caller-clocked to byte-identical
   graphs, stores and answers.  Last, ``DynLabelPropagation(k=5)`` on the
   card: ``fit``, ``partial_fit``, then ``score`` on unseen points ≥ 0.99.
7. The ``cc`` entry point: one call of ``connected_components_cuda`` on
   path 3's last snapshot must be one fixpoint launch and no step launch,
   and its labels must equal ``connected_components`` on the card and
   ``host_components``; then the step loop, ``cc_hook_step`` on the host (each
   step equal to its plain version, a launch a step) must give the same
   labels in as many steps.
8. Timing at path 3's last batch: the SpMV on every sweep of the solve
   (each sweep's result equal to its plain version's bits) against its
   plain version, PyTorch's BSR product and its bound; the whole solve on
   ``bsr`` against ``ell_cuda`` on the unpermuted problem; ``bsr`` against
   ``ref`` on the staged problem (the same iterates within 1e-5 over a
   fixed number of sweeps with every row on, the same predictions where
   |F − 0.5| > 20·δ, the δ-stopped gap printed); the sweep kernel on
   every sweep of the ``ell_cuda`` solve (``--save-sweeps`` writes their
   inputs for ``tools/torch_kernel_times.py``), beside an empty kernel
   launch timed the same way; argkmin at the last batch's inputs against
   its plain version and a three-call library yardstick, beside the no-FMA
   floor, and (checked bitwise first) at D = 128; ``cc_hook_step`` on
   every step of phase 7 beside an empty launch; the whole fixpoint on the
   card alone and as a call, beside the step loop, the plain version's
   loop and ``connected_components``.  Each beside its bound.
9. Path 5, the baselines: ``ITLP.step`` and exact ``STLP.step`` on the
   card, each on its own graph, over path 1's stream.  After every batch
   both graphs equal path 1's byte for byte; sweep-kernel launches equal
   ITLP's iterations; ITLP's iterations exceed DynLP's over the stream
   (Fig. 7; the batches where they do not are printed) and DynLP's
   predictions agree with STLP's at ≥ 0.97 in every batch (Fig. 8).
   Per batch: wall and solve ms of DynLP (path 1), ITLP and STLP, the
   iterations, the ITLP/DynLP ratios and STLP's dense bytes.  Then on
   path 3's last snapshot (unpermuted, as phase 8): ITLP's solve from 0.5
   (``propagate_full_ell``, held bitwise to ``propagate_full``) against
   that batch's DynLP solve; exact STLP on that graph must raise its
   ``MemoryError``.
10. Path 6, the landmark backend at 100,000 vertices: path 3's checkpoint
   restored as ``backend="landmark"`` with ``LandmarkConfig(64, 4,
   hot_ttl=1)`` and as ``backend=None`` (``ell_cuda``), each fed the
   stream's next batch as 10 sub-batches of 500 points, pipelined.  The
   latch engages; hot-set agreement with the exact engine ≥ 0.98; the
   largest hot rung ≤ half the exact rung; argkmin launches equal the
   assignment chunks plus the sub-batches with insertions, sweep launches
   the sweeps; every assignment launch (the activation refresh's ~98
   chunks and the later ones) equals its plain version bitwise on its
   kept inputs; a checkpoint of the landmark engine restores
   byte-identical.  It prints the activation refresh and cold-pass ms,
   submit and solve ms per sub-batch, hot and exact rung rows and the cold
   rows served.
11. Path 7, the mesh, at 100,000 vertices: path 3's checkpoint restored onto
   ``DeviceMesh.local(8)`` (eight shards on the card, each with its rows of
   the store and of every problem; an elastic 1 → 8 restore) five times,
   each fed path 6's 10 sub-batches pipelined: ``ell_cuda`` with
   ``transport="allgather"`` (a) and ``"halo"`` (b), ``backend="bsr"``
   under both (c), ``backend="landmark"`` with path 6's configuration (d).
   After every sub-batch (a) and (b) equal path 6's exact engine bitwise,
   (c) equals itself across transports, (d) equals path 6's landmark
   engine; the graphs equal path 6's byte for byte; sweep or SpMV launches
   are 8 a sweep, argkmin launches 8 an inserting sub-batch plus the
   landmark chunks.  (c) lies within 2e-3 of (a) (held at the full
   100,000 vertices; a reduced ``--stream-vertices`` run prints it), with
   the same predictions where (a) is more than 20·δ from 0.5, and the
   mesh's bsr and ell_cuda bodies compute the same iteration (within 1e-5
   over 30 sweeps with every row on).  Some of (c)'s per-shard SpMV
   launches keep their inputs (global block columns into the gathered
   F), each held bitwise to its plain version.  It prints, with the
   card's name and power limit, each engine's sweeps, solve ms and µs a
   sweep at the last sub-batch, the bytes each transport copied a sweep,
   the export fraction, halo batches and overflows, the ``auto:measured``
   probe's two times on the last snapshot and each shard's argkmin ms.
   Then (a)'s checkpoint restored onto no mesh (8 → 1): graph and store
   byte-identical, every answer equal.
12. Path 7b: a fresh 8-shard engine with ``ingest_order="locality"`` and
   ``transport="halo"`` over path 1's first two batches (10,000 vertices),
   beside a single-device engine with the same order: graphs and labels
   bitwise after each batch, at least one batch on the halo collective.
13. Path 8, the LM serving slice.  (a) ``PseudoLabelPipeline(k=5,
   delta=1e-4)`` on the card curates ``--vertices`` documents (20,000 by
   default) in 4 waves of 64-token documents over qwen3-0.6b's vocabulary
   of 151,936, 2% labeled (``data.synth.make_documents``, the generator of
   ``examples/semi_supervised_lm.py``): sweep launches equal the waves'
   sweeps, the last wave's solve run again with ``backend="ref"`` agrees
   within 20·δ, the pseudo-label accuracy and ``select(1, 0.7)``'s purity
   exceed 0.9.  (b) ``build_model(get_config("qwen3-0.6b"))`` at its full
   published config (28 layers, d_model 1024, GQA 16/8, head_dim 128,
   qk-norm, vocab 151,936; bf16 weights from a seeded generator) behind
   ``ServeEngine(max_batch=8, s_max=256)``: 24 requests whose prompts are
   16–64-token prefixes of curated documents, ``max_new`` 16–64.  Every
   request finishes with its ``max_new`` tokens; the logits at every
   generated position agree with the plain fp32 forward (the same weights
   upcast, dense attention, no cache, no TF32, teacher-forced over prompt
   and output) within ``LM_TOL``, the greedy tokens equal its argmax
   wherever its top-2 margin exceeds twice that, and the same serving with
   the KV cache rounded through fp8 (8 requests) must FAIL the tolerance.
   It prints the pooled decode step's median and p99 ms, tokens a second
   at 8 slots, prefill ms a prompt token, a decode step's kernel time from
   ``torch.profiler`` beside its bound, the bytes of weights and cache and
   ``max_memory_allocated``.  (c) ``prefill`` at B = 1, S = 4,096 through
   the chunked attention (q_chunk 1024, k_chunk 2048, the causal skip)
   against the dense attention and the fp32 forward, then its cache placed
   in an ``init_cache(1, 4112)`` and 16 greedy tokens decoded through it,
   each step held against the fp32 forward of its prefix; both prefill
   times beside their bound.  Path 8 runs none of the five kernels but the
   sweep.

The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.core import dynlp as dynlp_module  # noqa: E402
from repro_torch.core import itlp as itlp_module  # noqa: E402
from repro_torch.core import stlp as stlp_module  # noqa: E402
from repro_torch.core import stream as stream_module  # noqa: E402
from repro_torch.core import distributed as distributed_module  # noqa: E402
from repro_torch.core.distributed import DeviceMesh, build_stream_plan  # noqa: E402
from repro_torch.core.components import connected_components, host_components  # noqa: E402
from repro_torch.core.snapshot import LabelView, apply_halo_layout, build_host_problem  # noqa: E402
from repro_torch.core.dynlp import DynLP  # noqa: E402
from repro_torch.core.itlp import ITLP  # noqa: E402
from repro_torch.core.propagate import PropagationProblem, propagate_full  # noqa: E402
from repro_torch.core.snapshot import build_problem  # noqa: E402
from repro_torch.core.stlp import STLP, harmonic_solve  # noqa: E402
from repro_torch.core.stream import StreamEngine  # noqa: E402
from repro_torch.core.init_labels import supernode_init  # noqa: E402
from repro_torch.configs.registry import get_config, override  # noqa: E402
from repro_torch.data.pipeline import PseudoLabelPipeline  # noqa: E402
from repro_torch.data.synth import (StreamSpec, accuracy, gaussian_mixture_stream,  # noqa: E402
                                    make_documents)
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph  # noqa: E402
from repro_torch.graph.knn import SELECT_MARGIN, normalize_rows, selection_slack  # noqa: E402
from repro_torch.graph import partition  # noqa: E402
from repro_torch.graph.structures import coo_to_csr, csr_to_ell_fast  # noqa: E402
from repro_torch.ingest import incremental_knn  # noqa: E402
from repro_torch.kernels._build import load_library, ptxas_report  # noqa: E402
from repro_torch.kernels import ops as ops_module  # noqa: E402
from repro_torch.kernels import argkmin as argkmin_module  # noqa: E402
from repro_torch.kernels.argkmin import (argkmin_candidates, argkmin_geometry,  # noqa: E402
                                         argkmin_launch, argkmin_ref, resident_blocks,
                                         shard_sweep)
from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_ref, ell_bsr_layout  # noqa: E402
from repro_torch.kernels.cc_hook import (cc_fixpoint, cc_hook_ref, cc_hook_step,  # noqa: E402
                                         connected_components_cuda,
                                         connected_components_ref)
from repro_torch.kernels.ell_propagate import ell_propagate_ref, ell_propagate_step  # noqa: E402
from repro_torch.kernels import landmark_propagate as landmark_module  # noqa: E402
from repro_torch.kernels.landmark_propagate import ASSIGN_CHUNK, LandmarkConfig  # noqa: E402
from repro_torch.kernels.ops import (propagate_full_ell, run_propagation,  # noqa: E402
                                     select_backend)
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.estimator import DynLabelPropagation  # noqa: E402
from repro_torch.serving.lp_service import LPService  # noqa: E402
from repro_torch.state import problem_from_arrays  # noqa: E402
from tools.gpu_timing import QueueError, enqueue, gpu_times  # noqa: E402

DELTA = 1e-4
TOL = 20 * DELTA  # port vs port across backends/devices (the reference's own bound)
BSR_ATOL = 2e-3  # a bsr stream against an ELL one (the reference's test bound)
STREAM_VERTICES = 100_000  # paths 3, 4, 6 and 7 at full size
BSR_KEEP_EVERY = 997  # path 7 keeps the inputs of every 997th mesh SpMV (and the first 8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """``argkmin_tile_kernel<16,16>`` from a mangled kernel name."""
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E|I\w+?E)?", mangled)
    if m is None:
        return mangled[:60]
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "") or (
        [re.sub(r"^I\d*|E$", "", m.group(2))] if m.group(2) else [])
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def report_ptxas(log):
    """Registers, stack frame and spills of every kernel (nvcc -Xptxas -v);
    the argkmin tile kernel at the main path's list bound (TKB 16) for
    D = 16 and D = 128 must keep its lists in registers, and both
    Shiloach–Vishkin kernels their cells: no stack frame, no spills."""
    rep = ptxas_report(log)
    for e in sorted(rep.values(), key=lambda e: kernel_label(e.function)):
        print(f"   ptxas {kernel_label(e.function):<34} {e.registers:3d} registers  "
              f"{e.stack_bytes:3d} B stack  {e.spill_stores:3d}/{e.spill_loads:<3d} B spilled")
    for name in ("cc_hook_kernel", "cc_fixpoint_kernel"):
        hits = [e for e in rep.values() if name in e.function]
        require(len(hits) == 1, f"no ptxas report for {name}")
        e = hits[0]
        require(e.stack_bytes == 0 and e.spill_stores == 0 and e.spill_loads == 0,
                f"{name}: {e.stack_bytes} B stack, {e.spill_stores}/{e.spill_loads} B spilled")
    for d in (16, 128):
        hits = [e for e in rep.values() if f"argkmin_tile_kernelILi{d}ELi16E" in e.function]
        require(len(hits) == 1, f"no ptxas report for argkmin_tile_kernel<{d},16>")
        e = hits[0]
        require(e.stack_bytes == 0 and e.spill_stores == 0 and e.spill_loads == 0,
                f"argkmin_tile_kernel<{d},16>: {e.stack_bytes} B stack, "
                f"{e.spill_stores}/{e.spill_loads} B spilled")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            print(f"   [{self.name}: {time.perf_counter() - self.t0:.1f} s]", flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def counted():
    """Every kernel wrapper of the port, by the key its launches go under."""
    return dict(ell=ell_propagate_step, argkmin=argkmin_candidates, bsr=bsr_spmv,
                cc_step=cc_hook_step, cc_fixpoint=connected_components_cuda)


def reset_launches():
    """Set every wrapper's launch count to 0, just before a path runs."""
    for fn in counted().values():
        fn.launches = 0


def read_launches():
    """Every wrapper's launch count, read just after a path ran."""
    return {key: fn.launches for key, fn in counted().items()}


def sweep_bound(n, k, nf, rows):
    """The least time (ms) an H100 takes for one sweep whose frontier has
    ``rows`` rows, and what bounds it.  Bytes: F read once (4 Nf), frontier
    read and F', changed written for every row (6 N), and a frontier row's
    nbr, wgt, wl0, wl1 (8K + 8); an off-frontier row's are not needed.  F's
    gathers are L2 hits.  Operations: sub, mul, add, add per lane and 12 per
    row, on frontier rows."""
    nbytes = 4 * nf + 6 * n + rows * (8 * k + 8)
    flops = rows * (4 * k + 12)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations"), nbytes


# --------------------------------------------------------------------- #
def sweep_inputs(rng, n, k, nf=None, pad_rows=0.0, dead_rows=0.0, frontier_p=0.6,
                 one_per_warp=False):
    """Random frontier-sweep inputs on the card (made with numpy): a share
    ``frontier_p`` of the rows on the frontier, or one row in each 32."""
    nf = n if nf is None else nf
    nbr = rng.integers(-1, nf, size=(n, k)).astype(np.int32)
    pad = rng.random(n) < pad_rows
    nbr[pad] = -1
    wgt = (rng.uniform(0.1, 1.0, (n, k)) * (nbr >= 0)).astype(np.float32)
    wl0 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    wl1 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    dead = pad & (rng.random(n) < dead_rows)  # all-PAD rows with Wall == 0
    wl0[dead] = 0.0
    wl1[dead] = 0.0
    frontier = (np.arange(n) % 32 == 7) if one_per_warp else rng.random(n) < frontier_p
    f = rng.uniform(0, 1, nf).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (nbr, wgt, wl0, wl1, frontier, f)]


def check_sweep(name, args, delta=1e-3, row_offset=0):
    """The sweep kernel against its plain version, bitwise."""
    got_f, got_ch = ell_propagate_step(*args, delta=delta, row_offset=row_offset)
    want_f, want_ch = ell_propagate_ref(*args, delta=delta, row_offset=row_offset)
    torch.cuda.synchronize()
    err = float((got_f - want_f).abs().max()) if got_f.numel() else 0.0
    same = torch.equal(got_f.view(torch.int32), want_f.view(torch.int32))
    ch_eq = torch.equal(got_ch, want_ch)
    n, k = args[0].shape
    print(f"   sweep {name:<22} N={n:<7} K={k:<3} max|dF|={err:.1e} "
          f"bitwise={same} changed_equal={ch_eq} changed={int(got_ch.sum())}")
    require(same and err == 0.0, f"sweep {name}: kernel != plain version")
    require(ch_eq, f"sweep {name}: changed flags differ")
    return err


def argkmin_inputs(rng, c, d, m, count, k=5, dead=0.1, dup=False, real=None, kth_inf=0.1):
    """argkmin inputs on the card (made with numpy), laid out as the ingest
    path leaves them: a store of capacity ``c`` holding ``count`` rows, the
    batch of ``m`` padded rows appended last, of which the first ``real``
    are real (the rest zero, invalid in the store and in ``batch_valid``).
    Dead rows, and ``kth`` under-full (-inf) on a share ``kth_inf`` of the
    rows."""
    real = m if real is None else real
    emb = np.zeros((c, d), np.float32)
    emb[:count] = normalize_rows(rng.normal(size=(count, d)).astype(np.float32))
    if dup:
        emb[: count // 2] = emb[0]
    base = count - m
    emb[base + real:count] = 0.0
    valid = np.zeros(c, bool)
    valid[:base] = rng.random(base) >= dead
    valid[base:base + real] = True
    kth = rng.uniform(0.4, 0.9, c).astype(np.float32)
    kth[rng.random(c) < kth_inf] = -np.inf
    bvalid = np.arange(m) < real
    args = [torch.from_numpy(a).cuda() for a in
            (emb, valid, kth, emb[base:count].copy(), bvalid)]
    return dict(args=args, base=base, slack=selection_slack(d), k=k)


def check_argkmin(name, inp, topk=None, show=True):
    """The kernel against its plain version: values, ids and mask bitwise.
    With ``topk`` the kernel is launched for that list width directly, else
    through ``argkmin_candidates``.  ``show=False`` prints nothing unless
    they differ."""
    args, base, slack, k = inp["args"], inp["base"], inp["slack"], inp["k"]
    c, d = args[0].shape
    if topk is None:
        topk = min(k + SELECT_MARGIN, c)
        got = argkmin_candidates(*args, base, slack, k=k)
    else:
        got = argkmin_launch(*args, base, slack, topk=topk)
    want = argkmin_ref(*args, base, slack, topk=topk)
    torch.cuda.synchronize()
    fin = torch.isfinite(want[0])
    err = float((got[0][fin] - want[0][fin]).abs().max()) if bool(fin.any()) else 0.0
    same = [torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                        w.view(torch.int32) if w.dtype == torch.float32 else w)
            for g, w in zip(got, want)]
    if show or not all(same):
        print(f"   argkmin {name:<30} C={c:<6} D={d:<3} M={args[3].shape[0]:<5} TK={topk:<2} "
              f"bitwise val/idx/disp={same} finite={int(fin.sum())} disp={int(got[2].sum())}")
    require(all(same) and err == 0.0, f"argkmin {name}: kernel != plain version")
    return err


def argkmin_placed(rng, case, c=3000, d=16, m=200):
    """argkmin inputs that put the top-TK where the thresholded splits find
    it hardest: all in the first split (the lowest rows), all in the last
    split (just below the batch), or mass ties at the TK-th value across
    every split boundary.  M = 200 is not a multiple of the block rows."""
    inp = argkmin_inputs(rng, c, d, m, c)
    emb, batch = inp["args"][0], inp["args"][3]
    base = inp["base"]
    if case == "top-TK in the first split":
        emb[:64] = batch[torch.arange(64, device=batch.device) % m]
    elif case == "top-TK in the last split":
        emb[base - 64:base] = batch[torch.arange(64, device=batch.device) % m]
    elif case == "mass ties at the threshold":
        emb[:base:3] = emb[1]
        batch[:] = emb[1]
        emb[base:] = batch
    return inp


def argkmin_bound(inp):
    """The least time (ms) an H100 takes for one argkmin call on these
    inputs.  Operations: a multiply and an add per term of every (batch row,
    valid store row) dot product, 2·M·C_valid·D; a dead row's products change
    no output.  Bytes: the valid rows' embeddings and k-th weights, the
    batch, ``valid`` and ``disp`` once each, and val/idx (8 bytes a slot)."""
    store, valid, _, batch, _ = inp["args"]
    c, d = store.shape
    m = batch.shape[0]
    topk = min(inp["k"] + SELECT_MARGIN, c)
    cv = int(valid.sum())
    flops = 2 * m * cv * d
    nbytes = cv * (4 * d + 4) + 4 * m * d + 2 * c + 8 * m * topk
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), flops, nbytes


def bsr_inputs(rng, r, j, bs, c, empty=0.3, bare_rows=0.0, dtype=torch.float32):
    """Random row-padded BSR SpMV inputs on the card (made with numpy): a
    share ``empty`` of the slots empty (-1, zero tile), and ``bare_rows``
    of the block rows with no slot at all."""
    cols = rng.integers(0, c, size=(r, j)).astype(np.int32)
    cols[rng.random((r, j)) < empty] = -1
    cols[rng.random(r) < bare_rows] = -1
    blocks = rng.normal(0, 1, (r, j, bs, bs)).astype(np.float32)
    blocks[cols < 0] = 0.0
    x = rng.normal(0, 1, c * bs).astype(np.float32)
    return [torch.from_numpy(blocks).to(dtype).cuda(), torch.from_numpy(cols).cuda(),
            torch.from_numpy(x).to(dtype).cuda()]


def check_bsr(name, args):
    """The SpMV kernel against its plain version: the same bits."""
    got = bsr_spmv(*args)
    want = bsr_spmv_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    r, j, bs, _ = args[0].shape
    print(f"   bsr_spmv {name:<22} R={r:<6} J={j:<4} BS={bs:<4} C={args[2].shape[0] // bs:<6} "
          f"{str(args[0].dtype)[6:]:<8} slots={int((args[1] >= 0).sum()):<8} "
          f"max|dy|={err:.1e} bitwise={same}")
    require(same and err == 0.0, f"bsr_spmv {name}: kernel != plain version")
    return err


def bsr_bound(blocks, cols, x):
    """The least time (ms) an H100 takes for one SpMV on these inputs.
    Bytes: the tiles of the occupied slots (an empty slot's tile is never
    read), every column id, x and y once.  Operations: a multiply and an
    add per tile entry of the occupied slots."""
    r, j, bs, _ = blocks.shape
    occupied = int((cols >= 0).sum())
    nbytes = occupied * bs * bs * blocks.element_size() + 4 * r * j + \
        x.numel() * x.element_size() + 4 * r * bs
    flops = 2 * occupied * bs * bs
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations"), nbytes


def cc_inputs(rng, n, k, pad, pad_rows=0.0):
    """A random ELL adjacency (a share ``pad`` of the lanes -1, a share
    ``pad_rows`` of the rows all -1) and a random parent vector, on the
    card."""
    nbr = rng.integers(0, n, size=(n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < pad] = -1
    nbr[rng.random(n) < pad_rows] = -1
    return [torch.from_numpy(nbr).cuda(),
            torch.from_numpy(rng.permutation(n).astype(np.int32)).cuda()]


def off_16_bytes(t, rows=True):
    """The same values in a view that does not start on 16 bytes: rows of a
    larger buffer offset by one row (``rows``), or by one entry."""
    lead = t.shape[1] if rows else 1
    buf = torch.empty(t.numel() + lead, dtype=t.dtype, device=t.device)
    view = buf[lead:].view(t.shape).copy_(t)
    require(view.data_ptr() % 16 != 0 and view.is_contiguous(), "the view is on 16 bytes")
    return view


def check_cc(name, args, max_iters=10_000):
    """The hook step against its plain version, and the fixpoint against
    the host loop of the plain version (labels and step count), with the
    cap ``max_iters``: exactly equal.  The fixpoint must be one launch."""
    got = cc_hook_step(*args)
    want = cc_hook_ref(*args)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    before = connected_components_cuda.launches
    par, iters = connected_components_cuda(args[0], max_iters=max_iters)
    launches = connected_components_cuda.launches - before
    want_par, want_iters = connected_components_ref(args[0], max_iters=max_iters)
    fix_same = torch.equal(par, want_par) and iters == want_iters
    n, k = args[0].shape
    print(f"   cc_hook_step {name:<24} N={n:<7} K={k:<3} equal={same} "
          f"moved={int((got != args[1]).sum())}; fixpoint (cap {max_iters}) "
          f"equal={fix_same} iterations={iters}/{want_iters} launches={launches}")
    require(same, f"cc_hook_step {name}: kernel != plain version")
    require(fix_same, f"cc fixpoint {name}: kernel != the plain version's loop")
    require(launches == (1 if n else 0), f"cc fixpoint {name}: {launches} launches")
    return 0.0


def path_graph(n):
    """The path 0 - 1 - ... - n-1 as a (n, 2) ELL adjacency on the card."""
    nbr = np.full((n, 2), -1, np.int32)
    nbr[1:, 0] = np.arange(n - 1)
    nbr[:-1, 1] = np.arange(1, n)
    return torch.from_numpy(nbr).cuda()


def cc_bound(n, k):
    """The least time (ms) for one hook step over (N, K): nbr read once, par
    read for the own entry and the jump, out written, N·(4K + 12) bytes
    (the neighbor gathers of par are L2 hits)."""
    nbytes = n * (4 * k + 12)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def cc_fixpoint_bound(n, k):
    """The least time (ms) for the whole fixpoint over (N, K): nbr read once
    and the labels written once, N·(4K + 4) bytes."""
    nbytes = n * (4 * k + 4)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def fixpoint_plan(n, k):
    """The fixpoint's launch over (N, K) on this card, from its C planner:
    (blocks, row groups a warp keeps in shared memory, blocks resident)."""
    lib, out = load_library(), (ctypes.c_int * 3)()
    lib.check(lib.lib.cc_fixpoint_plan(n, k, ctypes.addressof(out)), "cc_fixpoint_plan")
    return tuple(out)


def check_cc_cases(rng):
    """The hook step and the fixpoint against their plain versions on the
    card (``check_cc``): the main path's width (path 3's last snapshot),
    then K on both sides of 4 and of the 32-column chunk, N below and off
    32, rows with every lane PAD, views off 16 bytes, a long path, no
    edges, step caps, and rows too many to keep in shared memory."""
    cc_errs = [check_cc(name, cc_inputs(rng, *shape, **kw)) for name, shape, kw in (
        ("main-path width", (107_200, 24, 0.4), {}),
        ("K=1", (1000, 1, 0.5), {}),
        ("K=3", (1000, 3, 0.3), {}),
        ("K=4", (1000, 4, 0.3), {}),
        ("K=33", (2000, 33, 0.3), {}),
        ("K=36", (1500, 36, 0.2), {}),
        ("N < 32", (20, 24, 0.2), {}),
        ("N=1", (1, 4, 0.0), {}),
        ("every lane PAD", (777, 5, 1.0), {}),
        ("all-PAD rows", (3001, 24, 0.2), dict(pad_rows=0.3)),
        ("K=0", (300, 0, 0.0), {}),
        ("N % 256 != 0", (4097, 8, 0.1), {}),
    )]
    for k, rows in ((3, True), (33, True), (24, False), (4, False)):
        nbr, par = cc_inputs(rng, 2000 + k, k, 0.2)
        cc_errs.append(check_cc(f"K={k} off 16 bytes", [off_16_bytes(nbr, rows), par]))
    path = path_graph(300)  # many steps
    no_edges = torch.full((500, 6), -1, dtype=torch.int32, device="cuda")
    for name, nbr, cap in (("path of 300", path, 10_000), ("path, max_iters=1", path, 1),
                           ("path, max_iters=2", path, 2), ("no edges", no_edges, 10_000)):
        flip = torch.arange(nbr.shape[0] - 1, -1, -1, dtype=torch.int32, device="cuda")
        cc_errs.append(check_cc(name, [nbr, flip], max_iters=cap))
    # rows too many for a warp to keep its lanes in shared memory: every
    # warp strides over several row groups and reads nbr from device memory
    # at every step
    blocks, kept, resident = fixpoint_plan(1_000_000, 24)
    require(blocks == resident and kept == 0,
            f"the fixpoint's plan at N=1000000: {blocks} blocks, {kept} kept, {resident} resident")
    cc_errs.append(check_cc("N=1000000, none kept", cc_inputs(rng, 1_000_000, 24, 0.4)))
    return cc_errs


def phase_kernels():
    rng = np.random.default_rng(0)
    errs = [
        check_sweep("main-path width", sweep_inputs(rng, 90_000, 24),
                    delta=DELTA),
        check_sweep("K=1", sweep_inputs(rng, 4096, 1)),
        check_sweep("N % 256 != 0", sweep_inputs(rng, 1000, 8)),
        check_sweep("all-PAD + Wall==0 rows",
                    sweep_inputs(rng, 3000, 16, pad_rows=0.3, dead_rows=0.5)),
        check_sweep("empty frontier",
                    sweep_inputs(rng, 2048, 8, frontier_p=0.0)),
        check_sweep("row_offset>0, Nf>N",
                    sweep_inputs(rng, 700, 8, nf=2000), row_offset=1300),
        check_sweep("row_offset clamps",
                    sweep_inputs(rng, 700, 8, nf=1500), row_offset=1000),
    ]
    # the warp-cooperative walk: one column chunk or several, a frontier
    # all on, all off, one row per warp or random, all-PAD rows, the
    # clamp, both walks of a chunk on either side of their switch, arrays
    # that do not start on 16 bytes
    for k in (1, 24, 32, 33, 64):
        for name, kw in (("all on", dict(frontier_p=1.0)), ("all off", dict(frontier_p=0.0)),
                         ("one row a warp", dict(one_per_warp=True)),
                         ("random, all-PAD rows", dict(pad_rows=0.2, dead_rows=0.5))):
            errs.append(check_sweep(f"K={k} {name}", sweep_inputs(rng, 3000 + k, k, **kw),
                                    delta=DELTA))
    errs.append(check_sweep("K=33 row_offset clamps", sweep_inputs(rng, 1000, 33, nf=1300),
                            row_offset=700))
    for k in (24, 40):  # 23 / 24 / 25 frontier rows a warp: by row, flat, flat
        for rows in (23, 24, 25):
            args = sweep_inputs(rng, 2000, k, pad_rows=0.1, frontier_p=0.0)
            for w0 in range(0, 2000, 32):
                args[4][w0:w0 + rows] = True
            errs.append(check_sweep(f"K={k} {rows} rows a warp", args, delta=DELTA))
    args = sweep_inputs(rng, 2000, 24)
    for i in (0, 1):  # nbr and wgt one entry past a 16-byte boundary
        buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device="cuda")
        args[i] = buf[1:].view(args[i].shape).copy_(args[i])
    errs.append(check_sweep("arrays off 16 bytes", args, delta=DELTA))

    c, d, m = 131072, 16, 8192  # the second main path's last argkmin call
    cases = [
        ("main-path width", argkmin_inputs(rng, c, d, m, 103192, real=5000)),
        ("main-path width, D=128", argkmin_inputs(rng, c, 128, m, 103192, real=5000)),
        ("under-full, kth=-inf", argkmin_inputs(rng, 1024, 16, 8, 10, dead=0.5,
                                                kth_inf=1.0)),
        ("dead rows, mass duplicates", argkmin_inputs(rng, 4096, 16, 64, 4000, dead=0.4,
                                                      dup=True)),
        ("C, M off the tile", argkmin_inputs(rng, 3001, 40, 100, 2950, real=77)),
        ("padding rows only", argkmin_inputs(rng, 2048, 8, 16, 1500, real=0)),
        ("TK=32, D=128", argkmin_inputs(rng, 5000, 128, 300, 4900, k=24)),
    ]
    argkmin_errs = [check_argkmin(name, inp) for name, inp in cases]
    # every list bound (TK on both sides of 8, 16, 32) where the top-TK lies
    # in the first split, in the last split, or ties at the threshold; C
    # below one split, M one past a block
    for case in ("random", "top-TK in the first split", "top-TK in the last split",
                 "mass ties at the threshold"):
        inp = argkmin_placed(np.random.default_rng(11), case)
        for topk in (1, 8, 9, 13, 16, 17, 32):
            argkmin_errs.append(check_argkmin(case, inp, topk=topk))
    for c_, d_, m_ in ((300, 16, 8), (257, 128, 3), (1, 8, 1), (2000, 40, 129)):
        argkmin_errs.append(check_argkmin("C < one split, M % 128 != 0",
                                          argkmin_inputs(rng, c_, d_, m_, c_),
                                          topk=min(13, c_)))
    argkmin_errs.append(check_row0_cases(np.random.default_rng(13)))
    inp = cases[2][1]  # every old valid row has an empty slot: all displaced
    old = inp["args"][1] & (torch.arange(1024, device="cuda") < inp["base"])
    require(torch.equal(argkmin_candidates(*inp["args"], inp["base"], inp["slack"],
                                           k=5)[2], old),
            "argkmin: the -inf kth rows are not exactly the displaced rows")

    # the SpMV: the main path's width (block rows of 107,200 rows at BS = 8,
    # a 128-slot budget about half full), then the edge cases
    bsr_errs = [check_bsr(name, bsr_inputs(rng, *shape, **kw)) for name, shape, kw in (
        ("main-path width", (13_400, 128, 8, 13_400), dict(empty=0.45)),
        ("every slot empty", (64, 4, 8, 64), dict(empty=1.0)),
        ("block rows w/o slots", (300, 6, 8, 300), dict(empty=0.2, bare_rows=0.5)),
        ("J=1", (500, 1, 16, 500), dict(empty=0.1)),
        ("C > R", (40, 5, 32, 97), {}),
        ("C < R", (60, 4, 8, 20), {}),
        ("BS=128", (6, 3, 128, 9), dict(empty=0.2)),
        ("bfloat16", (80, 7, 8, 80), dict(bare_rows=0.1, dtype=torch.bfloat16)),
    )]
    cc_errs = check_cc_cases(rng)

    # components: exact integers, so the card must match the CPU exactly
    n = 20_000
    src = rng.integers(0, n, 30_000)
    dst = rng.integers(0, n, 30_000)
    ell = csr_to_ell_fast(coo_to_csr(n, np.concatenate([src, dst]),
                                     np.concatenate([dst, src]),
                                     np.ones(60_000, np.float32)))
    cc_gpu = connected_components(ell.nbr.cuda(), ell.wgt.cuda()).labels.cpu()
    cc_cpu = connected_components(ell.nbr, ell.wgt).labels
    require(torch.equal(cc_gpu, cc_cpu), "connected_components: card != CPU")
    print(f"   connected_components N={n}: card == CPU "
          f"({int((cc_cpu == torch.arange(n, dtype=torch.int32)).sum())} components)")

    # supernode init: deterministic on the card, within ULPs of the CPU
    m = 5000
    comp = torch.from_numpy(rng.integers(0, 1500, m).astype(np.int32))
    w0 = torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32))
    w1 = torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32))
    a = supernode_init(comp.cuda(), w0.cuda(), w1.cuda(), m).cpu()
    b = supernode_init(comp.cuda(), w0.cuda(), w1.cuda(), m).cpu()
    c = supernode_init(comp, w0, w1, m)
    d = float((a - c).abs().max())
    print(f"   supernode_init M={m}: run-to-run bitwise={torch.equal(a, b)} "
          f"max|card-CPU|={d:.1e} bitwise_vs_CPU={torch.equal(a, c)}")
    require(torch.equal(a, b), "supernode_init is not deterministic on the card")
    require(d <= 1e-6, "supernode_init: card vs CPU beyond 1e-6")

    # a small stream through the whole port, card vs CPU
    spec = StreamSpec(total_vertices=1200, batch_size=400, seed=3,
                      class_sep=6.0, noise=0.8)
    gc, gg = DynamicGraph(16, 5), DynamicGraph(16, 5)
    dc, dg = DynLP(gc, delta=DELTA, device="cpu"), DynLP(gg, delta=DELTA)
    for batch, _ in gaussian_mixture_stream(spec):
        sc, sg = dc.step(batch), dg.step(batch)
        print(f"   small stream: iterations cpu={sc.iterations} card={sg.iterations} "
              f"components {sc.num_components}/{sg.num_components}")
        require(sc.num_components == sg.num_components, "components differ")
    ids = np.flatnonzero(gc.alive & (gc.labels == -1))
    diff = float(np.abs(gc.f[ids] - gg.f[ids]).max())
    far = np.abs(gc.f[ids] - 0.5) > TOL
    print(f"   small stream: max|F card - F cpu|={diff:.1e} (bound {TOL:.0e})")
    require(diff <= TOL, "small stream: card vs CPU beyond 20*delta")
    require(np.array_equal(gc.f[ids][far] >= 0.5, gg.f[ids][far] >= 0.5),
            "small stream: predictions differ away from the cutoff")

    # the same stream through DynLP(backend="bsr"): card vs CPU
    gc, gg = DynamicGraph(16, 5), DynamicGraph(16, 5)
    dc = DynLP(gc, delta=DELTA, backend="bsr", device="cpu")
    dg = DynLP(gg, delta=DELTA, backend="bsr")
    before = bsr_spmv.launches
    sweeps = 0
    for batch, _ in gaussian_mixture_stream(spec):
        sc, sg = dc.step(batch), dg.step(batch)
        sweeps += sg.iterations
        print(f"   small bsr stream: iterations cpu={sc.iterations} card={sg.iterations}")
    ids = np.flatnonzero(gc.alive & (gc.labels == -1))
    diff = float(np.abs(gc.f[ids] - gg.f[ids]).max())
    print(f"   small bsr stream: max|F card - F cpu|={diff:.1e} (bound {TOL:.0e}); "
          f"SpMV launches {bsr_spmv.launches - before} for {sweeps} sweeps")
    require(diff <= TOL, "small bsr stream: card vs CPU beyond 20*delta")
    require(bsr_spmv.launches - before == sweeps > 0, "small bsr stream: launches != sweeps")
    argkmin_errs.append(check_slice_kernels(rng))
    return max(errs), max(argkmin_errs), max(bsr_errs), max(cc_errs)


def phase_main(vertices, batch_size):
    backend = select_backend(None, device="cuda")
    print(f"   default backend on cuda: {backend}")
    require(backend == "ell_cuda", f"auto resolved to {backend!r}, want 'ell_cuda'")
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=42,
                      class_sep=6.0, noise=0.9)
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    dyn = DynLP(g, delta=DELTA)
    # observe (not change) each step's solve: its inputs and its result
    last = {}
    t = -1

    def recording(problem, f0, frontier0, **kw):
        t0 = time.perf_counter()
        res = run_propagation(problem, f0, frontier0, **kw)
        torch.cuda.synchronize()
        last.update(problem=problem, f0=f0.clone(), frontier0=frontier0.clone(),
                    kw=kw, res=res, solve_ms=(time.perf_counter() - t0) * 1e3)
        return res

    dynlp_module.run_propagation = recording
    truth = np.zeros(vertices, np.int8)
    sweeps = 0
    views, per_batch = [], []
    reset_launches()
    try:
        for t, (batch, cls) in enumerate(gaussian_mixture_stream(spec)):
            base = g.num_nodes
            st = dyn.step(batch)
            truth[base:base + len(cls)] = cls
            sweeps += st.iterations
            per_batch.append(dict(iterations=st.iterations, wall_ms=st.wall_ms,
                                  solve_ms=last["solve_ms"], digest=graph_digest(g)))
            shape = tuple(last["problem"].nbr.shape)
            print(f"   batch {t:2d}: {st.wall_ms:8.1f} ms (solve {last['solve_ms']:7.1f} ms)"
                  f"  iterations={st.iterations:4d} "
                  f"frontier={st.frontier_size:6d} components={st.num_components:5d} "
                  f"U={st.num_unlabeled:6d} (U,K)={shape} converged={st.converged}",
                  flush=True)
            require(st.converged, f"batch {t} did not converge")
            views.append(LabelView.from_graph(g, t + 1))
    finally:
        dynlp_module.run_propagation = run_propagation
    launches = read_launches()
    print(f"   sweeps={sweeps} kernel launches={launches}")
    require(launches["ell"] == sweeps and sweeps > 0,
            f"launch count {launches['ell']} != sweeps {sweeps}")

    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    require(np.isfinite(g.f[ids]).all(), "non-finite labels")
    acc = accuracy((g.f[ids] >= 0.5).astype(np.int8), truth[ids])
    print(f"   accuracy vs ground truth: {acc:.4f} over {len(ids)} vertices")
    require(acc >= 0.99, f"accuracy {acc} < 0.99")

    # the last batch's solve again, same (problem, f0, frontier), backend="ref"
    kw = dict(last["kw"], backend="ref")
    ref = run_propagation(last["problem"], last["f0"], last["frontier0"], **kw)
    u = int(last["problem"].valid.sum())
    f_ell, f_ref = last["res"].f[:u].cpu().numpy(), ref.f[:u].cpu().numpy()
    diff = float(np.abs(f_ell - f_ref).max())
    far = np.abs(f_ref - 0.5) > TOL
    same_pred = np.array_equal(f_ell[far] >= 0.5, f_ref[far] >= 0.5)
    print(f"   last batch re-solved with backend='ref' on the card: max|dF|={diff:.1e} "
          f"(bound {TOL:.0e}) bitwise={np.array_equal(f_ell, f_ref)} iterations "
          f"{last['res'].iterations}/{ref.iterations} predictions_equal={same_pred}")
    require(diff <= TOL, "ell_cuda vs ref beyond 20*delta")
    require(same_pred, "ell_cuda vs ref predictions differ away from the cutoff")
    return dict(graph={name: getattr(g, name).copy() for name in GRAPH}, views=views,
                batches=per_batch), launches


GRAPH = ("src", "dst", "wgt", "knn_idx", "knn_wgt")


def graph_digest(g):
    """A digest of the graph's arrays (edges, kNN lists, alive, labels), for
    holding another path's graph to this one batch by batch."""
    h = hashlib.blake2b(digest_size=16)
    for name in GRAPH + ("alive", "labels"):
        h.update(getattr(g, name).tobytes())
    return h.hexdigest()


def phase_stream(vertices, batch_size, prefix, backend=None):
    """``StreamEngine(ingest="device", backend=backend)`` over the stream,
    batch t+1 submitted before batch t is drained.  Wrappers observe (and
    do not change) each batch's host graph update, argkmin launch, staging
    and solve.  ``prefix`` holds an earlier path's graph arrays after its
    last batch and its committed labels after every batch: the graph must
    be equal byte for byte; the labels byte for byte on the same backend,
    within ``BSR_ATOL`` on ``bsr``."""
    ref_batches = len(prefix["views"])
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=42,
                      class_sep=6.0, noise=0.9)
    require(spec.total_vertices // batch_size >= ref_batches,
            "the engine's stream must cover the earlier path's")
    want = backend or "ell_cuda"
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    eng = StreamEngine(g, delta=DELTA, ingest="device", backend=backend)
    per, solves, last, last_argkmin, staged = {}, [], {}, {}, {}
    cur = [0]
    real_apply, real_stage = g.apply_batch, eng._stage_single
    real_layout = stream_module.ell_bsr_layout

    def apply_batch(*a, **kw):
        t0 = time.perf_counter()
        eff = real_apply(*a, **kw)
        per[cur[0]]["apply_ms"] = (time.perf_counter() - t0) * 1e3
        return eff

    def argkmin_timed(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = argkmin_candidates(*a, **kw)
        e.record()
        per[cur[0]]["argkmin"] = (s, e)
        last_argkmin.update(args=[t.clone() for t in a[:5]], base=a[5], slack=a[6], k=kw["k"])
        return out

    def stage_timed(host):  # the backend decision, and for bsr reorder + layout
        t0 = time.perf_counter()
        st = real_stage(host)
        per[cur[0]].update(stage_ms=(time.perf_counter() - t0) * 1e3, budget=st.num_slots)
        staged.update(host=host, st=st)
        return st

    def layout_seen(nbr, block_size):
        bl = real_layout(nbr, block_size)
        per[cur[0]]["fill"] = bl.fill
        return bl

    def solve_timed(problem, f0, frontier0, **kw):  # runs on the engine's solve thread
        t0 = time.perf_counter()
        res = run_propagation(problem, f0, frontier0, **kw)
        if kw.get("stream") is not None:
            kw["stream"].synchronize()
        solves.append((time.perf_counter() - t0) * 1e3)
        last.update(problem=problem, f0=f0.clone(), frontier0=frontier0.clone(), res=res,
                    kw={k: v for k, v in kw.items() if k != "stream"})
        return res

    truth = np.zeros(vertices, np.int8)
    stats, inserts, snap, views, prefix_diff = [], 0, {}, [], [0.0]

    def report(i, st):
        stats.append(st)
        r = per[i]
        ak = r["argkmin"][0].elapsed_time(r["argkmin"][1]) if "argkmin" in r else 0.0
        tiles = (f" stage {r['stage_ms']:6.1f} ms slots {r['budget']:3d} fill {r['fill']:.4f}"
                 if st.backend == "bsr" else "")
        print(f"   batch {i:2d}: submit {r['submit_ms']:8.1f} ms  host update "
              f"{r['apply_ms']:8.1f} ms (argkmin {ak:6.2f} ms){tiles}  solve {solves[i]:7.1f} ms"
              f"  iterations={st.iterations:4d} U={st.num_unlabeled:6d} (U,K)={st.bucket} "
              f"backend={st.backend} converged={st.converged}", flush=True)
        require(st.converged, f"engine batch {i} did not converge")
        require(st.backend == want, f"engine batch {i} ran on {st.backend!r}, want {want!r}")
        view = eng.committed_view()
        views.append(view)
        if i < ref_batches:  # the earlier path's batch i: compare the labels
            pv = prefix["views"][i]
            ids = np.flatnonzero(pv.alive & (pv.labels == UNLABELED))
            d = float(np.abs(view.f[ids] - pv.f[ids]).max(initial=0.0))
            prefix_diff[0] = max(prefix_diff[0], d)
            if backend is None:
                for name in ("f", "labels", "alive"):
                    require(getattr(view, name).tobytes() == getattr(pv, name).tobytes(),
                            f"engine committed {name} != the earlier path's after batch {i}")
            else:
                require(view.labels.tobytes() == pv.labels.tobytes()
                        and view.alive.tobytes() == pv.alive.tobytes(),
                        f"engine labels/alive != the earlier path's after batch {i}")
                require(d <= BSR_ATOL, f"batch {i}: |dF| {d} against the earlier path "
                        f"beyond {BSR_ATOL}")
        if i == ref_batches - 1:
            for name in GRAPH:
                require(snap[name].tobytes() == prefix["graph"][name].tobytes(),
                        f"engine {name} != the earlier path's after batch {i}")
            print(f"   after batch {i}: engine graph {'/'.join(GRAPH)} == the earlier "
                  f"path's byte for byte; committed labels max|dF| {prefix_diff[0]:.2e} "
                  f"over batches 0-{i}")

    g.apply_batch = apply_batch
    eng._stage_single = stage_timed
    stream_module.ell_bsr_layout = layout_seen
    incremental_knn.argkmin_candidates = argkmin_timed
    ops_module.run_propagation = solve_timed
    reset_launches()
    try:
        for t, (batch, cls) in enumerate(gaussian_mixture_stream(spec)):
            cur[0] = t
            per[t] = {}
            base = g.num_nodes
            t0 = time.perf_counter()
            prev = eng.submit(batch)
            per[t]["submit_ms"] = (time.perf_counter() - t0) * 1e3
            truth[base:base + len(cls)] = cls
            inserts += len(batch.ins_emb) > 0
            if t == ref_batches - 1:
                snap = {name: getattr(g, name).copy() for name in GRAPH}
            if prev is not None:
                report(t - 1, prev)
        report(t, eng.drain())
        eng.close()
    finally:
        del g.apply_batch
        del eng._stage_single
        stream_module.ell_bsr_layout = real_layout
        incremental_knn.argkmin_candidates = argkmin_candidates
        ops_module.run_propagation = run_propagation
    launches = read_launches()
    sweeps = sum(st.iterations for st in stats)
    print(f"   batches={len(stats)} with insertions={inserts}; sweeps={sweeps}; launches: "
          f"argkmin {launches['argkmin']}, sweep kernel {launches['ell']}, "
          f"SpMV {launches['bsr']}")
    require(launches["argkmin"] == inserts > 0, "argkmin launches != batches with insertions")
    solver = "bsr" if backend == "bsr" else "ell"
    require(launches[solver] == sweeps > 0, f"{solver} kernel launches != sweeps")
    require(launches["ell" if solver == "bsr" else "bsr"] == 0,
            "a kernel of the other backend was launched")
    require(len(solves) == len(stats), "a batch skipped its solve")
    if backend == "bsr":
        summary = eng.transport_summary()
        print(f"   transport_summary: {json.dumps(summary)}")
        require(summary["backend_overflows"] == 0 and summary["bsr_batches"] == len(stats),
                "a bsr batch overflowed its slot budget")
    # submit(t) returns once batch t is staged and its solve queued; it
    # waits only for batch t-1's solve (its drain), never for its own
    sub = np.array([per[i]["submit_ms"] for i in range(len(stats))])
    upd = np.array([per[i]["apply_ms"] for i in range(len(stats))])
    stg = np.array([per[i].get("stage_ms", 0.0) for i in range(len(stats))])
    print(f"   per batch, median (max): submit returned in {np.median(sub):.1f} "
          f"({sub.max():.1f}) ms, of which host update {np.median(upd):.1f} "
          f"({upd.max():.1f}) ms and staging decision {np.median(stg):.1f} ({stg.max():.1f}) "
          f"ms; its own solve then ran {np.median(solves):.1f} ({max(solves):.1f}) ms "
          f"behind it; sums: submit {sub.sum() / 1e3:.1f} s, solve {sum(solves) / 1e3:.2f} s; "
          f"store {eng.ingestor.store.capacity} rows, "
          f"{eng.ingestor.store.device_bytes() / 1e6:.1f} MB on the card")

    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    require(np.isfinite(g.f[ids]).all(), "non-finite labels")
    acc = accuracy((g.f[ids] >= 0.5).astype(np.int8), truth[ids])
    print(f"   accuracy vs ground truth: {acc:.4f} over {len(ids)} vertices")
    require(acc >= 0.99, f"accuracy {acc} < 0.99")
    return dict(last=last, argkmin=last_argkmin, launches=launches, staged=staged, engine=eng,
                prefix=dict(graph={name: getattr(g, name).copy() for name in GRAPH},
                            views=views))


# --------------------------------------------------------------------- #
# path 4: serving and persistence on path 3's engine
# --------------------------------------------------------------------- #
STATE_KEYS = ("emb", "embn", "labels", "alive", "f", "knn_idx", "knn_wgt", "src", "dst", "wgt")
STORE_KEYS = ("emb", "valid", "kth")


def dir_bytes(path):
    return sum(p.stat().st_size for p in pathlib.Path(path).rglob("*") if p.is_file())


def require_same_graph(a, b, what, keys=STATE_KEYS):
    for name in keys:
        require(getattr(a.graph, name).tobytes() == getattr(b.graph, name).tobytes(),
                f"{what}: graph {name} differs")


def require_same_state(a, b, what):
    """Graph arrays byte for byte, and the device-ingest stores equal."""
    require_same_graph(a, b, what)
    sa, sb = a.ingestor.store, b.ingestor.store
    require((sa.count, sa.capacity) == (sb.count, sb.capacity), f"{what}: store geometry")
    for name in STORE_KEYS:
        require(torch.equal(getattr(sa, name), getattr(sb, name)), f"{what}: store {name}")


def probe_ids(g):
    """Every id, the dead ones among them, and ids no view knows."""
    n = g.num_nodes
    return np.concatenate([np.arange(n), [-1, -5, n, n + 7, 2 ** 31, -2 ** 31 - 1, 2 ** 40]])


def require_same_answers(a, b, what):
    for x, y in zip(a, b):
        require(np.asarray(x).tobytes() == np.asarray(y).tobytes(), f"{what}: answers differ")


def pct(values):
    a = np.asarray(values, float)
    return f"p50 {np.percentile(a, 50):.3f} ms, p99 {np.percentile(a, 99):.3f} ms (n={len(a)})"


def serve_batches(vertices, batch_size):
    """The stream past path 3's last batch: the same generator, protocol
    and seed (its first batches are path 3's)."""
    spec = StreamSpec(total_vertices=vertices + 3 * batch_size, batch_size=batch_size,
                      seed=42, class_sep=6.0, noise=0.9)
    return list(gaussian_mixture_stream(spec))[vertices // batch_size:]


def check_path4_kernels(kept_ak, kept_sweeps):
    """argkmin and the sweep at the shapes path 4 gave them (windows of
    ~250 points against the 131,072-row store: few row blocks, hundreds of
    splits), each launch's inputs kept during the serve, against their
    plain versions bitwise."""
    c, d = kept_ak[0]["args"][0].shape
    m = kept_ak[0]["args"][3].shape[0]
    topk = min(kept_ak[0]["k"] + SELECT_MARGIN, c)
    geo = argkmin_geometry(c, d, m, topk, resident=resident_blocks(
        d, argkmin_geometry(c, d, m, topk)["tkb"], 0))
    ak_err = max(check_argkmin(f"path-4 window {i}", inp, show=i in (0, len(kept_ak) - 1))
                 for i, inp in enumerate(kept_ak))
    ms = sorted({inp["args"][3].shape[0] for inp in kept_ak})
    print(f"   argkmin on the inputs of all {len(kept_ak)} windows (M in {ms}): kernel == "
          f"plain version bitwise; geometry at M={m}: {json.dumps(geo)}")
    sweep_err = 0.0
    for a, kw in kept_sweeps:
        got_f, got_ch = ell_propagate_step(*a, **kw)
        want_f, want_ch = ell_propagate_ref(*a, **kw)
        require(torch.equal(got_f.view(torch.int32), want_f.view(torch.int32))
                and torch.equal(got_ch, want_ch), "a path-4 sweep: kernel != plain version")
        sweep_err = max(sweep_err, float((got_f - want_f).abs().max()) if got_f.numel() else 0.0)
    rows = [int(a[4].sum()) for a, _ in kept_sweeps]
    print(f"   all {len(kept_sweeps)} sweeps of the served windows (N up to "
          f"{max(a[0].shape[0] for a, _ in kept_sweeps)}, frontier rows median "
          f"{np.median(rows):.0f}): kernel == plain version bitwise")
    return ak_err, sweep_err


def replay_on_host_ingest(root, windows, views, r):
    """The served windows, in their order, caller-clocked on an engine
    restored from path 3's checkpoint with the host kNN (no argkmin, no
    service): the graph must equal the served engine's byte for byte, F
    aside, and every commit's labels its labels, with F within 20·δ on the
    rows it answers for (alive, unlabeled).  F is left out of the graph's
    bytes because under the driver a window's drain writes its solve over
    rows that the next, already applied window relabelled (the reference
    does the same); a seed answers its label, never F."""
    t0 = time.perf_counter()
    h = StreamEngine.restore(str(root / "path3"), backend=None, ingest="host")
    require(getattr(h.ingestor, "store", None) is None, "the replay engine has a device store")
    worst = 0.0
    for b in windows:
        h.submit(b)
        require(h.drain().converged, "a replayed window did not converge")
        hv, rv = h.committed_view(), views[h.commits]
        require(hv.labels.tobytes() == rv.labels.tobytes()
                and hv.alive.tobytes() == rv.alive.tobytes(),
                f"commit {h.commits}: host-ingest replay labels/alive != the service's")
        ids = np.flatnonzero(rv.alive & (rv.labels == UNLABELED))
        worst = max(worst, float(np.abs(hv.f[ids] - rv.f[ids]).max(initial=0.0)))
    h.close()
    require(h.commits == r.commits, "the replay did not reach the service's last commit")
    structure = tuple(k for k in STATE_KEYS if k != "f")
    require_same_graph(h, r, "host-ingest replay", structure)
    require(worst <= 20 * DELTA, f"host-ingest replay: max|dF| {worst} > 20·δ")
    print(f"   the {len(windows)} windows replayed caller-clocked on an engine restored from "
          f"path 3's checkpoint with ingest='host': graph {'/'.join(structure)} == the "
          f"service's byte for byte, every commit's labels equal, max|dF| {worst:.2e} "
          f"(<= 20·δ = {20 * DELTA:.0e}) ({time.perf_counter() - t0:.1f} s)")


def phase_serve(eng3, vertices, batch_size, window_ops=250, readers=3, q=1024):
    """Path 4: checkpoint path 3's engine, restore it as a default-backend
    engine, serve it through ``LPService`` with its driver and reader
    threads while about 20 windows commit, check the kernels at the shapes
    the windows gave them and the result against a host-ingest replay, shut
    down, restore the final checkpoint and replay beside a twin, then the
    estimator."""
    root = REPO / "build" / "path4"
    shutil.rmtree(root, ignore_errors=True)

    # 1. checkpoint path 3's engine after its last batch
    t0 = time.perf_counter()
    path = eng3.checkpoint(str(root / "path3"))
    save_ms = (time.perf_counter() - t0) * 1e3

    # 2. restore into a default-backend engine (ell_cuda, device ingest)
    t0 = time.perf_counter()
    r = StreamEngine.restore(str(root / "path3"), backend=None)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    require(r.backend is None and r._backend_modes == {} and r._slot_budgets == {},
            "the restored engine kept path 3's bsr rung metadata")
    require(r.commits == eng3.commits and r.ingestor.store.emb.is_cuda, "restored state")
    require_same_state(r, eng3, "restore")
    ids = probe_ids(r.graph)
    require(not r.graph.alive.all(), "the probe has no dead id")
    dv = r.device_view()
    require_same_answers(dv.query(ids), r.committed_view().query(ids),
                         "restored device view vs host view")
    require_same_answers(dv.query(ids), eng3.committed_view().query(ids),
                         "restored device view vs path 3's view")
    print(f"   checkpoint of path 3's engine: {save_ms:.1f} ms, "
          f"{dir_bytes(path) / 1e6:.1f} MB; restore (backend=None): {restore_ms:.1f} ms; "
          f"graph and store equal byte for byte; device view == host view over "
          f"{len(ids)} ids ({int((~r.graph.alive).sum())} dead)")

    # 3. serve: readers in threads, mutations from this thread, the driver
    batches = serve_batches(vertices, batch_size)
    views, stats, submits, inflight = {r.commits: r.committed_view()}, [], [], []
    pub, states = [], []
    real = dict(drain=r.drain, submit=r.submit, publish=r._publish,
                state=r.checkpoint_state)

    def drain():
        if r.in_flight:
            inflight[-1][1] = time.perf_counter()
        st = real["drain"]()
        if st is not None:
            stats.append(st)
            views[r.commits] = r.committed_view()
        return st

    def submit(batch):
        submits.append(batch)
        prev = real["submit"](batch)
        if r.in_flight:
            inflight.append([time.perf_counter(), None])
        return prev

    def publish(view):  # host time: what drain pays; the copies run on behind it
        t0 = time.perf_counter()
        dv = real["publish"](view)
        pub.append((time.perf_counter() - t0) * 1e3)
        return dv

    def state():
        t0 = time.perf_counter()
        st = real["state"]()
        states.append((time.perf_counter() - t0) * 1e3)
        return st

    solves = []  # (start, ms, sweeps) of every solve, on the engine's solve thread

    def solve_timed(problem, f0, frontier0, **kw):
        t0 = time.perf_counter()
        res = run_propagation(problem, f0, frontier0, **kw)
        if kw.get("stream") is not None:
            kw["stream"].synchronize()
        solves.append((t0, (time.perf_counter() - t0) * 1e3, res.iterations))
        return res

    def per_sweep(rows):
        return sum(ms for _, ms, _ in rows) / max(1, sum(it for _, _, it in rows))

    kept_ak, kept_sweeps = [], []  # every launch's inputs during the serve

    def argkmin_kept(*a, **kw):
        out = argkmin_candidates(*a, **kw)
        kept_ak.append(dict(args=[t.clone() for t in a[:5]], base=a[5], slack=a[6], k=kw["k"]))
        return out

    def sweep_kept(*a, **kw):  # a sweep's inputs are not written after it
        kept_sweeps.append((a, kw))
        return ell_propagate_step(*a, **kw)

    r.drain, r.submit, r._publish, r.checkpoint_state = drain, submit, publish, state
    ops_module.run_propagation = solve_timed
    svc = LPService(r, window_ops=window_ops, window_ms=50.0, max_pending_ops=4 * window_ops,
                    checkpoint_every=5, checkpoint_dir=str(root / "service"))
    hi = r.graph.num_nodes + batch_size + 64
    stop = threading.Event()
    reads = [[] for _ in range(readers)]  # (latency ms, commit, digest)
    errors = []

    def reader(i):
        rng = np.random.default_rng(1000 + i)
        while not stop.is_set():
            ids = rng.integers(-8, hi, q)
            t0 = time.perf_counter()
            try:
                res = svc.query(ids)
            except Exception as e:  # noqa: BLE001 — reported after the phase
                errors.append(e)
                return
            reads[i].append(((time.perf_counter() - t0) * 1e3, res.commit_id,
                             hashlib.blake2b(res.pred.tobytes() + res.confidence.tobytes(),
                                             digest_size=16).digest()))

    batch, cls = batches[0]
    base = r.graph.num_nodes
    tickets, relabeled = [], []
    reset_launches()
    incremental_knn.argkmin_candidates = argkmin_kept
    ops_module.ell_propagate_step = sweep_kept
    svc.start()
    threads = [threading.Thread(target=reader, args=(i,)) for i in range(readers)]
    dels = np.array_split(batch.del_ids, 3)
    chunks = range(0, len(batch.ins_emb), 50)
    for j, lo in enumerate(chunks):
        if j == len(chunks) // 2:  # the first half writes only, the second serves reads too
            t_reads = time.perf_counter()
            for th in threads:
                th.start()
        tickets.append(svc.add_points(batch.ins_emb[lo:lo + 50], batch.ins_labels[lo:lo + 50]))
        if j % 33 == 32 and dels:
            tickets.append(svc.remove_points(dels.pop()))
        if j % 40 == 39:  # seed ten points of an earlier window with their true class
            pick = np.arange(lo - 400, lo - 390)
            relabeled.append(base + pick)
            tickets.append(svc.relabel(base + pick, cls[pick]))
    for d in dels:
        tickets.append(svc.remove_points(d))
    svc.sync()
    t_done = time.perf_counter()
    incremental_knn.argkmin_candidates = argkmin_candidates
    ops_module.ell_propagate_step = ell_propagate_step
    stop.set()
    for th in threads:
        th.join(60.0)
    require(not any(th.is_alive() for th in threads), "a reader did not stop")
    wall = time.perf_counter() - t_reads
    launches = read_launches()
    require(not errors, f"a read failed: {errors[:1]}")
    st = svc.stats()
    async_ckpts = st.checkpoints_written
    svc._ckpt_mgr.wait()
    windows = len(submits)
    inserting = sum(len(b.ins_emb) > 0 for b in submits)
    sweeps = sum(s.iterations for s in stats)
    require(st.batches_admitted == st.batches_committed == len(stats) == windows > 0,
            "an admitted window did not commit")
    require(all(s.converged for s in stats), "a window did not converge")
    require(all(t.committed for t in tickets), "a mutation did not commit")
    require(launches["argkmin"] == inserting == len(kept_ak),
            "argkmin launches != windows with insertions")
    require(launches["ell"] == sweeps == len(kept_sweeps) > 0,
            "sweep kernel launches != sweeps")
    require(launches["bsr"] == 0, "the default engine launched the SpMV")
    require(st.queries_while_inflight > 0, "no read was served while a solve was in flight")
    require(async_ckpts >= 1, "no async checkpoint was written")
    require(all(s.backend == "ell_cuda" for s in stats if s.backend != "none"),
            "a window did not run on ell_cuda")

    # every answer equals the host view of its own commit (never torn)
    n_reads = 0
    for i, rows in enumerate(reads):
        rng = np.random.default_rng(1000 + i)
        for _, commit, digest in rows:
            ids_i = rng.integers(-8, hi, q)
            p, c = views[commit].query(ids_i)
            require(hashlib.blake2b(p.tobytes() + c.tobytes(), digest_size=16).digest()
                    == digest, f"reader {i}: an answer differs from commit {commit}'s view")
            n_reads += 1
    spans = [(max(a, t_reads), b if b is not None else t_done) for a, b in inflight
             if b is None or b > t_reads]
    busy = sum(b - a for a, b in spans)
    lat = [row[0] for rows in reads for row in rows]
    mut = [t.latency_ms for t in tickets]
    print(f"   served: {windows} windows of {window_ops} ops ({len(batch.ins_emb)} points, "
          f"{len(batch.del_ids)} deletes, {10 * len(relabeled)} relabels; "
          f"{inserting} with insertions), {st.batches_committed} commits, {sweeps} sweeps; "
          f"launches: argkmin {launches['argkmin']}, sweep kernel {launches['ell']}, "
          f"SpMV {launches['bsr']}; {st.deadline_admissions} deadline admissions")
    print(f"   reads (second half of the windows): {n_reads} tickets of {q} ids from {readers} "
          f"threads in a closed loop, each equal to its commit's host view; "
          f"{st.read_batches} fused gathers")
    print(f"   read rate: {n_reads / wall:.1f} tickets/s, {n_reads * q / wall:.0f} ids/s over "
          f"{wall:.2f} s; while a batch was in flight ({busy:.2f} s, "
          f"{st.queries_while_inflight} tickets): "
          f"{st.queries_while_inflight / busy if busy else 0.0:.1f} tickets/s")
    writes, served = ([x for x in solves if x[0] < t_reads],
                      [x for x in solves if x[0] >= t_reads])
    print(f"   solve time a sweep (on the solve thread, side stream synchronized): "
          f"{per_sweep(writes):.3f} ms over {len(writes)} windows with writes only, "
          f"{per_sweep(served):.3f} ms over {len(served)} windows with the readers too")
    print(f"   read latency: {pct(lat)}")
    print(f"   mutation commit latency: {pct(mut)}")
    print(f"   window solves: median {np.median([s.wall_ms for s in stats]):.1f} ms "
          f"submit-to-commit, iterations median {np.median([s.iterations for s in stats]):.0f}")
    print(f"   view publication at drain (host, its copies asynchronous): {pct(pub)}")
    print(f"   async checkpoints: {async_ckpts}, state copies under the lock {pct(states)}")
    ak_err, sweep_err = check_path4_kernels(kept_ak, kept_sweeps)
    del kept_ak[:], kept_sweeps[:]
    replay_on_host_ingest(root, submits, views, r)

    # 4. shutdown, restore the final checkpoint, replay beside a twin
    t0 = time.perf_counter()
    step = svc.shutdown()
    shutdown_ms = (time.perf_counter() - t0) * 1e3
    r.drain, r.submit, r._publish, r.checkpoint_state = (real["drain"], real["submit"],
                                                         real["publish"], real["state"])
    require(step == r.commits, "shutdown did not checkpoint the last commit")
    final = root / "service" / f"step_{step:08d}"
    t0 = time.perf_counter()
    r2 = StreamEngine.restore(str(root / "service"))
    torch.cuda.synchronize()
    restore2_ms = (time.perf_counter() - t0) * 1e3
    require(r2.commits == r.commits, "restored the wrong checkpoint")
    require_same_state(r2, r, "final checkpoint")
    replay = batches[1][0]
    twins = [LPService(e, window_ops=10 ** 6, window_ms=1e9, max_pending_ops=10 ** 6)
             for e in (r2, r)]
    mark = len(solves)
    for lo in range(0, 3 * window_ops, window_ops):
        for s in twins:
            s.add_points(replay.ins_emb[lo:lo + window_ops], replay.ins_labels[lo:lo + window_ops])
            s.sync()
    ops_module.run_propagation = run_propagation
    replayed = solves[mark:]
    require_same_state(r2, r, "replay")
    ids = probe_ids(r.graph)
    require_same_answers(r2.device_view().query(ids), r.device_view().query(ids), "replay")
    print(f"   shutdown (drain + final checkpoint, {dir_bytes(final) / 1e6:.1f} MB): "
          f"{shutdown_ms:.1f} ms; restore {restore2_ms:.1f} ms; 3 windows replayed "
          f"caller-clocked on the restored engine and its twin: graphs, stores and "
          f"{len(ids)} answers byte-identical; their solves alone (the caller waits in "
          f"drain): {per_sweep(replayed):.3f} ms a sweep over {len(replayed)} solves")

    # 5. the estimator on the card
    spec = StreamSpec(total_vertices=5000, batch_size=1000, seed=42, class_sep=6.0, noise=0.9)
    parts = list(gaussian_mixture_stream(spec))
    a0, s0 = argkmin_candidates.launches, ell_propagate_step.launches
    t0 = time.perf_counter()
    clf = DynLabelPropagation(k=5).fit(parts[0][0].ins_emb, parts[0][0].ins_labels)
    for b, _ in parts[1:4]:
        clf.partial_fit(b.ins_emb, b.ins_labels)
    acc = clf.score(parts[4][0].ins_emb, parts[4][1])
    est_ms = (time.perf_counter() - t0) * 1e3
    require(clf.engine_.device.type == "cuda" and clf.engine_._read_streams,
            "the estimator is not on the card")
    require(argkmin_candidates.launches > a0 and ell_propagate_step.launches > s0,
            "the estimator did not launch the kernels")
    print(f"   DynLabelPropagation(k=5): fit 1000, partial_fit 3000, score on 1000 unseen: "
          f"accuracy {acc:.4f} ({est_ms:.0f} ms)")
    require(acc >= 0.99, f"estimator accuracy {acc} < 0.99")
    shutil.rmtree(root / "service", ignore_errors=True)  # path 6 restores root / "path3"
    return dict(launches=launches, windows=windows, argkmin_err=ak_err, sweep_err=sweep_err)


def phase_timing(last, save_sweeps=None):
    """The kernel and its plain version at the main path's inputs: every
    sweep of the last batch's solve, kept from a second run of that solve
    (and written to ``save_sweeps``, an ``.npz``, when given)."""
    p = last["problem"]
    n, k = p.nbr.shape
    sweeps = []

    def keep(*args, **kw):
        sweeps.append(args)
        return ell_propagate_step(*args, **kw)

    ops_module.ell_propagate_step = keep
    try:
        res = run_propagation(p, last["f0"], last["frontier0"],
                              **dict(last["kw"], backend="ell_cuda"))
    finally:
        ops_module.ell_propagate_step = ell_propagate_step
    require(torch.equal(res.f, last["res"].f) and res.iterations == len(sweeps)
            == last["res"].iterations, "the last batch's solve did not repeat itself")
    err = check_sweep("main-path first sweep", sweeps[0], delta=DELTA)
    for args in sweeps[1:]:
        got_f, got_ch = ell_propagate_step(*args, delta=DELTA)
        want_f, want_ch = ell_propagate_ref(*args, delta=DELTA)
        require(torch.equal(got_f.view(torch.int32), want_f.view(torch.int32))
                and torch.equal(got_ch, want_ch), "a main-path sweep: kernel != plain version")
    print(f"   all {len(sweeps)} sweeps of the last batch: kernel == plain version bitwise")
    if save_sweeps:
        save_sweep_inputs(save_sweeps, sweeps)

    first = sweeps[0]
    rows = [int(a[4].sum()) for a in sweeps]
    bounds = [sweep_bound(n, k, first[5].shape[0], r) for r in rows]
    first_ms = statistics.median(
        gpu_times([lambda: ell_propagate_step(*first, delta=DELTA)] * 100, per_sleep=100))
    first_plain = statistics.median(
        gpu_times([lambda: ell_propagate_ref(*first, delta=DELTA)] * 50, per_sleep=1))
    b0, by0, nb0 = bounds[0]
    print(f"   first sweep (U,K)=({n},{k}) frontier={rows[0]} rows: "
          f"kernel {first_ms * 1e3:.1f} us  plain {first_plain * 1e3:.1f} us  "
          f"bound {b0 * 1e3:.2f} us ({nb0 / 1e6:.2f} MB at 3.35 TB/s, {by0})  "
          f"kernel/bound {first_ms / b0:.2f}x")
    k_ms = gpu_times([lambda a=a: ell_propagate_step(*a, delta=DELTA) for a in sweeps],
                     per_sleep=100)
    p_ms = gpu_times([lambda a=a: ell_propagate_ref(*a, delta=DELTA) for a in sweeps],
                     per_sleep=1)
    b_ms = [b for b, _, _ in bounds]
    q = np.percentile(rows, [0, 50, 100])
    print(f"   frontier rows per sweep: min {q[0]:.0f} median {q[1]:.0f} max {q[2]:.0f} "
          f"(mean {np.mean(rows):.1f} of {n})")
    print(f"   whole batch, {len(sweeps)} sweeps: kernel {sum(k_ms):.3f} ms  "
          f"plain {sum(p_ms):.3f} ms  bound {sum(b_ms):.4f} ms  "
          f"kernel/bound {sum(k_ms) / sum(b_ms):.2f}x  "
          f"library: no single PyTorch call")
    # an empty launch: PyTorch's one-thread spin kernel asked for 0 cycles
    empty = gpu_times([lambda: torch.cuda._sleep(0)] * 200, per_sleep=100)
    print(f"   per sweep, mean of {len(sweeps)}: kernel {np.mean(k_ms) * 1e3:.2f} us  bound "
          f"{np.mean(b_ms) * 1e3:.2f} us  an empty kernel launch timed the same way: "
          f"{statistics.median(empty) * 1e3:.2f} us (median of 200)")
    by = "bytes" if all(b[1] == "bytes" for b in bounds) else "operations"
    # the record is per launch, averaged over the batch's sweeps
    m = len(sweeps)
    return dict(ms=sum(k_ms) / m, plain_ms=sum(p_ms) / m, bound_ms=sum(b_ms) / m,
                max_abs_err=err, bound_by=by)


def save_sweep_inputs(path, sweeps):
    """The sweeps' inputs for ``tools/torch_kernel_times.py --sweeps``: the
    arrays every sweep shares once, the frontier and F of each."""
    nbr, wgt, wl0, wl1 = (t.cpu().numpy() for t in sweeps[0][:4])
    require(all(a[0] is sweeps[0][0] and a[1] is sweeps[0][1] for a in sweeps),
            "the sweeps of one solve share nbr and wgt")
    np.savez(path, nbr=nbr, wgt=wgt, wl0=wl0, wl1=wl1, delta=np.float32(DELTA),
             frontier=torch.stack([a[4] for a in sweeps]).cpu().numpy(),
             f=torch.stack([a[5] for a in sweeps]).cpu().numpy())
    print(f"   wrote the {len(sweeps)} sweeps' inputs to {path}")


def phase_argkmin_timing(inp):
    """The argkmin kernel, its plain version and the library yardstick on the
    second main path's last argkmin inputs, beside the bound; then the
    kernel alone at D = 128 on inputs of the same C and M."""
    args, base, slack, k = inp["args"], inp["base"], inp["slack"], inp["k"]
    store, _, _, batch, _ = args
    c, d = store.shape
    m = batch.shape[0]
    topk = min(k + SELECT_MARGIN, c)
    err = check_argkmin("main-path last batch", inp)
    k_ms = statistics.median(
        gpu_times([lambda: argkmin_candidates(*args, base, slack, k=k)] * 20, per_sleep=20))
    # the plain version in four store tiles: ~230 launches a call, few
    # enough to queue behind one sleep
    tile = -(-c // 4)
    p_ms = statistics.median(gpu_times(
        [lambda: argkmin_ref(*args, base, slack, topk=topk, tile_rows=tile)] * 3,
        per_sleep=1))
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32, as the kernel

    def library():  # three PyTorch calls; the port calls none of them
        s_ = torch.matmul(batch, store.T)
        torch.topk(s_, topk, dim=1)
        s_.amax(dim=0)

    l_ms = statistics.median(gpu_times([library] * 5, per_sleep=1))
    b_ms, by, flops, nbytes = argkmin_bound(inp)
    full_ms = 2 * m * c * d / F32_FLOPS * 1e3
    print(f"   argkmin (C, D, M, TK)=({c}, {d}, {m}, {topk}), {int(args[1].sum())} valid "
          f"rows: kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  library (matmul+topk+amax) "
          f"{l_ms:.3f} ms  bound {b_ms:.4f} ms ({flops / 1e9:.2f} GFLOP at 67 TFLOP/s, "
          f"{by}; {nbytes / 1e6:.1f} MB)  kernel/bound {k_ms / b_ms:.2f}x  "
          f"(all C rows: {full_ms:.4f} ms)")
    # the no-FMA floor: a multiply and an add are two instructions, so the
    # arithmetic alone takes at least twice the bound's operation time
    print(f"   no-FMA floor {2 * flops / F32_FLOPS * 1e3:.4f} ms (2 instructions a term at "
          f"{F32_FLOPS / 2 / 1e12:.1f} T instr/s); kernel/floor "
          f"{k_ms / (2 * flops / F32_FLOPS * 1e3):.2f}x")
    geo = argkmin_geometry(c, d, m, topk, resident=resident_blocks(
        d, argkmin_geometry(c, d, m, topk)["tkb"], 0))
    print(f"   geometry: {json.dumps(geo)}")
    wide = argkmin_inputs(np.random.default_rng(7), c, 128, m, base + m,
                          real=int(args[4].sum()))
    check_argkmin("main-path shape, D=128", wide)
    w_ms = statistics.median(gpu_times(
        [lambda: argkmin_candidates(*wide["args"], wide["base"], wide["slack"], k=5)] * 10,
        per_sleep=10))
    wb = argkmin_bound(wide)
    print(f"   argkmin at D=128, same C and M: kernel {w_ms:.3f} ms  bound {wb[0]:.4f} ms "
          f"({wb[2] / 1e9:.1f} GFLOP, {wb[1]})  kernel/bound {w_ms / wb[0]:.2f}x  no-FMA "
          f"floor {2 * wb[2] / F32_FLOPS * 1e3:.4f} ms")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=by,
                max_abs_err=err)


def library_times(fn, reps):
    """Device times (ms) of a library call: behind the checked sleep, or,
    when the call waits on the card itself (so nothing can be queued behind
    a sleep), CUDA events around each call after a warm-up, said so."""
    try:
        return gpu_times([fn] * reps, per_sleep=1)
    except QueueError:
        print("   the library call waits on the card; timed with bare CUDA events")
        pairs = enqueue([fn] * reps)
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in pairs]


def _wall_ms(fn, reps=3):
    """Median host-clock time (ms) of ``fn`` run to the end on the card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_cc(nbr_host):
    """The ``cc`` entry point on a snapshot's ELL adjacency: one call of
    ``connected_components_cuda`` must be one fixpoint launch and no step
    launch, and its labels must equal ``connected_components`` on the card
    and ``host_components``.  Then the step loop (``cc_hook_step``
    and a sync per step, each step equal to its plain version), counted
    on its own: the same labels and as many steps as the fixpoint ran."""
    nbr = torch.from_numpy(nbr_host).cuda()
    connected_components_cuda.launches = 0
    cc_hook_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    par, iters = connected_components_cuda(nbr)
    wall = (time.perf_counter() - t0) * 1e3
    launches, step_launches = connected_components_cuda.launches, cc_hook_step.launches
    want = connected_components(nbr).labels
    host = host_components(nbr_host)
    n_comp = int((par == torch.arange(len(par), device=par.device, dtype=par.dtype)).sum())
    print(f"   connected_components_cuda on (N, K)={tuple(nbr.shape)}: {iters} iterations, "
          f"{launches} fixpoint launch, {step_launches} step launches, {wall:.2f} ms wall "
          f"(the first call); {n_comp} components")
    require(launches == 1 and step_launches == 0,
            "connected_components_cuda: not one fixpoint launch and no step launch")
    require(torch.equal(par, want.to(par.dtype)), "connected_components_cuda != "
            "connected_components on the card")
    require(np.array_equal(par.cpu().numpy(), host), "connected_components_cuda != "
            "host_components")

    # the step loop, from which the step's timing takes every step's input
    cc_hook_step.launches = 0
    steps, loop_par = step_loop(nbr, keep=True)
    loop_launches = cc_hook_step.launches
    require(loop_launches == len(steps) == iters > 0,
            f"step loop: {loop_launches} launches, {len(steps)} steps, fixpoint {iters}")
    require(torch.equal(loop_par, par), "the step loop's labels != the fixpoint's")
    print(f"   labels == connected_components (card) == host_components == the step loop's "
          f"({loop_launches} step launches, each step == plain version)")
    return dict(nbr=nbr, par=par, launches=launches, iterations=iters, steps=steps,
                step_launches=loop_launches)


def step_loop(nbr, keep=False):
    """The step loop, the fixpoint one launch a step: ``cc_hook_step`` until no
    parent moves, one host sync per step.  With ``keep``, every step's
    inputs are kept and its result held to its plain version's."""
    steps = []

    def checked(nbr, par):
        new = cc_hook_step(nbr, par)
        steps.append((nbr, par))
        require(torch.equal(new, cc_hook_ref(nbr, par)),
                "a main-path hook step: kernel != plain version")
        return new
    par, _ = connected_components_ref(nbr, step=checked if keep else cc_hook_step)
    return steps, par


def synced_times(fn, reps):
    """Times (ms) of ``fn``, a call that waits on the card itself: CUDA
    events around each call, after a warm-up call."""
    fn()
    pairs = enqueue([fn] * reps)
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def phase_bsr_timing(out):
    """Path 3's last batch: its solve again with every sweep's SpMV inputs
    kept (each sweep's kernel result equal to its plain version's bits);
    the SpMV timed against its plain version, PyTorch's BSR product and its
    bound; the solve on ``bsr`` against ``ell_cuda`` on the unpermuted
    problem and ``ref`` on the staged problem.  Returns the
    record's numbers and the ``ell_cuda`` solve's inputs for the sweep
    kernel's timing."""
    last, host, st = out["last"], out["staged"]["host"], out["staged"]["st"]
    require(st.backend == "bsr", "path 3's last batch was not staged on bsr")
    p, kw = last["problem"], last["kw"]
    sweeps = []

    def keep(*args):
        sweeps.append(args)
        return bsr_spmv(*args)

    ops_module.bsr_spmv = keep
    try:
        res = run_propagation(p, last["f0"], last["frontier0"], **kw)
    finally:
        ops_module.bsr_spmv = bsr_spmv
    require(torch.equal(res.f, last["res"].f) and res.iterations == len(sweeps)
            == last["res"].iterations, "the last batch's bsr solve did not repeat itself")
    err = check_bsr("main-path first sweep", sweeps[0])
    for args in sweeps[1:]:
        require(torch.equal(bsr_spmv(*args).view(torch.int32),
                            bsr_spmv_ref(*args).view(torch.int32)),
                "a main-path SpMV: kernel != plain version")
    blocks, cols, x = sweeps[0]
    r, j, bs, _ = blocks.shape
    occupied = int((cols >= 0).sum())
    print(f"   all {len(sweeps)} SpMVs of the last batch: kernel == plain version bitwise; "
          f"tiles (R, J, BS)=({r}, {j}, {bs}), {occupied} occupied slots "
          f"({occupied / (r * j):.3f} of the budget), {blocks.numel() * 4 / 1e9:.3f} GB")

    k_ms = gpu_times([lambda a=a: bsr_spmv(*a) for a in sweeps], per_sleep=100)
    p_ms = gpu_times([lambda a=a: bsr_spmv_ref(*a) for a in sweeps[:5]], per_sleep=1)
    # the library yardstick: PyTorch's BSR product over the occupied tiles,
    # converted outside the timed region; the port calls it nowhere
    valid = cols >= 0
    crow = torch.zeros(r + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = valid.sum(1).cumsum(0)
    with warnings.catch_warnings():  # "BSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        lib_a = torch.sparse_bsr_tensor(crow, cols[valid].long(), blocks[valid],
                                        size=(r * bs, x.numel()), check_invariants=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y_lib = (lib_a @ x[:, None])[:, 0]
        lib_name = "torch.sparse_bsr_tensor @ x"

        def library():
            lib_a @ x[:, None]
    except (RuntimeError, NotImplementedError) as exc:
        print(f"   the BSR product is refused ({type(exc).__name__}: {str(exc)[:120]}); "
              "the yardstick is a gather plus einsum")
        idx = cols.clamp(min=0).long()
        y_lib = torch.einsum("rjab,rjb->ra", blocks, x.view(-1, bs)[idx]).reshape(-1)
        lib_name = "gather + einsum"

        def library():
            torch.einsum("rjab,rjb->ra", blocks, x.view(-1, bs)[idx])
    y = bsr_spmv(blocks, cols, x)
    lib_err = float((y_lib - y).abs().max())
    require(lib_err <= 1e-4 * max(1.0, float(y.abs().max())),
            f"the library yardstick computes another product (max|dy| {lib_err})")
    l_ms = library_times(library, 20)
    b_ms, by, nbytes = bsr_bound(blocks, cols, x)
    all_slots = (r * j * bs * bs * 4) / HBM_BYTES_PER_S * 1e3
    km, pm, lm = (statistics.median(t) for t in (k_ms, p_ms, l_ms))
    print(f"   SpMV per launch: kernel {km:.4f} ms (mean {np.mean(k_ms):.4f} over "
          f"{len(k_ms)})  plain {pm:.3f} ms  library ({lib_name}, fp32) {lm:.4f} ms "
          f"(max|dy| vs kernel {lib_err:.1e})  bound {b_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
          f"3.35 TB/s, {by}; every slot's tile: {all_slots:.4f} ms)  "
          f"kernel/bound {km / b_ms:.2f}x  kernel/library {km / lm:.2f}x")

    # the whole solve: bsr on the staged problem, ell_cuda on the unpermuted
    # one (the same rows before the component order), ref on the staged one
    up = problem_from_arrays(host.nbr, host.wgt, host.wl0, host.wl1, host.valid,
                             device="cuda")
    perm = torch.from_numpy(st.perm).cuda()
    f0u = torch.empty_like(last["f0"])
    f0u[perm] = last["f0"]
    fru = torch.empty_like(last["frontier0"])
    fru[perm] = last["frontier0"]
    ekw = {k: v for k, v in kw.items() if k in ("delta", "max_iters", "device")}
    ell = run_propagation(up, f0u, fru, backend="ell_cuda", **ekw)
    ref = run_propagation(p, last["f0"], last["frontier0"], backend="ref", **ekw)
    rows = torch.from_numpy(st.rows).cuda()
    d_ell = float((res.f[rows] - ell.f[: len(rows)]).abs().max())
    gap = (res.f - ref.f)[p.valid].abs()
    d_ref = float(gap.max())
    bsr_ms = _wall_ms(lambda: run_propagation(p, last["f0"], last["frontier0"], **kw))
    ell_ms = _wall_ms(lambda: run_propagation(up, f0u, fru, backend="ell_cuda", **ekw))
    print(f"   whole solve of the last batch: bsr {bsr_ms:.1f} ms ({res.iterations} sweeps, "
          f"{bsr_ms / max(res.iterations, 1):.3f} ms a sweep)  ell_cuda {ell_ms:.1f} ms "
          f"({ell.iterations} sweeps, {ell_ms / max(ell.iterations, 1):.3f} ms a sweep)  "
          f"bsr/ell {bsr_ms / ell_ms:.2f}x")
    # Each backend stops a row once it and its neighbors move by <= delta;
    # the two sum in different orders, so the rows that straddle delta
    # differ, and so do the sweeps each row gets: the stopped labels
    # differ by tens of delta on this graph, whichever is nearer the
    # fixpoint.  The delta-stopped gap is printed; what is held is that
    # the two compute the same iteration (a fixed number of sweeps with
    # every row kept on, within a few ULPs) and the same hard predictions
    # away from the cutoff.
    far = (ref.f - 0.5).abs() > TOL
    same_pred = torch.equal((res.f >= 0.5)[p.valid & far], (ref.f >= 0.5)[p.valid & far])
    print(f"   delta-stopped: max|F bsr - F ell_cuda|={d_ell:.3e}  max|F bsr - F ref| "
          f"(staged)={d_ref:.3e} = {d_ref / DELTA:.2f} delta, {int((gap > TOL).sum())} of "
          f"{int(p.valid.sum())} rows beyond 20 delta; ref {ref.iterations} sweeps; "
          f"predictions equal where |F - 0.5| > 20 delta: {same_pred}")
    fixed = dict(ekw, delta=0.0, max_iters=res.iterations)
    every = p.valid.clone()
    fb = run_propagation(p, last["f0"], every, **dict(kw, **fixed))
    fr = run_propagation(p, last["f0"], every, backend="ref", **fixed)
    d_fix = float((fb.f - fr.f)[p.valid].abs().max())
    print(f"   {fb.iterations} sweeps with every row on (delta=0): max|F bsr - F ref|="
          f"{d_fix:.2e} (bound 1e-05)")
    require(res.converged and ell.converged and ref.converged, "a re-solve did not converge")
    require(fb.iterations == fr.iterations == res.iterations, "the fixed sweeps stopped early")
    require(d_fix <= 1e-5, "bsr and ref compute different iterations")
    require(same_pred, "bsr vs ref predictions differ away from the cutoff")
    rec = dict(ms=float(np.mean(k_ms)), plain_ms=float(np.mean(p_ms)), library_ms=lm,
               bound_ms=b_ms, bound_by=by, max_abs_err=err)
    return rec, dict(problem=up, f0=f0u, frontier0=fru, res=ell, kw=ekw)


def phase_cc_timing(cc):
    """The hook step on every step of the ``cc`` entry point's run, each
    per launch beside its bound and an empty launch; the whole fixpoint on
    the card alone (behind a sleep) and as a call (CUDA events around it,
    its read of the step count included) beside the step loop, the
    plain version's loop, ``connected_components`` and the bound."""
    nbr, steps = cc["nbr"], cc["steps"]
    k_ms = gpu_times([lambda a=a: cc_hook_step(*a) for a in steps] * 10, per_sleep=100)
    p_ms = gpu_times([lambda a=a: cc_hook_ref(*a) for a in steps], per_sleep=1)
    empty = gpu_times([lambda: torch.cuda._sleep(0)] * 200, per_sleep=100)
    n, k = nbr.shape
    b_ms, by, nbytes = cc_bound(n, k)
    km, pm = float(np.mean(k_ms)), float(np.mean(p_ms))
    print(f"   cc_hook_step (N, K)=({n}, {k}), {len(steps)} steps, each == plain version: "
          f"kernel {km * 1e3:.2f} us  plain {pm * 1e3:.1f} us  bound {b_ms * 1e3:.2f} us "
          f"({nbytes / 1e6:.2f} MB at 3.35 TB/s, {by})  kernel/bound {km / b_ms:.2f}x  "
          f"an empty kernel launch timed the same way {statistics.median(empty) * 1e3:.2f} us  "
          f"library: no single PyTorch call")


    # the whole fixpoint: on the card alone, and as a call
    f_ms = gpu_times([lambda: cc_fixpoint(nbr)] * 20, per_sleep=20)
    call_ms = synced_times(lambda: connected_components_cuda(nbr), 20)
    loop_ms = synced_times(lambda: step_loop(nbr), 20)
    ref_ms = synced_times(lambda: connected_components_ref(nbr), 5)
    comp_ms = synced_times(lambda: connected_components(nbr), 20)
    fb_ms, fby, fbytes = cc_fixpoint_bound(n, k)
    fm, cm, lm, rm, om = (statistics.median(t) for t in (f_ms, call_ms, loop_ms, ref_ms,
                                                          comp_ms))
    blocks, kept, resident = fixpoint_plan(n, k)
    print(f"   cc fixpoint (N, K)=({n}, {k}), {cc['iterations']} steps, {blocks} blocks "
          f"of 256 threads ({resident} resident; {-(-n // 32)} row groups, "
          f"{kept} kept in shared memory a warp): on the card "
          f"{fm * 1e3:.2f} us ({fm / cc['iterations'] * 1e3:.2f} us a step)  the call "
          f"(CUDA events, its read of the step count included) {cm * 1e3:.2f} us  the step "
          f"loop (cc_hook_step + a sync a step) {lm * 1e3:.2f} us  plain version's "
          f"loop {rm * 1e3:.1f} us  connected_components {om * 1e3:.1f} us  bound "
          f"{fb_ms * 1e3:.2f} us ({fbytes / 1e6:.2f} MB at 3.35 TB/s, {fby})  "
          f"kernel/bound {fm / fb_ms:.2f}x  call/step loop {cm / lm:.3f}x")
    step = dict(ms=km, plain_ms=pm, bound_ms=b_ms, bound_by=by, max_abs_err=0.0)
    fix = dict(ms=fm, plain_ms=rm, bound_ms=fb_ms, bound_by=fby, max_abs_err=0.0,
               call_ms=cm, step_loop_ms=lm, components_ms=om,
               iterations=cc["iterations"], blocks=blocks, kept_groups=kept)
    return step, fix
# --------------------------------------------------------------------- #
# the baselines and the landmark backend (phase 2's cases, paths 5 and 6)
# --------------------------------------------------------------------- #
def landmark_argkmin_inputs(rng, c, valid, m, d=16):
    """The landmark assignment's argkmin call (``LandmarkState.refresh``): a
    block of ``c`` landmark rows of which the first ``valid`` are sampled
    (a partial sample pads with invalid rows), a chunk of ``ASSIGN_CHUNK``
    query rows with the first ``m`` real, ``base_id = c`` (no self-match),
    kth all ``-inf``, slack 0, k = 4 (TK = min(12, c))."""
    lm = normalize_rows(rng.normal(size=(c, d)).astype(np.float32))
    block = np.zeros((ASSIGN_CHUNK, d), np.float32)
    block[:m] = normalize_rows(rng.normal(size=(m, d)).astype(np.float32))
    args = [torch.from_numpy(lm).cuda(), (torch.arange(c) < valid).cuda(),
            torch.full((c,), -np.inf, device="cuda"), torch.from_numpy(block).cuda(),
            (torch.arange(ASSIGN_CHUNK) < m).cuda()]
    return dict(args=args, base=c, slack=0.0, k=4)


def check_slice_kernels(rng):
    """Phase 2's cases for the baselines and the landmark backend: argkmin
    at the landmark geometry, ``propagate_full_ell`` against
    ``propagate_full`` (F and iterations), ``harmonic_solve`` card vs CPU."""
    ak = [check_argkmin(f"landmark C={c} sampled={v} m={m}",
                        landmark_argkmin_inputs(rng, c, v, m))
          for c, v in ((64, 64), (64, 37), (37, 37)) for m in (ASSIGN_CHUNK, 300)]

    n, real = 20_000, 19_000  # the last 1,000 rows pad the bucket
    nbr, wgt, wl0, wl1, _, _ = sweep_inputs(rng, n, 24, pad_rows=0.05)
    valid = torch.arange(n, device="cuda") < real
    nbr[~valid] = -1
    for t in (wgt, wl0, wl1):
        t[~valid] = 0
    p = PropagationProblem(nbr=nbr, wgt=wgt, wl0=wl0, wl1=wl1, valid=valid)
    f0 = torch.full((n,), 0.5, device="cuda")
    before = ell_propagate_step.launches
    got = propagate_full_ell(p, f0, delta=DELTA)
    launches = ell_propagate_step.launches - before
    want = propagate_full(p, f0, delta=DELTA)
    same = torch.equal(got.f.view(torch.int32), want.f.view(torch.int32))
    print(f"   propagate_full_ell N={n} ({n - real} padding rows) K=24: {got.iterations} "
          f"iterations, {launches} sweep launches; propagate_full {want.iterations} "
          f"iterations; F bitwise={same}")
    require(same and got.iterations == want.iterations == launches > 1 and got.converged,
            "propagate_full_ell != propagate_full on the card")
    require(torch.equal(got.f[real:], f0[real:]), "propagate_full_ell moved padding rows")

    spec = StreamSpec(total_vertices=3000, batch_size=1000, seed=5, class_sep=6.0, noise=0.9)
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    for b, _ in gaussian_mixture_stream(spec):
        g.apply_batch(b)
    pc = build_problem(g, auto_bucket=True, device="cpu")
    pg = pc.problem.to("cuda")
    before = ell_propagate_step.launches
    got = propagate_full_ell(pg, f0[:pg.num_unlabeled], delta=DELTA)
    launches = ell_propagate_step.launches - before
    want = propagate_full(pg, f0[:pg.num_unlabeled], delta=DELTA)
    same = torch.equal(got.f.view(torch.int32), want.f.view(torch.int32))
    print(f"   propagate_full_ell on a kNN snapshot (U, K)={tuple(pg.nbr.shape)} "
          f"({int((~pg.valid).sum())} padding rows): {got.iterations} iterations, "
          f"{launches} sweep launches; propagate_full {want.iterations}; F bitwise={same}")
    require(same and got.iterations == want.iterations == launches > 1 and got.converged,
            "propagate_full_ell != propagate_full on a kNN snapshot")
    fc = harmonic_solve(pc.problem)
    fg = harmonic_solve(pg).cpu()
    d = float((fg - fc).abs().max())
    print(f"   harmonic_solve U={pc.problem.num_unlabeled}: max|F card - F cpu|={d:.2e} "
          "(bound 1e-4)")
    require(d <= 1e-4, "harmonic_solve: card vs CPU beyond 1e-4")
    return max(ak)


def timed_sync(fn, sink, key):
    """``fn`` wrapped to add its synchronized host time (ms) to ``sink[key]``."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink[key] = sink.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return run


def phase_baselines(vertices, batch_size, prefix):
    """Path 5: ``ITLP.step`` and exact ``STLP.step`` on the card, each on its
    own graph, over path 1's stream.  After every batch both graphs equal
    path 1's; the sweep kernel runs ITLP's iterations; ITLP takes more
    iterations than DynLP over the stream (Fig. 7, held on the total as the
    reference's ``test_dynlp_fewer_iterations_than_itlp`` holds it: on this
    stream DynLP's frontier loop takes more sweeps than ITLP in batch 2,
    in both packages) and STLP's predictions agree with DynLP's at ≥ 0.97
    in every batch (Fig. 8)."""
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=42,
                      class_sep=6.0, noise=0.9)
    gi, gs = DynamicGraph(emb_dim=spec.emb_dim, k=5), DynamicGraph(emb_dim=spec.emb_dim, k=5)
    itlp, exact = ITLP(gi, delta=DELTA), STLP(gs)
    solve = {}
    itlp_module.propagate_full_ell = timed_sync(propagate_full_ell, solve, "itlp")
    stlp_module.harmonic_solve = timed_sync(harmonic_solve, solve, "stlp")
    reset_launches()
    iters, dyn_iters = [], []
    try:
        for t, (batch, _) in enumerate(gaussian_mixture_stream(spec)):
            solve.clear()
            si, ss = itlp.step(batch), exact.step(batch)
            dyn, view = prefix["batches"][t], prefix["views"][t]
            require(graph_digest(gi) == dyn["digest"] == graph_digest(gs),
                    f"batch {t}: the ITLP/STLP graphs differ from path 1's")
            ids = np.flatnonzero(view.alive & (view.labels == UNLABELED))
            agree = accuracy((gs.f[ids] >= 0.5).astype(np.int8),
                             (view.f[ids] >= 0.5).astype(np.int8))
            print(f"   batch {t}: DynLP {dyn['wall_ms']:8.1f} ms (solve {dyn['solve_ms']:6.1f} ms, "
                  f"{dyn['iterations']:4d} it)  ITLP {si.wall_ms:8.1f} ms (solve "
                  f"{solve['itlp']:7.1f} ms, {si.iterations:5d} it)  STLP {ss.wall_ms:8.1f} ms "
                  f"(solve {solve['stlp']:7.1f} ms, U={ss.num_unlabeled}, dense "
                  f"{ss.dense_bytes / 1e9:.3f} GB)  ITLP/DynLP: wall "
                  f"{si.wall_ms / dyn['wall_ms']:.3f}x, solve "
                  f"{solve['itlp'] / dyn['solve_ms']:.2f}x, iterations "
                  f"{si.iterations / dyn['iterations']:.2f}x  DynLP-STLP agreement "
                  f"{agree:.4f}", flush=True)
            require(si.converged, f"ITLP batch {t} did not converge")
            require(agree >= 0.97, f"batch {t}: DynLP-STLP agreement {agree} < 0.97")
            iters.append(si.iterations)
            dyn_iters.append(dyn["iterations"])
    finally:
        itlp_module.propagate_full_ell = propagate_full_ell
        stlp_module.harmonic_solve = harmonic_solve
    launches = read_launches()
    fewer = [t for t, (i, d) in enumerate(zip(iters, dyn_iters)) if i <= d]
    print(f"   launches {launches}: sweep = ITLP iterations {sum(iters)}; graphs == path 1's "
          f"after every batch; iterations over the stream ITLP {sum(iters)} vs DynLP "
          f"{sum(dyn_iters)} ({sum(iters) / sum(dyn_iters):.2f}x); batches where ITLP took "
          f"no more: {fewer}")
    require(launches["ell"] == sum(iters), "sweep launches != ITLP's iterations")
    require(sum(iters) > sum(dyn_iters), "ITLP took no more iterations than DynLP")
    require(all(n == 0 for key, n in launches.items() if key != "ell"),
            "a baseline launched a kernel other than the sweep")
    return dict(launches=launches)


def phase_itlp_full(ell_last, graph3):
    """Path 5 at full size, on path 3's last snapshot (unpermuted, the
    problem phase 8 times the sweep on): ITLP's solve from 0.5 against that
    batch's DynLP solve, held bitwise to the plain ``propagate_full``; exact
    STLP on the same graph must refuse the dense solve."""
    p, f0, fr, kw = ell_last["problem"], ell_last["f0"], ell_last["frontier0"], ell_last["kw"]
    half = torch.full_like(f0, 0.5)
    reset_launches()
    res = propagate_full_ell(p, half, delta=DELTA)
    launches = read_launches()
    plain = propagate_full(p, half, delta=DELTA)
    same = torch.equal(res.f.view(torch.int32), plain.f.view(torch.int32))
    require(res.converged and launches["ell"] == res.iterations == plain.iterations and same,
            "full-size ITLP: kernel loop != propagate_full, or launches != iterations")
    require(all(n == 0 for key, n in launches.items() if key != "ell"),
            "full-size ITLP launched a kernel other than the sweep")
    itlp_ms = _wall_ms(lambda: propagate_full_ell(p, half, delta=DELTA))
    dyn_ms = _wall_ms(lambda: run_propagation(p, f0, fr, backend="ell_cuda", **kw))
    dyn_it = ell_last["res"].iterations
    print(f"   (U, K)={tuple(p.nbr.shape)}, {int(p.valid.sum())} rows: ITLP from 0.5 "
          f"{res.iterations} iterations (== propagate_full, F bitwise), {itlp_ms:.1f} ms; "
          f"DynLP's solve of the batch {dyn_it} iterations, {dyn_ms:.1f} ms; ITLP/DynLP "
          f"solve {itlp_ms / dyn_ms:.2f}x, iterations {res.iterations / dyn_it:.2f}x")
    g = DynamicGraph(emb_dim=graph3.emb_dim, k=graph3.k, knn_block=graph3.knn_block)
    g.load_state_arrays(graph3.state_arrays())
    nothing = BatchUpdate(ins_emb=np.zeros((0, g.emb_dim), np.float32),
                          ins_labels=np.zeros(0, np.int8), del_ids=np.zeros(0, np.int64))
    cap = STLP(g).max_unlabeled
    if int(p.valid.sum()) <= cap:  # a --stream-vertices run below STLP's wall
        print(f"   STLP's refusal not checked: {int(p.valid.sum())} rows <= its cap {cap}")
    else:
        try:
            STLP(g).step(nothing)
        except MemoryError as e:
            print(f"   STLP on the same graph: MemoryError ({e})")
        else:
            raise AssertionError("STLP at full size did not refuse the dense solve")
    return dict(iterations=res.iterations, launches=launches, ms=itlp_ms, dyn_ms=dyn_ms,
                dyn_iterations=dyn_it)


def split_batch(batch, parts):
    """``batch`` as ``parts`` sub-batches: its insertions in order, its
    deletions spread evenly."""
    ins = np.array_split(np.arange(len(batch.ins_emb)), parts)
    dels = np.array_split(batch.del_ids, parts)
    return [BatchUpdate(ins_emb=batch.ins_emb[i], ins_labels=batch.ins_labels[i], del_ids=d)
            for i, d in zip(ins, dels)]


def drive_subbatches(eng, subs, views=None):
    """Submit ``subs`` pipelined (batch t+1 before batch t is drained) and
    return their stats, submit times and solve times, with the launches.
    ``views`` collects the committed view of every commit, in order."""
    solves, submit_ms, stats = [], [], []

    def solve_timed(problem, f0, frontier0, **kw):  # on the engine's solve thread
        t0 = time.perf_counter()
        res = run_propagation(problem, f0, frontier0, **kw)
        # the solve's stream: the engine's side stream, passed in or (on a
        # mesh) entered as this thread's current stream
        (kw.get("stream") or torch.cuda.current_stream()).synchronize()
        solves.append((time.perf_counter() - t0) * 1e3)
        return res

    ops_module.run_propagation = solve_timed
    reset_launches()
    try:
        for sb in subs:
            t0 = time.perf_counter()
            prev = eng.submit(sb)
            submit_ms.append((time.perf_counter() - t0) * 1e3)
            if prev is not None:
                stats.append(prev)
                if views is not None:
                    views.append(eng.committed_view())
        stats.append(eng.drain())
        if views is not None:
            views.append(eng.committed_view())
    finally:
        ops_module.run_propagation = run_propagation
    launches = read_launches()
    require(len(stats) == len(subs) == len(solves), "a sub-batch did not solve")
    require(all(st.converged for st in stats), "a sub-batch did not converge")
    return stats, submit_ms, solves, launches


def phase_landmark(vertices, batch_size, parts=10):
    """Path 6: path 3's checkpoint restored as a ``landmark`` engine and as the
    exact default engine; the stream's next batch as ``parts`` sub-batches
    through both, pipelined.  Held: the latch engages, hot-set agreement
    with the exact engine ≥ 0.98, the largest hot rung ≤ half the exact
    rung, launches equal to chunks, insertions and sweeps, every argkmin
    launch of the assignment bitwise to its plain version, and a checkpoint
    of the landmark engine restored byte-identical."""
    root = REPO / "build" / "path4"
    cfg = LandmarkConfig(num_landmarks=64, assign_k=4, hot_ttl=1)
    batch, _ = serve_batches(vertices, batch_size)[0]
    subs = split_batch(batch, parts)
    inserting = sum(len(sb.ins_emb) > 0 for sb in subs)
    lm = StreamEngine.restore(str(root / "path3"), backend="landmark", landmark=cfg)
    ex = StreamEngine.restore(str(root / "path3"), backend=None)
    require(lm._lm is not None and not lm._lm.ready and lm.ingestor.store.emb.is_cuda,
            "the landmark engine's state")

    state = lm._lm
    kept = []  # every assignment launch's inputs
    refreshes = []  # (ms, chunks, rows) of every refresh
    real_refresh = state.refresh

    def refresh(g, store=None):  # synchronized host time of each refresh
        c0 = state.assign_chunks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_refresh(g, store)
        torch.cuda.synchronize()
        refreshes.append(((time.perf_counter() - t0) * 1e3, state.assign_chunks - c0,
                          g.num_nodes))

    def argkmin_kept(*a, **kw):
        out = argkmin_candidates(*a, **kw)
        kept.append(dict(args=[t.clone() for t in a[:5]], base=kw["base_id"],
                         slack=kw["slack"], k=kw["k"]))
        return out

    cold_ms = []  # the cold pass of every commit, its copy back included
    real_cold = state.cold_values

    def cold_values(lm_f):
        t0 = time.perf_counter()
        out = real_cold(lm_f)
        cold_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    state.refresh, state.cold_values = refresh, cold_values
    landmark_module.argkmin_candidates = argkmin_kept
    lviews, eviews = [], []  # every commit's view, for path 7
    try:
        lst, lsub, lsolve, llaunch = drive_subbatches(lm, subs, lviews)
    finally:
        landmark_module.argkmin_candidates = argkmin_candidates
        del state.refresh, state.cold_values
    est, esub, esolve, elaunch = drive_subbatches(ex, subs, eviews)

    summary = lm.transport_summary()["landmark"]
    chunks = state.assign_chunks
    act_ms, act_chunks, act_rows = refreshes[0]
    lsweeps, esweeps = sum(s.iterations for s in lst), sum(s.iterations for s in est)
    for i, (a, b) in enumerate(zip(lst, est)):
        print(f"   sub-batch {i}: landmark submit {lsub[i]:7.1f} ms, solve {lsolve[i]:6.1f} ms, "
              f"{a.iterations:4d} it, rung {a.bucket}, cold pass {cold_ms[i]:.2f} ms | exact "
              f"submit {esub[i]:7.1f} ms, solve {esolve[i]:6.1f} ms, {b.iterations:4d} it, "
              f"rung {b.bucket}", flush=True)
    hot_rung = max(s.bucket[0] for s in lst)
    exact_rung = max(s.bucket[0] for s in est)
    g, ge = lm.graph, ex.graph
    require_same_graph(lm, ex, "landmark vs exact engine", tuple(k for k in STATE_KEYS
                                                                if k != "f"))
    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    age = lm.batches - lm._touched_at[ids]
    hot = (lm._touched_at[ids] >= 0) & (age <= cfg.hot_ttl)
    agree_hot = float(((g.f[ids] >= 0.5) == (ge.f[ids] >= 0.5))[hot].mean())
    agree_all = float(((g.f[ids] >= 0.5) == (ge.f[ids] >= 0.5)).mean())
    print(f"   activation refresh {act_ms:.2f} ms ({act_chunks} argkmin chunks of "
          f"{ASSIGN_CHUNK} rows over {act_rows} rows); later refreshes "
          f"{[round(r_[0], 2) for r_ in refreshes[1:]]} ms; cold pass median "
          f"{np.median(cold_ms):.2f} ms; cold rows served {summary['cold_rows']} over "
          f"{summary['batches']} batches")
    print(f"   hot rung rows {hot_rung} (largest) vs exact rung rows {exact_rung}: "
          f"{hot_rung / exact_rung:.3f}; sweeps landmark {lsweeps} / exact {esweeps}; "
          f"hot set {int(hot.sum())} of {len(ids)} unlabeled rows; agreement with the "
          f"exact engine: hot {agree_hot:.4f}, all {agree_all:.4f}")
    print(f"   launches: landmark engine argkmin {llaunch['argkmin']} (= {chunks} chunks + "
          f"{inserting} sub-batches with insertions), sweep {llaunch['ell']}; exact engine "
          f"argkmin {elaunch['argkmin']}, sweep {elaunch['ell']}")
    require(lm._lm_streaming and summary["streaming"], "the landmark latch did not engage")
    require(all(s.backend == "landmark" for s in lst), "a sub-batch was not on landmark")
    require(all(s.backend == "ell_cuda" for s in est), "an exact sub-batch was not on ell_cuda")
    require(act_chunks == -(-act_rows // ASSIGN_CHUNK),
            "the activation refresh did not assign every row")
    require(agree_hot >= 0.98, f"hot-set agreement {agree_hot} < 0.98")
    require(hot_rung <= 0.5 * exact_rung, f"hot rung {hot_rung} > half the exact {exact_rung}")
    require(llaunch["argkmin"] == chunks + inserting == len(kept) + inserting,
            "landmark argkmin launches != assignment chunks + sub-batches with insertions")
    require(llaunch["ell"] == lsweeps and elaunch["ell"] == esweeps,
            "sweep launches != sweeps")
    require(elaunch["argkmin"] == inserting, "exact argkmin launches != insertions")
    require(all(c[key] == 0 for c in (llaunch, elaunch)
                for key in ("bsr", "cc_step", "cc_fixpoint")),
            "path 6 launched the SpMV or a cc kernel")
    ak_err = max(check_argkmin(f"path-6 assignment chunk {i}", inp,
                               show=i in (0, len(kept) - 1))
                 for i, inp in enumerate(kept))
    print(f"   all {len(kept)} assignment launches (C={kept[0]['args'][0].shape[0]}, "
          f"M={ASSIGN_CHUNK}, TK={min(4 + SELECT_MARGIN, kept[0]['args'][0].shape[0])}): "
          "kernel == plain version bitwise")

    t0 = time.perf_counter()
    lm.checkpoint(str(root / "path6"))
    r = StreamEngine.restore(str(root / "path6"))
    ck_ms = (time.perf_counter() - t0) * 1e3
    require_same_state(r, lm, "landmark checkpoint")
    require(r._lm_streaming and r.landmark_batches == lm.landmark_batches
            and r.landmark_cold_rows == lm.landmark_cold_rows
            and np.array_equal(r._touched_at, lm._touched_at), "landmark counters/clock")
    require(np.array_equal(r._lm.lm_ids, state.lm_ids)
            and all(torch.equal(getattr(r._lm, k), getattr(state, k))
                    for k in ("lm_emb", "lm_valid", "assign_idx", "assign_w")),
            "landmark factorization after restore")
    pid = probe_ids(r.graph)
    require_same_answers(r.device_view().query(pid), lm.device_view().query(pid),
                         "landmark restore")
    print(f"   checkpoint + restore of the landmark engine {ck_ms:.1f} ms: graph, store, "
          f"factorization, clock and {len(pid)} answers byte-identical")
    for e in (lm, ex, r):
        e.close()
    return dict(launches=llaunch, exact_launches=elaunch, argkmin_err=ak_err,
                chunks=chunks, agree_hot=agree_hot, subs=subs, inserting=inserting, cfg=cfg,
                landmark=lm, exact=ex, landmark_views=lviews, exact_views=eviews,
                exact_stats=est, exact_solve_ms=esolve)


# --------------------------------------------------------------------- #
# the mesh (phase 2's row0 cases, paths 7 and 7b)
# --------------------------------------------------------------------- #
SHARDS = 8  # path 7's mesh: DeviceMesh.local(8), eight shards on the card


def same_bits(got, want):
    """Values (as bits), ids and masks of two argkmin results equal."""
    return all(torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)
               for g, w in zip(got, want))


def check_row0(name, args, base, slack, row0, topk=13):
    """argkmin on one store block at global offset ``row0`` against its
    plain version, bitwise; returns the max |Δval| (0 when bitwise)."""
    got = argkmin_launch(*args, base, slack, topk=topk, row0=row0)
    want = argkmin_ref(*args, base, slack, topk=topk, row0=row0)
    torch.cuda.synchronize()
    fin = torch.isfinite(got[0])
    ids = got[1][fin]
    same = same_bits(got, want)
    print(f"   argkmin row0 {name:<44} C={args[0].shape[0]:<6} row0={row0:<7} "
          f"base_id={base:<7} bitwise={same} ids in [row0, row0+C): "
          f"{bool(((ids >= row0) & (ids < row0 + args[0].shape[0])).all())} "
          f"disp={int(got[2].sum())}")
    require(same, f"argkmin row0 {name}: kernel != plain version")
    return 0.0


def check_shard_sweep(name, args, base, slack, topk=13, shards=SHARDS):
    """The sharded sweep (one launch a shard at its row0, lists merged)
    against one unsharded launch on the same store: values, ids and mask
    equal; every shard's launch against its plain version too."""
    store, valid, kth, batch, bvalid = args
    cut = [tuple(t.view(shards, -1, *t.shape[1:]).unbind(0)) for t in (store, valid, kth)]
    before = argkmin_candidates.launches
    got = shard_sweep(*cut, (batch,) * shards, (bvalid,) * shards, base, slack, topk=topk)
    launches = argkmin_candidates.launches - before
    whole = argkmin_launch(*args, base, slack, topk=topk)
    torch.cuda.synchronize()
    same = same_bits(got, whole)
    c_loc = store.shape[0] // shards
    for sh in range(shards):
        part = [cut[0][sh], cut[1][sh], cut[2][sh], batch, bvalid]
        one = argkmin_launch(*part, base, slack, topk=min(topk, c_loc), row0=sh * c_loc)
        ref = argkmin_ref(*part, base, slack, topk=min(topk, c_loc), row0=sh * c_loc)
        require(same_bits(one, ref), f"shard sweep {name}: shard {sh} != its plain version")
    print(f"   shard_sweep {name:<40} {shards} shards of {c_loc} rows: {launches} launches; "
          f"merged == one unsharded launch (values, ids, mask): {same}; every shard == its "
          "plain version")
    require(same and launches == shards, f"shard sweep {name}: merged != unsharded launch")
    return 0.0


def check_row0_cases(rng):
    """Phase 2's argkmin cases at a global row offset: the main path's last
    call (C = 131,072, D = 16, M = 8,192, base_id = 95,000) cut 8 ways, a
    shard at a boundary whose block holds base_id, lies below it or above
    it (holding the batch's tail); then duplicates of a batch row tied
    across the boundary of shards 1 and 2.  Each launch gives its plain
    version's bits; the sharded sweep gives one unsharded launch's."""
    c, d, m = 131072, 16, 8192
    inp = argkmin_inputs(rng, c, d, m, 103192, real=5000)
    args, base, slack = inp["args"], inp["base"], inp["slack"]
    c_loc = c // SHARDS
    errs = []
    for sh, what in ((5, "base_id inside the block"), (2, "the block below base_id"),
                     (6, "the block above base_id, the batch's tail in it")):
        lo = sh * c_loc
        blk = [t[lo:lo + c_loc] for t in args[:3]] + args[3:]
        errs.append(check_row0(f"shard {sh}: {what}", blk, base, slack, lo))
    errs.append(check_shard_sweep("the main path's last call", args, base, slack))
    tied = [t.clone() for t in args]
    lo, hi = c_loc - 700, c_loc + 700  # rows either side of shards 1 and 2's boundary
    tied[0][lo:hi] = tied[3][0]
    tied[1][lo:hi] = True
    tied[3][1:50] = tied[3][0]  # 50 batch rows tie with all of them
    for sh in (1, 2):
        blk = [t[sh * c_loc:(sh + 1) * c_loc] for t in tied[:3]] + tied[3:]
        errs.append(check_row0(f"shard {sh}: duplicates tied across two shards", blk, base,
                               slack, sh * c_loc))
    errs.append(check_shard_sweep("duplicates tied across shards 1 and 2", tied, base, slack))
    return max(errs)


def views_equal(a, b):
    return all(getattr(a, k).tobytes() == getattr(b, k).tobytes()
               for k in ("f", "labels", "alive"))


def unl_gap(a, b):
    """max |F_a − F_b| over the alive unlabeled rows of view ``a``."""
    ids = np.flatnonzero(a.alive & (a.labels == UNLABELED))
    return float(np.abs(a.f[ids] - b.f[ids]).max(initial=0.0))


def time_shard_launches(kept):
    """Device time (ms) of each shard's argkmin launch on the kept inputs of
    the last sharded sweep, each held to its plain version first, and of
    one launch over the whole store (the single-device call), whose lists
    and mask the merged shards' must equal."""
    (stores, valids, kths, batches, bvalids, base, slack), kw = kept
    c_loc = stores[0].shape[0]
    tk = min(kw["topk"], c_loc)
    out = []
    for sh in range(len(stores)):
        part = (stores[sh], valids[sh], kths[sh], batches[sh], bvalids[sh])
        want = argkmin_ref(*part, base, slack, topk=tk, row0=sh * c_loc)
        got = argkmin_launch(*part, base, slack, topk=tk, row0=sh * c_loc)
        require(same_bits(got, want), f"path 7 shard {sh}'s argkmin != its plain version")
        out.append(statistics.median(gpu_times(
            [lambda p=part, r=sh * c_loc: argkmin_launch(*p, base, slack, topk=tk, row0=r)] * 5,
            per_sleep=5)))
    whole = [torch.cat(x) for x in (stores, valids, kths)] + [batches[0], bvalids[0]]
    merged = shard_sweep(stores, valids, kths, batches, bvalids, base, slack, topk=kw["topk"])
    require(same_bits(merged, argkmin_launch(*whole, base, slack, topk=kw["topk"])),
            "path 7: the merged shard lists != one launch over the whole store")
    whole_ms = statistics.median(gpu_times(
        [lambda: argkmin_launch(*whole, base, slack, topk=kw["topk"])] * 5, per_sleep=5))
    return out, whole_ms


def phase_mesh(out6, full):
    """Path 7: path 3's checkpoint restored onto ``DeviceMesh.local(8)``
    (eight shards on the card; an elastic 1 → 8 restore with the sharded
    store) five times, each fed path 6's 10 sub-batches, pipelined:
    ``ell_cuda`` on all-gather and on halo, ``bsr`` on both, and the
    landmark backend with path 6's configuration.  Held after every
    sub-batch: the ell engines' committed views equal path 6's exact
    engine's bit for bit, the bsr engines' equal each other, the landmark
    engine's equal path 6's landmark engine's; the graphs equal path 6's
    byte for byte; launches read: the sweep or the SpMV 8 times a sweep,
    argkmin 8 times an inserting sub-batch (plus the landmark chunks).
    The bsr engines' δ-stopped labels lie within 2e-3 of the ell
    engine's at the full ``STREAM_VERTICES`` (a reduced
    ``--stream-vertices`` run prints the gap and does not hold it: two
    δ-stopped solves of a smaller, less settled graph can lie further
    apart), with the same hard predictions where the ell engine's label is
    more than 20·δ from the cutoff, and the mesh's bsr and ell bodies
    compute the same iteration (30 sweeps with every row on, within 1e-5).
    The first 8 and every ``BSR_KEEP_EVERY``-th per-shard SpMV launch of
    the two bsr engines keep their inputs; each is held bitwise to
    ``bsr_spmv_ref`` after the run.  Then engine (a)'s checkpoint restored
    onto no mesh (8 → 1): byte-identical, the same answers."""
    root = REPO / "build" / "path4"
    mesh = DeviceMesh.local(SHARDS)
    subs, inserting, cfg = out6["subs"], out6["inserting"], out6["cfg"]
    kept, kept_spmv, spmv_seen = [], [], [0]
    real_sweep = argkmin_module.shard_sweep

    def sweep_kept(*a, **kw):  # the inputs of the last sharded sweep, copied
        kept[:] = [(tuple(tuple(t.clone() for t in x) if isinstance(x, tuple) else x
                          for x in a), kw)]
        return real_sweep(*a, **kw)

    def spmv_kept(*a):  # a per-shard SpMV of a mesh bsr engine, its inputs copied
        if spmv_seen[0] < SHARDS or spmv_seen[0] % BSR_KEEP_EVERY == 0:
            kept_spmv.append(tuple(t.clone() for t in a))
        spmv_seen[0] += 1
        return bsr_spmv(*a)

    runs = (("allgather", dict(backend=None, transport="allgather")),
            ("halo", dict(backend=None, transport="halo")),
            ("bsr_allgather", dict(backend="bsr", transport="allgather")),
            ("bsr_halo", dict(backend="bsr", transport="halo")),
            ("landmark", dict(backend="landmark", landmark=cfg)))
    out = {}
    argkmin_module.shard_sweep = sweep_kept
    try:
        for name, kw in runs:
            spmv_seen[0] = 0
            distributed_module.bsr_spmv = spmv_kept if kw.get("backend") == "bsr" else bsr_spmv
            t0 = time.perf_counter()
            eng = StreamEngine.restore(str(root / "path3"), mesh=mesh, **kw)
            restore_ms = (time.perf_counter() - t0) * 1e3
            require(eng.mesh == mesh and eng.ingestor.store.n_shards == SHARDS
                    and eng.ingestor.store.emb_s[0].is_cuda, f"path 7 {name}: not sharded")
            views = []
            stats, sub_ms, solve_ms, launches = drive_subbatches(eng, subs, views)
            out[name] = dict(eng=eng, stats=stats, sub_ms=sub_ms, solve_ms=solve_ms,
                             launches=launches, views=views, restore_ms=restore_ms,
                             kept=kept[0] if name == "allgather" else None)
    finally:
        argkmin_module.shard_sweep = real_sweep
        distributed_module.bsr_spmv = bsr_spmv

    exact, lmk = out6["exact"], out6["landmark"]
    for name, o in out.items():
        eng, stats, launches = o["eng"], o["stats"], o["launches"]
        ell_sweeps = sum(s.iterations for s in stats if s.backend in ("ell_cuda", "landmark"))
        bsr_sweeps = sum(s.iterations for s in stats if s.backend == "bsr")
        chunks = eng._lm.assign_chunks if name == "landmark" else 0
        summ = eng.transport_summary()
        print(f"   path 7 {name}: restore {o['restore_ms']:.1f} ms; per sub-batch submit "
              f"{[round(x, 1) for x in o['sub_ms']]} ms, solve {[round(x, 1) for x in o['solve_ms']]}"
              f" ms, sweeps {[s.iterations for s in stats]}, transports "
              f"{sorted({s.transport for s in stats})}, backends {sorted({s.backend for s in stats})}"
              f"; launches {launches}; halo batches {summ['halo_batches']}, overflows "
              f"{summ['overflows']}, rung modes {summ['rung_modes']}, export budgets "
              f"{summ['export_budgets']}", flush=True)
        require(launches["ell"] == SHARDS * ell_sweeps and launches["bsr"] == SHARDS * bsr_sweeps,
                f"path 7 {name}: sweep/SpMV launches != 8 x sweeps")
        require(launches["argkmin"] == SHARDS * inserting + chunks,
                f"path 7 {name}: argkmin launches != 8 x inserting sub-batches + chunks")
        require(launches["cc_step"] == launches["cc_fixpoint"] == 0, f"path 7 {name}: cc launched")
        if name in ("allgather", "halo"):
            require(all(views_equal(v, w) for v, w in zip(o["views"], out6["exact_views"])),
                    f"path 7 {name}: a committed view differs from path 6's exact engine")
            require_same_graph(eng, exact, f"path 7 {name} vs path 6's exact engine")
            require([s.iterations for s in stats] == [s.iterations for s in out6["exact_stats"]],
                    f"path 7 {name}: sweeps differ from path 6's exact engine")
        elif name == "landmark":
            require(all(views_equal(v, w) for v, w in zip(o["views"], out6["landmark_views"])),
                    "path 7 landmark: a committed view differs from path 6's landmark engine")
            require_same_graph(eng, lmk, "path 7 landmark vs path 6's landmark engine")
    require(all(views_equal(v, w) for v, w in zip(out["bsr_allgather"]["views"],
                                                   out["bsr_halo"]["views"])),
            "path 7 bsr: the two transports' views differ")
    ell_views = out["allgather"]["views"]
    gaps = [unl_gap(v, w) for v, w in zip(out["bsr_allgather"]["views"], ell_views)]
    flips = 0
    for v, w in zip(out["bsr_allgather"]["views"], ell_views):
        ids = np.flatnonzero(w.alive & (w.labels == UNLABELED) & (np.abs(w.f - 0.5) > TOL))
        flips += int(((v.f[ids] >= 0.5) != (w.f[ids] >= 0.5)).sum())
    print(f"   path 7: (a) and (b) == path 6's exact engine after every sub-batch (F, labels, "
          f"alive bitwise; graphs byte for byte); bsr all-gather == bsr halo bitwise; "
          f"delta-stopped max|dF| of bsr vs (a) per sub-batch "
          f"{[f'{g:.2e}' for g in gaps]} (held <= {BSR_ATOL:.0e}: {full}); predictions "
          f"differing where (a) is > 20 delta from 0.5: {flips}; landmark == path 6's "
          f"landmark engine bitwise")
    require(flips == 0, "path 7 bsr: predictions differ from the ell engine's away from 0.5")
    require(not full or max(gaps) <= BSR_ATOL, "path 7 bsr: beyond 2e-3 of the ell engine")
    spmv_err = 0.0
    for a in kept_spmv:
        got, want = bsr_spmv(*a), bsr_spmv_ref(*a)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                "a path-7 mesh SpMV: kernel != plain version")
        spmv_err = max(spmv_err, float((got - want).abs().max()) if got.numel() else 0.0)
    blocks, cols, x = kept_spmv[0]
    print(f"   path 7: {len(kept_spmv)} of the bsr engines' per-shard SpMVs, inputs kept "
          f"during the run (R={blocks.shape[0]} block rows a shard, J={blocks.shape[1]}, "
          f"global block columns into x of {x.shape[0]}): kernel == plain version bitwise")
    c_eng = out["bsr_allgather"]["eng"]
    host = build_host_problem(c_eng.graph, auto_bucket=True, row_multiple=SHARDS * 8,
                              max_k=c_eng.max_k, warned=set())
    staged = apply_halo_layout(host, partition.build_halo_plan(host.nbr, SHARDS))
    bl = ell_bsr_layout(staged.nbr, 8)
    fixed = dict(delta=0.0, max_iters=30)
    pb = build_stream_plan(mesh, staged.bucket_key, backend="bsr", block_size=8,
                           num_slots=bl.num_slots, **fixed)
    pe = build_stream_plan(mesh, staged.bucket_key, backend="ell_cuda", **fixed)
    prob = pb.put_problem(staged.nbr, staged.wgt, staged.wl0, staged.wl1, staged.valid)
    f0 = pb.put_row(np.full(staged.bucket_key[0], 0.5, np.float32))
    fr = pb.put_row(staged.valid)
    rb, re_ = pb(prob, f0, fr, slot=pb.put_row(bl.slot)), pe(prob, f0, fr)
    valid = torch.from_numpy(staged.valid).to(rb.f.device)
    d_fix = float((rb.f - re_.f)[valid].abs().max())
    print(f"   path 7: the mesh's bsr and ell_cuda bodies, 30 sweeps with every row on (delta "
          f"= 0) on (c)'s last snapshot (U={staged.bucket_key[0]}, {bl.num_slots} tile slots): "
          f"max|F bsr - F ell| = {d_fix:.2e} (bound 1e-05)")
    require(rb.iterations == re_.iterations == 30 and d_fix <= 1e-5,
            "path 7: the mesh's bsr and ell bodies compute different iterations")

    # per transport at the last sub-batch, with the card's name and limit
    card_info = card_line()
    a = out["allgather"]["eng"]
    host = build_host_problem(a.graph, auto_bucket=True, row_multiple=SHARDS, max_k=a.max_k,
                              warned=set())
    layout = partition.build_halo_plan(host.nbr, SHARDS)
    budget = partition.export_budget(layout, len(host.unl_ids))
    u = host.bucket_key[0]
    probe = stream_module.measure_transports(mesh, apply_halo_layout(host, layout),
                                             layout.export_max, backend="ell_cuda", delta=DELTA)
    timing = {}
    for name in ("allgather", "halo", "bsr_allgather", "bsr_halo", "landmark"):
        o = out[name]
        last = o["stats"][-1]
        per = o["eng"].transport_summary()["transport_bytes_per_sweep"]
        timing[name] = dict(sweeps=last.iterations, solve_ms=o["solve_ms"][-1],
                            us_per_sweep=1e3 * o["solve_ms"][-1] / max(last.iterations, 1),
                            transport=last.transport, bytes_per_sweep=per)
        print(f"   path 7 {name} last sub-batch [{card_info}]: {last.iterations} sweeps, solve "
              f"{o['solve_ms'][-1]:.1f} ms, {timing[name]['us_per_sweep']:.1f} us a sweep on "
              f"{last.transport}; bytes copied a sweep (mean over the run) {per}")
    shard_ms, whole_ms = time_shard_launches(out["allgather"]["kept"])
    print(f"   path 7 probe [{card_info}]: one sweep of the last snapshot (U={u}, export max "
          f"{layout.export_max}, budget {budget}, export fraction {budget * SHARDS / u:.3f} at "
          f"the budget, {layout.export_max * SHARDS / u:.3f} at the max): all-gather "
          f"{probe['allgather']:.4f} ms, halo {probe['halo']:.4f} ms; argkmin per shard at the "
          f"last sub-batch (C/8={out['allgather']['kept'][0][0][0].shape[0]}, M="
          f"{out['allgather']['kept'][0][3][0].shape[0]}) {[round(x, 4) for x in shard_ms]} ms "
          f"(sum {sum(shard_ms):.4f} ms); one launch over the whole store {whole_ms:.4f} ms")

    t0 = time.perf_counter()
    a.checkpoint(str(root / "path7"))
    r = StreamEngine.restore(str(root / "path7"))
    ck_ms = (time.perf_counter() - t0) * 1e3
    require(r.mesh is None and r.ingestor.store.n_shards == 1 and r.transport == a.transport,
            "path 7: the 8 -> 1 restore")
    require_same_state(r, a, "path 7 8 -> 1 restore")
    pid = probe_ids(r.graph)
    require_same_answers(r.device_view().query(pid), a.device_view().query(pid),
                         "path 7 8 -> 1 restore")
    print(f"   path 7: engine (a) checkpointed and restored onto no mesh in {ck_ms:.1f} ms: "
          f"graph and store byte-identical, {len(pid)} answers equal")
    for o in out.values():
        o["eng"].close()
    r.close()
    return dict(launches={name: o["launches"] for name, o in out.items()}, timing=timing,
                spmv_err=spmv_err,
                probe=probe, shard_ms=shard_ms, whole_ms=whole_ms,
                export_fraction=budget * SHARDS / u,
                halo=out["halo"]["eng"].transport_summary(), card=card_info)


def phase_mesh_halo(vertices, batch_size, n_batches=2):
    """Path 7b: a fresh 8-shard engine with ``ingest_order="locality"`` and
    ``transport="halo"`` over the first ``n_batches`` batches of path 1's
    stream, beside a single-device engine with the same ingest order:
    graphs and labels bit for bit after every batch, at least one batch on
    the halo collective, launches 8 a sweep and 8 an inserting batch."""
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=42, class_sep=6.0,
                      noise=0.9)
    batches = [b for b, _ in gaussian_mixture_stream(spec)][:n_batches]
    single = StreamEngine(DynamicGraph(emb_dim=spec.emb_dim, k=5), delta=DELTA,
                          ingest="device", ingest_order="locality")
    eng = StreamEngine(DynamicGraph(emb_dim=spec.emb_dim, k=5), delta=DELTA, ingest="device",
                       ingest_order="locality", mesh=DeviceMesh.local(SHARDS), transport="halo")
    launches = {key: 0 for key in counted()}
    for t, b in enumerate(batches):
        single.step(b)
        reset_launches()
        t0 = time.perf_counter()
        st = eng.step(b)
        ms = (time.perf_counter() - t0) * 1e3
        for key, n in read_launches().items():
            launches[key] += n
        require_same_graph(eng, single, f"path 7b batch {t}")
        require(st.converged, f"path 7b batch {t} did not converge")
        print(f"   path 7b batch {t}: {st.iterations} sweeps on {st.transport}, rung "
              f"{st.bucket}, step {ms:.1f} ms; == the single-device engine", flush=True)
    summ = eng.transport_summary()
    sweeps = eng.transport_sweeps["halo"] + eng.transport_sweeps["allgather"]
    host = build_host_problem(eng.graph, auto_bucket=True, row_multiple=SHARDS,
                              max_k=eng.max_k, warned=set())
    counts = partition.build_halo_plan(host.nbr, SHARDS).export_counts
    print(f"   path 7b: halo batches {summ['halo_batches']}, overflows {summ['overflows']}, "
          f"export budgets {summ['export_budgets']} (export counts of the last snapshot "
          f"{counts.tolist()}, of {host.bucket_key[0] // SHARDS} rows a shard), bytes a sweep "
          f"{summ['transport_bytes_per_sweep']}; launches {launches}")
    require(summ["halo_batches"] >= 1, "path 7b: no batch ran the halo collective")
    require(launches["ell"] == SHARDS * sweeps and launches["argkmin"] == SHARDS * len(batches),
            "path 7b: launches != 8 x sweeps / 8 x batches")
    eng.close()
    single.close()
    return dict(launches=launches, halo_batches=summ["halo_batches"])


# --------------------------------------------------------------------- #
# the LM serving slice (path 8)
# --------------------------------------------------------------------- #
LM_ARCH = "qwen3-0.6b"  # at its full published config (src/repro_torch/configs/qwen3_0_6b.py)
LM_WAVES, LM_SEQ = 4, 64  # path 8's documents: 4 waves of 64-token documents
LM_REQUESTS, LM_POOL, LM_S_MAX = 24, 8, 256
LM_CONTROL_REQUESTS = 8  # the fp8-cache control serves the first pool load again
LM_LONG, LM_LONG_DECODE = 4096, 16  # (c): the chunked prefill, then decoding through it
# The engine's bf16 logits against the plain fp32 forward of the same weights,
# max |diff| over every logit of every generated position.  Both use the same
# bf16 weights, so the gap is the bf16 activations' and cache's rounding (rel
# 2^-9 each) compounded over 28 layers: 0.086-0.110 measured on the H100 (PR
# 19), about 3.5 bf16 ULPs of a logit in [4, 8).  0.16 leaves 1.45x of that;
# the same run with the KV cache rounded through fp8 (3 mantissa bits) measured
# 0.244, 1.5x above it, so a cache kept in fp8 fails.
LM_TOL = 0.16
LM_FP8 = torch.float8_e4m3fn  # the negative control rounds the KV cache through it
BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet


def lm_fp32_reference(model):
    """The plain fp32 forward: the same weights upcast, dense attention, no
    cache, no batching, fp32 matmuls with no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ref = build_model(override(model.cfg, attn_impl="dense")).float()
    ref.load_state_dict(model.state_dict())
    return ref


def lm_gap(engine_rows, ref_logits):
    """max |engine − fp32| over every logit of the rows, and the rows where
    the fp32 top-2 margin exceeds twice the tolerance (two logits each off by
    at most the tolerance can swap only inside it)."""
    err = float((engine_rows.float() - ref_logits).abs().max())
    top2 = ref_logits.topk(2, dim=-1).values
    return err, (top2[:, 0] - top2[:, 1]), ref_logits.argmax(-1)


def record_engine(engine, round_cache=None):
    """Wrap ``engine``'s ``submit``/``step``/``_decode`` (the instance's, as
    path 1 wraps ``run_propagation``): keep the logits row each request's
    token was chosen from, the host time of every submit and pooled step,
    and the slots a step decoded.  ``round_cache`` rounds the cache every
    decode call sees (the fp8 control)."""
    rec = dict(rows={}, step_ms=[], active=[], submit_ms=[], prompt_tokens=0)
    decode, submit, step = engine._decode, engine.submit, engine.step
    last = {}

    def dec(cache, batch):
        if round_cache is not None:
            cache = {key: round_cache(leaf) for key, leaf in cache.items()}
        last["logits"], new = decode(cache, batch)
        return last["logits"], new

    def sub(req):
        t0 = time.perf_counter()
        ok = submit(req)  # ends in a host sync: the first token's argmax
        if ok:
            rec["submit_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["prompt_tokens"] += len(req.prompt)
            slot = next(i for i, r in enumerate(engine.slots) if r is req)
            rec["rows"][req.uid] = [last["logits"][slot, -1].float()]
        return ok

    def stp():
        active = [(i, r) for i, r in enumerate(engine.slots) if r is not None]
        t0 = time.perf_counter()
        step()  # ends in a host sync: the argmax to numpy
        if active:
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["active"].append(len(active))
            for i, r in active:
                rec["rows"][r.uid].append(last["logits"][i, -1].float())

    engine._decode, engine.submit, engine.step = dec, sub, stp
    return rec


def lm_requests(curated, n, seed):
    """``n`` requests whose prompts are prefixes of 16–64 tokens of curated
    documents, ``max_new`` 16–64, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    docs = rng.choice(len(curated), n, replace=False)
    lens, news = rng.integers(16, 65, n), rng.integers(16, 65, n)
    return [Request(uid=i, prompt=curated[d][:lens[i]].copy(), max_new=int(news[i]))
            for i, d in enumerate(docs)]


def serve_and_hold(model, ref, curated, n, round_cache=None):
    """Serve ``n`` requests through a fresh ``ServeEngine``; return the
    engine, its record and, per request, the gap to the fp32 forward."""
    engine = ServeEngine(model, max_batch=LM_POOL, s_max=LM_S_MAX)
    rec = record_engine(engine, round_cache)
    reqs = lm_requests(curated, n, seed=1)
    t0 = time.perf_counter()
    done = engine.run(reqs)
    rec["run_s"] = time.perf_counter() - t0
    require(len(done) == n and all(len(r.out) == r.max_new for r in reqs),
            f"path 8: {len(done)} of {n} requests finished with their max_new tokens")
    gaps = []
    for r in reqs:
        toks = np.concatenate([r.prompt, np.asarray(r.out[:-1])])
        want = ref(torch.as_tensor(toks[None], dtype=torch.int64, device=ref.device))[0]
        want = want[len(r.prompt) - 1:]  # the positions that chose out[0..max_new-1]
        got = torch.stack(rec["rows"][r.uid])
        require(got.shape == want.shape and torch.isfinite(got).all(),
                f"path 8: request {r.uid}'s logits {tuple(got.shape)} vs {tuple(want.shape)}")
        err, margin, ref_tok = lm_gap(got, want)
        gaps.append(dict(err=err, margin=margin, ref_tok=ref_tok,
                         tok=torch.as_tensor(r.out, device=ref.device)))
    return engine, rec, reqs, gaps


def phase_curation(docs, card, waves=LM_WAVES):
    """Path 8 (a): ``PseudoLabelPipeline`` on the card (``DynLP`` with the
    default backend, ``ell_cuda``) over ``docs`` documents in ``waves``."""
    vocab = get_config(LM_ARCH).vocab
    pipe = PseudoLabelPipeline(k=5, delta=DELTA)
    require(pipe.lp.device.type == "cuda", f"pipeline on {pipe.lp.device}")
    last = {}

    def recording(problem, f0, frontier0, **kw):
        res = run_propagation(problem, f0, frontier0, **kw)
        last.update(problem=problem, f0=f0.clone(), frontier0=frontier0.clone(), kw=kw,
                    res=res)
        return res

    rng = np.random.default_rng(0)
    truth, sweeps = {}, 0
    dynlp_module.run_propagation = recording
    try:
        for wave in range(waves):
            toks, labels, cls = make_documents(rng, docs // waves, LM_SEQ, vocab)
            base = pipe.graph.num_nodes
            t0 = time.perf_counter()
            st = pipe.ingest(toks, labels)
            wall = (time.perf_counter() - t0) * 1e3
            truth.update({base + i: int(c) for i, c in enumerate(cls)})
            sweeps += st.lp_iterations
            print(f"   [{card}] wave {wave}: {st.num_docs} documents, {st.lp_iterations} "
                  f"iterations, DynLP step {st.lp_ms:.1f} ms, ingest {wall:.1f} ms", flush=True)
    finally:
        dynlp_module.run_propagation = run_propagation
    kw = dict(last["kw"], backend="ref")
    ref = run_propagation(last["problem"], last["f0"], last["frontier0"], **kw)
    u = int(last["problem"].valid.sum())
    diff = float((last["res"].f[:u] - ref.f[:u]).abs().max())
    quality = pipe.label_quality(truth)
    ids, curated = pipe.select(target_class=1, confidence=0.7)
    purity = float(np.mean([truth[i] == 1 for i in ids]))
    print(f"   last wave re-solved with backend='ref': max|dF|={diff:.1e} (bound {TOL:.0e}); "
          f"pseudo-label accuracy {quality:.4f}; select(1, 0.7): {len(ids)} documents, "
          f"purity {purity:.4f}")
    require(diff <= TOL, "path 8: ell_cuda vs ref beyond 20*delta")
    require(quality > 0.9 and purity > 0.9, f"path 8: accuracy {quality}, purity {purity}")
    require(len(ids) >= LM_REQUESTS, f"path 8: {len(ids)} curated documents")
    return dict(sweeps=sweeps, curated=curated, accuracy=quality, purity=purity)


def phase_lm_serve(curated, card):
    """Path 8 (b): ``ServeEngine(max_batch=8, s_max=256)`` on qwen3-0.6b at
    its full published config, 24 requests cut from the curated documents,
    every generated position's logits held against the plain fp32 forward;
    then the same with the KV cache rounded through fp8, which must fail
    the tolerance."""
    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    # ArchConfig.num_params counts the matrices and the layers' two norms; the
    # model also holds final_norm and, with qk-norm, two head_dim scales a layer
    scales = cfg.d_model + (2 * cfg.hd * cfg.n_layers if cfg.qk_norm else 0)
    require(n_params == cfg.num_params() + scales and model.embed.dtype == torch.bfloat16,
            f"path 8: {n_params} parameters, ArchConfig says {cfg.num_params()} + {scales}")
    print(f"   {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"({cfg.n_kv_heads} kv, head_dim {cfg.hd}, qk-norm {cfg.qk_norm}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}: {n_params:,} parameters, {weight_bytes:,} B of bf16 weights, "
          f"drawn in {build_s:.1f} s")
    ref = lm_fp32_reference(model)
    engine, rec, reqs, gaps = serve_and_hold(model, ref, curated, LM_REQUESTS)
    cache_bytes = sum(leaf.numel() * leaf.element_size() for leaf in engine.cache.values())
    peak = torch.cuda.max_memory_allocated()
    err = max(g["err"] for g in gaps)
    steps, full = np.array(rec["step_ms"]), np.array(rec["active"]) == LM_POOL
    tok_s = LM_POOL * full.sum() / (steps[full].sum() / 1e3)
    prefill_ms = sum(rec["submit_ms"]) / rec["prompt_tokens"]
    print(f"   [{card}] {LM_REQUESTS} requests, {sum(len(r.out) for r in reqs)} tokens in "
          f"{rec['run_s']:.1f} s: {engine.steps} pooled steps, {engine.prefill_calls} prefill "
          f"calls; a pooled decode step median {np.median(steps):.2f} ms, p99 "
          f"{np.percentile(steps, 99):.2f} ms; {tok_s:.1f} tokens/s at {LM_POOL} slots "
          f"({int(full.sum())} full steps); prefill {prefill_ms:.2f} ms a prompt token")
    print(f"   [{card}] weights {weight_bytes:,} B, cache {cache_bytes:,} B "
          f"(pool {LM_POOL}, s_max {LM_S_MAX}), max_memory_allocated {peak:,} B "
          f"(the fp32 reference's {2 * weight_bytes:,} B included)")
    step_device_ms, kernels = decode_device_time(model, engine)
    step_bound_ms = (weight_bytes + 2 * cache_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"   [{card}] one pooled decode step on the card (torch.profiler, 3 steps): "
          f"{step_device_ms:.3f} ms of kernels ({kernels:.0f} launches), busy "
          f"{step_device_ms / np.median(steps):.1%} of the median step; bound "
          f"{step_bound_ms:.3f} ms (bytes: the weights and the cache read once, the new "
          f"cache written once)")
    control = serve_and_hold(model, ref, curated, LM_CONTROL_REQUESTS,
                             round_cache=lambda leaf: leaf.to(LM_FP8).to(leaf.dtype))[3]
    control_err = max(g["err"] for g in control)
    print(f"   [{card}] logits vs the fp32 forward: max|diff| {err:.4f} over "
          f"{sum(len(g['tok']) for g in gaps)} positions (per request "
          f"{min(g['err'] for g in gaps):.4f}–{err:.4f}); the fp8-cache control "
          f"{control_err:.4f} over its {LM_CONTROL_REQUESTS} requests; tolerance {LM_TOL}")
    flips = sum(int(((g["tok"] != g["ref_tok"]) & (g["margin"] > 2 * LM_TOL)).sum())
                for g in gaps)
    held = sum(int((g["margin"] > 2 * LM_TOL).sum()) for g in gaps)
    print(f"   greedy tokens equal to the fp32 argmax at {held - flips} of the {held} positions "
          f"whose fp32 top-2 margin exceeds 2 x tolerance")
    require(err <= LM_TOL, f"path 8: logits {err} from the fp32 forward, tolerance {LM_TOL}")
    require(control_err > LM_TOL, f"path 8: the fp8-cache control ({control_err}) "
            f"passes the tolerance {LM_TOL}: it cannot tell the cache's precision")
    require(flips == 0, f"path 8: {flips} greedy tokens differ where the margin is wide")
    return dict(model=model, ref=ref, err=err, control_err=control_err,
                step_ms_p50=float(np.median(steps)), step_ms_p99=float(np.percentile(steps, 99)),
                step_device_ms=step_device_ms, step_bound_ms=step_bound_ms,
                tokens_per_s=float(tok_s), prefill_ms_per_token=float(prefill_ms),
                weight_bytes=weight_bytes, cache_bytes=cache_bytes, peak_bytes=peak)


def decode_device_time(model, engine, reps=3):
    """Kernel time (ms) and kernel launches of one pooled ``decode_step``
    on the engine's cache, from ``torch.profiler`` over ``reps`` steps."""
    batch = {"tokens": torch.zeros((engine.b, 1), dtype=torch.int64, device=model.device),
             "pos": torch.as_tensor(engine.pos, device=model.device)}
    model.decode_step(engine.cache, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            model.decode_step(engine.cache, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    require(kernels, "path 8: the profiler saw no kernel")
    return (sum(e.self_device_time_total for e in kernels) / reps / 1e3,
            sum(e.count for e in kernels) / reps)


def phase_long_prefill(model, ref, curated, card):
    """Path 8 (c): ``prefill`` of 4,096 tokens at B = 1 through the chunked
    attention (q_chunk 1024, k_chunk 2048, the causal skip) against the
    dense attention and the fp32 forward; then its cache placed in an
    ``init_cache(1, 4112)`` and 16 greedy tokens decoded through it, each
    step's logits held against the fp32 forward of its prefix."""
    cfg = model.cfg
    dev = model.device
    toks = torch.as_tensor(curated.reshape(-1)[:LM_LONG][None], dtype=torch.int64, device=dev)
    require(cfg.attn_impl == "auto" and LM_LONG % cfg.q_chunk == 0 and LM_LONG > 2048,
            "path 8 (c) does not reach the chunked attention")
    dense = build_model(override(cfg, attn_impl="dense"))  # the same seed: the same weights
    require(all(torch.equal(a, b) for a, b in zip(model.parameters(), dense.parameters())),
            "path 8: a model built with the same seed has other weights")
    logits, cache = model.prefill({"tokens": toks})  # also the warm-up of the timing
    dense_logits, dense_cache = dense.prefill({"tokens": toks})
    chunked_ms = _wall_ms(lambda: model.prefill({"tokens": toks}))
    dense_ms = _wall_ms(lambda: dense.prefill({"tokens": toks}))
    del dense
    placed = model.init_cache(1, LM_LONG + LM_LONG_DECODE)
    for key in placed:
        placed[key][:, :, :LM_LONG] = cache[key]
    rows, out = [logits[0, -1].float()], [int(logits[0, -1].argmax())]
    for j in range(LM_LONG_DECODE):
        step_logits, placed = model.decode_step(placed, {
            "tokens": torch.tensor([[out[-1]]], device=dev),
            "pos": torch.tensor(LM_LONG + j, device=dev)})
        rows.append(step_logits[0, -1].float())
        out.append(int(step_logits[0, -1].argmax()))
    full = torch.cat([toks[0], torch.tensor(out[:-1], device=dev)])
    want = ref(full[None])[0][LM_LONG - 1:]  # positions 4095 .. 4111
    err_prefill = float((rows[0] - want[0]).abs().max())
    err_decode = float((torch.stack(rows[1:]) - want[1:]).abs().max())
    err_dense = float((dense_logits[0, -1].float() - want[0]).abs().max())
    chunk_vs_dense = float((logits.float() - dense_logits.float()).abs().max())
    cache_gap = max(float((cache[k].float() - dense_cache[k].float()).abs().max())
                    for k in cache)
    # operations the causal prefill needs: the layers' bf16 products, and the
    # fp32 scores and probs·v over the lower triangle (the reference's fp32)
    bf16_ops = 2 * LM_LONG * cfg.n_layers * (cfg._attn_params() + 3 * cfg.d_model * cfg.d_ff)
    fp32_ops = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.hd * LM_LONG * (LM_LONG + 1) / 2
    bound_ms = (bf16_ops / BF16_FLOPS + fp32_ops / F32_FLOPS) * 1e3
    print(f"   [{card}] prefill of {LM_LONG} tokens: chunked {chunked_ms:.1f} ms, dense "
          f"{dense_ms:.1f} ms (median of 3 after a warm-up); bound {bound_ms:.1f} ms "
          f"(operations: {bf16_ops:.3g} bf16, {fp32_ops:.3g} fp32)")
    print(f"   [{card}] last-token logits vs the fp32 forward: chunked {err_prefill:.4f}, dense "
          f"{err_dense:.4f}; chunked vs dense {chunk_vs_dense:.4f} (caches {cache_gap:.4f}); "
          f"{LM_LONG_DECODE} decode steps through the placed cache vs the fp32 forward of "
          f"each prefix {err_decode:.4f}; tolerance {LM_TOL}")
    require(max(err_prefill, err_dense, chunk_vs_dense, err_decode) <= LM_TOL,
            "path 8 (c): the long prefill or the decode after it is beyond the tolerance")
    return dict(chunked_ms=chunked_ms, dense_ms=dense_ms, prefill_bound_ms=bound_ms,
                err_prefill=err_prefill,
                err_decode=err_decode, err_dense=err_dense)


def phase_lm(docs, card):
    """Path 8: curation on the card, then serving at qwen3-0.6b's full
    width.  Every wrapper's count is set to 0 before (a) and read after (c)."""
    reset_launches()
    out = phase_curation(docs, card)
    with torch.no_grad():
        out.update(phase_lm_serve(out["curated"], card))
        out.update(phase_long_prefill(out.pop("model"), out.pop("ref"), out["curated"], card))
    out["launches"] = read_launches()
    print(f"   path 8 launches {out['launches']}; sweeps {out['sweeps']}")
    require(out["launches"]["ell"] == out["sweeps"] and out["sweeps"] > 0,
            f"path 8: {out['launches']['ell']} sweep launches != {out['sweeps']} sweeps")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the first path's host kNN (numpy, O(N^2) over a stream) and the
    # flagged-row merges of the host update take most of the run, so paths
    # 1 and 2 stop at 20,000 vertices; path 3 runs the full 100,000
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--stream-vertices", type=int, default=STREAM_VERTICES)
    ap.add_argument("--batch", type=int, default=5_000)
    ap.add_argument("--save-sweeps", metavar="NPZ",
                    help="write the inputs of the timed sweeps there, for "
                         "tools/torch_kernel_times.py --sweeps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    with Phase("card and build"):
        card = card_line()
        print(f"   nvidia-smi: {card}")
        print(f"   torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        lib = load_library()
        print(f"   built {lib.path.relative_to(REPO)} in {lib.seconds:.1f} s "
              f"(fresh build: {lib.built})")
        report_ptxas(lib.log)
    with Phase("kernels vs plain versions on the card"):
        sweep_err, argkmin_err, bsr_err, cc_err = phase_kernels()
    with Phase("path 1: DynLP.step over the stream"):
        prefix, dyn_launches = phase_main(args.vertices, args.batch)
    with Phase("path 2: StreamEngine(ingest='device') over the stream"):
        out2 = phase_stream(args.vertices, args.batch, prefix)
    with Phase("path 3: StreamEngine(ingest='device', backend='bsr') over the stream"):
        out3 = phase_stream(args.stream_vertices, args.batch, out2["prefix"], backend="bsr")
    with Phase("path 4: serving and persistence on path 3's engine"):
        out4 = phase_serve(out3["engine"], args.stream_vertices, args.batch)
    with Phase("the cc entry point on path 3's last snapshot"):
        cc = phase_cc(out3["staged"]["host"].nbr)
    with Phase("timing at path 3's last batch"):
        tb, ell_last = phase_bsr_timing(out3)
        tm = phase_timing(ell_last, args.save_sweeps)
        ta = phase_argkmin_timing(out3["argkmin"])
        tc, tf = phase_cc_timing(cc)
    with Phase("path 5: ITLP.step and STLP.step over path 1's stream"):
        out5 = phase_baselines(args.vertices, args.batch, prefix)
    with Phase("path 5 at full size: ITLP on path 3's last snapshot"):
        full5 = phase_itlp_full(ell_last, out3["engine"].graph)
    with Phase("path 6: StreamEngine(backend='landmark') on path 3's checkpoint"):
        out6 = phase_landmark(args.stream_vertices, args.batch)
    with Phase("path 7: StreamEngine(mesh=DeviceMesh.local(8)) on path 3's checkpoint"):
        out7 = phase_mesh(out6, args.stream_vertices >= STREAM_VERTICES)
    shutil.rmtree(REPO / "build" / "path4", ignore_errors=True)
    with Phase("path 7b: a fresh 8-shard halo engine, ingest_order='locality'"):
        out7b = phase_mesh_halo(args.vertices, args.batch)
    with Phase(f"path 8: PseudoLabelPipeline, then ServeEngine on {LM_ARCH} at full width"):
        out8 = phase_lm(args.vertices, card)
    # every kernel's launches as read on each path, for every path
    paths = dict(path1=dyn_launches, path2=out2["launches"], path3=out3["launches"],
                 path4=out4["launches"], path5=out5["launches"], path5_full=full5["launches"],
                 path6=out6["launches"], path6_exact=out6["exact_launches"],
                 **{f"path7_{name}": n for name, n in out7["launches"].items()},
                 path7b=out7b["launches"], path8=out8["launches"])

    def per_path(key):
        return {f"{name}_launches": counts[key] for name, counts in paths.items()}

    record = {"kernels": [{
        "name": "ell_propagate_step", "route": "cuda",
        "source": "src/repro_torch/csrc/ell_propagate.cu",
        "replaces": "src/repro/kernels/ell_propagate.py:58",
        "launches": out2["launches"]["ell"], **per_path("ell"),
        "max_abs_err": max(sweep_err, tm["max_abs_err"], out4["sweep_err"]),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None,
        "path7": {name: t for name, t in out7["timing"].items()},
        "path7_probe_ms": out7["probe"],
    }, {
        "name": "argkmin", "route": "cuda",
        "source": "src/repro_torch/csrc/argkmin.cu",
        "replaces": "src/repro/kernels/argkmin.py:117",
        "launches": out3["launches"]["argkmin"], **per_path("argkmin"),
        "max_abs_err": max(argkmin_err, ta["max_abs_err"], out4["argkmin_err"],
                           out6["argkmin_err"]),
        "ms": ta["ms"], "plain_ms": ta["plain_ms"], "bound_ms": ta["bound_ms"],
        "bound_by": ta["bound_by"], "library_ms": ta["library_ms"],
        "path7_shard_ms": out7["shard_ms"], "path7_whole_store_ms": out7["whole_ms"],
    }, {
        "name": "bsr_spmv", "route": "cuda",
        "source": "src/repro_torch/csrc/bsr_spmv.cu",
        "replaces": "src/repro/kernels/bsr_spmv.py:58",
        "launches": out3["launches"]["bsr"], **per_path("bsr"),
        "max_abs_err": max(bsr_err, tb["max_abs_err"], out7["spmv_err"]),
        "ms": tb["ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
    }, {
        "name": "cc_hook_step", "route": "cuda",
        "source": "src/repro_torch/csrc/cc_hook.cu",
        "replaces": "src/repro/kernels/cc_hook.py:34",
        # off the main paths: its launches in the step loop on path 3's
        # last snapshot (phase 7)
        "launches": cc["step_launches"], **per_path("cc_step"),
        "max_abs_err": max(cc_err, tc["max_abs_err"]),
        "ms": tc["ms"], "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
        "bound_by": tc["bound_by"], "library_ms": None,
    }, {
        "name": "cc_fixpoint", "route": "cuda",
        "source": "src/repro_torch/csrc/cc_hook.cu",
        "replaces": "src/repro/kernels/cc_hook.py:60",
        # the cc entry point on path 3's last snapshot (phase 7)
        "launches": cc["launches"], **per_path("cc_fixpoint"),
        "max_abs_err": max(cc_err, tf["max_abs_err"]),
        "ms": tf["ms"], "plain_ms": tf["plain_ms"], "bound_ms": tf["bound_ms"],
        "bound_by": tf["bound_by"], "library_ms": None,
        **{key: tf[key] for key in ("call_ms", "step_loop_ms", "components_ms",
                                    "iterations", "blocks", "kept_groups")},
    }]}
    print(f"   launches read on each path: {json.dumps(paths)}; the cc entry point on path "
          f"3's last snapshot {cc['launches']} fixpoint ({cc['iterations']} steps), its step "
          f"loop {cc['step_launches']} hook steps; path 6's {out6['chunks']} assignment chunks")
    print(f"   total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
