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
   agree with the CPU within 20·δ.
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
from repro_torch.core import stream as stream_module  # noqa: E402
from repro_torch.core.components import connected_components, host_components  # noqa: E402
from repro_torch.core.snapshot import LabelView  # noqa: E402
from repro_torch.core.dynlp import DynLP  # noqa: E402
from repro_torch.core.stream import StreamEngine  # noqa: E402
from repro_torch.core.init_labels import supernode_init  # noqa: E402
from repro_torch.data.synth import StreamSpec, accuracy, gaussian_mixture_stream  # noqa: E402
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph  # noqa: E402
from repro_torch.graph.knn import SELECT_MARGIN, normalize_rows, selection_slack  # noqa: E402
from repro_torch.graph.structures import coo_to_csr, csr_to_ell_fast  # noqa: E402
from repro_torch.ingest import incremental_knn  # noqa: E402
from repro_torch.kernels._build import load_library, ptxas_report  # noqa: E402
from repro_torch.kernels import ops as ops_module  # noqa: E402
from repro_torch.kernels.argkmin import (argkmin_candidates, argkmin_geometry,  # noqa: E402
                                         argkmin_launch, argkmin_ref, resident_blocks)
from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_ref  # noqa: E402
from repro_torch.kernels.cc_hook import (cc_fixpoint, cc_hook_ref, cc_hook_step,  # noqa: E402
                                         connected_components_cuda,
                                         connected_components_ref)
from repro_torch.kernels.ell_propagate import ell_propagate_ref, ell_propagate_step  # noqa: E402
from repro_torch.kernels.ops import run_propagation, select_backend  # noqa: E402
from repro_torch.serving.estimator import DynLabelPropagation  # noqa: E402
from repro_torch.serving.lp_service import LPService  # noqa: E402
from repro_torch.state import problem_from_arrays  # noqa: E402
from tools.gpu_timing import QueueError, enqueue, gpu_times  # noqa: E402

DELTA = 1e-4
TOL = 20 * DELTA  # port vs port across backends/devices (the reference's own bound)
BSR_ATOL = 2e-3  # a bsr stream against an ELL one (the reference's test bound)
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
    views = []
    ell_propagate_step.launches = 0
    try:
        for t, (batch, cls) in enumerate(gaussian_mixture_stream(spec)):
            base = g.num_nodes
            st = dyn.step(batch)
            truth[base:base + len(cls)] = cls
            sweeps += st.iterations
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
    launches = ell_propagate_step.launches
    print(f"   sweeps={sweeps} kernel launches={launches}")
    require(launches == sweeps and launches > 0,
            f"launch count {launches} != sweeps {sweeps}")

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
    return dict(graph={name: getattr(g, name).copy() for name in GRAPH}, views=views), launches


GRAPH = ("src", "dst", "wgt", "knn_idx", "knn_wgt")


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
    ell_propagate_step.launches = 0
    argkmin_candidates.launches = 0
    bsr_spmv.launches = 0
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
    launches = dict(ell=ell_propagate_step.launches, argkmin=argkmin_candidates.launches,
                    bsr=bsr_spmv.launches)
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
    ell_propagate_step.launches = 0
    argkmin_candidates.launches = 0
    bsr_spmv.launches = 0
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
    launches = dict(ell=ell_propagate_step.launches, argkmin=argkmin_candidates.launches,
                    bsr=bsr_spmv.launches)
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
    require(clf.engine_.device.type == "cuda" and clf.engine_._read_stream is not None,
            "the estimator is not on the card")
    require(argkmin_candidates.launches > a0 and ell_propagate_step.launches > s0,
            "the estimator did not launch the kernels")
    print(f"   DynLabelPropagation(k=5): fit 1000, partial_fit 3000, score on 1000 unseen: "
          f"accuracy {acc:.4f} ({est_ms:.0f} ms)")
    require(acc >= 0.99, f"estimator accuracy {acc} < 0.99")
    shutil.rmtree(root, ignore_errors=True)
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
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the first path's host kNN (numpy, O(N^2) over a stream) and the
    # flagged-row merges of the host update take most of the run, so paths
    # 1 and 2 stop at 20,000 vertices; path 3 runs the full 100,000
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--stream-vertices", type=int, default=100_000)
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
    record = {"kernels": [{
        "name": "ell_propagate_step", "route": "cuda",
        "source": "src/repro_torch/csrc/ell_propagate.cu",
        "replaces": "src/repro/kernels/ell_propagate.py:58",
        "launches": out2["launches"]["ell"], "path4_launches": out4["launches"]["ell"],
        "max_abs_err": max(sweep_err, tm["max_abs_err"], out4["sweep_err"]),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None,
    }, {
        "name": "argkmin", "route": "cuda",
        "source": "src/repro_torch/csrc/argkmin.cu",
        "replaces": "src/repro/kernels/argkmin.py:117",
        "launches": out3["launches"]["argkmin"], "path4_launches": out4["launches"]["argkmin"],
        "max_abs_err": max(argkmin_err, ta["max_abs_err"], out4["argkmin_err"]),
        "ms": ta["ms"], "plain_ms": ta["plain_ms"], "bound_ms": ta["bound_ms"],
        "bound_by": ta["bound_by"], "library_ms": ta["library_ms"],
    }, {
        "name": "bsr_spmv", "route": "cuda",
        "source": "src/repro_torch/csrc/bsr_spmv.cu",
        "replaces": "src/repro/kernels/bsr_spmv.py:58",
        "launches": out3["launches"]["bsr"], "max_abs_err": max(bsr_err, tb["max_abs_err"]),
        "ms": tb["ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
    }, {
        "name": "cc_hook_step", "route": "cuda",
        "source": "src/repro_torch/csrc/cc_hook.cu",
        "replaces": "src/repro/kernels/cc_hook.py:34",
        # off the main paths: its launches in the step loop on path 3's
        # last snapshot (phase 7)
        "launches": cc["step_launches"], "max_abs_err": max(cc_err, tc["max_abs_err"]),
        "ms": tc["ms"], "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
        "bound_by": tc["bound_by"], "library_ms": None,
    }, {
        "name": "cc_fixpoint", "route": "cuda",
        "source": "src/repro_torch/csrc/cc_hook.cu",
        "replaces": "src/repro/kernels/cc_hook.py:60",
        # the cc entry point on path 3's last snapshot (phase 7)
        "launches": cc["launches"], "max_abs_err": max(cc_err, tf["max_abs_err"]),
        "ms": tf["ms"], "plain_ms": tf["plain_ms"], "bound_ms": tf["bound_ms"],
        "bound_by": tf["bound_by"], "library_ms": None,
        **{key: tf[key] for key in ("call_ms", "step_loop_ms", "components_ms",
                                    "iterations", "blocks", "kept_groups")},
    }]}
    print(f"   launches: path 1 (DynLP) {dyn_launches} sweep kernel; path 2 (engine, ell_cuda) "
          f"{out2['launches']['ell']} sweep kernel, {out2['launches']['argkmin']} argkmin; "
          f"path 3 (engine, bsr) {out3['launches']['bsr']} SpMV, "
          f"{out3['launches']['argkmin']} argkmin; path 4 (service, ell_cuda) "
          f"{out4['launches']['ell']} sweep kernel, {out4['launches']['argkmin']} argkmin over "
          f"{out4['windows']} windows; cc entry point {cc['launches']} fixpoint "
          f"({cc['iterations']} steps), its step loop {cc['step_launches']} hook steps")
    print(f"   total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
