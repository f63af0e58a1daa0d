#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DynLP on one NVIDIA GPU and check it.

    python3 chip_smoke.py                            # full run
    python3 chip_smoke.py --vertices 10000 --stream-vertices 20000   # shorter

Phases (each prints its lines and its seconds; any failed check raises):

1. Card and build: the card's name and power limit, and the build of the
   CUDA kernels from ``src/repro_torch/csrc`` with nvcc's register report.
2. Kernels against their plain PyTorch versions on the card: the frontier
   sweep ``ell_propagate_step`` and the argkmin kernel, on edge cases and at
   the main paths' widths, must give the same bits; components and the
   supernode init agree with the CPU; a small stream through ``DynLP`` on
   the card agrees with the CPU.
3. First main path: ``DynLP`` (default backend, which must resolve to
   ``ell_cuda``) over a ``gaussian_mixture_stream`` of 5,000-vertex batches
   under the paper's 90/1/9 protocol (``--vertices``, 40,000 by default).
   The sweep kernel's launches must equal the sweeps; the last batch's
   solve, run again with ``backend="ref"``, must agree within 20·δ;
   accuracy against the ground truth must reach 0.99.
4. Second main path: ``StreamEngine(g, delta=1e-4, ingest="device")``
   (default backend) over the same stream at 100,000 vertices
   (``--stream-vertices``), batch t+1 submitted before batch t is drained.
   The backend must resolve to ``ell_cuda``; argkmin launches must equal
   the batches with insertions and sweep launches the sweeps; every batch
   must converge; accuracy must reach 0.99; after the first path's last
   batch the engine's graph arrays and committed labels must equal the
   first path's byte for byte (the streams share their prefix).  Per batch
   it prints the host graph update, the argkmin kernel's device time, the
   solve's time and how long ``submit`` took to return.
5. Timing at the second path's inputs: the last batch's solve is run again
   with every sweep's (F, frontier) kept; each sweep's kernel must give its
   plain version's bits; the kernel and its plain version are timed on
   every sweep, each beside its bound.  The last batch's argkmin inputs are
   timed through the kernel, its plain version and a three-call library
   yardstick (``matmul``, ``topk``, ``amax``), beside the bound.

The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.core import dynlp as dynlp_module  # noqa: E402
from repro_torch.core.components import connected_components  # noqa: E402
from repro_torch.core.dynlp import DynLP  # noqa: E402
from repro_torch.core.stream import StreamEngine  # noqa: E402
from repro_torch.core.init_labels import supernode_init  # noqa: E402
from repro_torch.data.synth import StreamSpec, accuracy, gaussian_mixture_stream  # noqa: E402
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph  # noqa: E402
from repro_torch.graph.knn import SELECT_MARGIN, normalize_rows, selection_slack  # noqa: E402
from repro_torch.graph.structures import coo_to_csr, csr_to_ell_fast  # noqa: E402
from repro_torch.ingest import incremental_knn  # noqa: E402
from repro_torch.kernels._build import load_library  # noqa: E402
from repro_torch.kernels import ops as ops_module  # noqa: E402
from repro_torch.kernels.argkmin import argkmin_candidates, argkmin_ref  # noqa: E402
from repro_torch.kernels.ell_propagate import ell_propagate_ref, ell_propagate_step  # noqa: E402
from repro_torch.kernels.ops import run_propagation, select_backend  # noqa: E402

DELTA = 1e-4
TOL = 20 * DELTA  # port vs port across backends/devices (the reference's own bound)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def _enqueue(calls):
    pairs = []
    for fn in calls:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    return pairs


def gpu_times(calls, per_sleep):
    """Device time (ms) of each call in ``calls``: CUDA events around each,
    queued behind a sleep so host launch time does not leak into the
    readings.  Each sleep holds ``per_sleep`` calls: the card's launch
    queue is finite, and a full one makes the host wait for the card to
    wake.  Each sleep is checked: if the card woke before the last call was
    queued, the readings could hold host time, so the sleep is doubled and
    those calls are queued again."""
    _enqueue(calls[:3])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _enqueue(calls)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(calls)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(1_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / max(s.elapsed_time(e), 1e-3)
    times = []
    for i in range(0, len(calls), per_sleep):
        chunk = calls[i:i + per_sleep]
        sleep_ms = 2 * host_ms * len(chunk) + 1
        while True:
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            awake = torch.cuda.Event()
            awake.record()
            pairs = _enqueue(chunk)
            queued_asleep = not awake.query()
            torch.cuda.synchronize()
            if queued_asleep:
                break
            require(sleep_ms < 2_000, "could not queue the timed calls behind a sleep")
            sleep_ms *= 2
        times += [s.elapsed_time(e) for s, e in pairs]
    return times


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
def sweep_inputs(rng, n, k, nf=None, pad_rows=0.0, dead_rows=0.0, frontier_p=0.6):
    """Random frontier-sweep inputs on the card (made with numpy)."""
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
    frontier = rng.random(n) < frontier_p
    f = rng.uniform(0, 1, nf).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (nbr, wgt, wl0, wl1, frontier, f)]


def check_sweep(name, args, delta=1e-3, row_offset=0):
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


def check_argkmin(name, inp):
    """The kernel against its plain version: values, ids and mask bitwise."""
    args, base, slack, k = inp["args"], inp["base"], inp["slack"], inp["k"]
    c, d = args[0].shape
    topk = min(k + SELECT_MARGIN, c)
    got = argkmin_candidates(*args, base, slack, k=k)
    want = argkmin_ref(*args, base, slack, topk=topk)
    torch.cuda.synchronize()
    fin = torch.isfinite(want[0])
    err = float((got[0][fin] - want[0][fin]).abs().max()) if bool(fin.any()) else 0.0
    same = [torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                        w.view(torch.int32) if w.dtype == torch.float32 else w)
            for g, w in zip(got, want)]
    print(f"   argkmin {name:<26} C={c:<6} D={d:<3} M={args[3].shape[0]:<5} TK={topk:<2} "
          f"bitwise val/idx/disp={same} finite={int(fin.sum())} disp={int(got[2].sum())}")
    require(all(same) and err == 0.0, f"argkmin {name}: kernel != plain version")
    return err


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
    inp = cases[2][1]  # every old valid row has an empty slot: all displaced
    old = inp["args"][1] & (torch.arange(1024, device="cuda") < inp["base"])
    require(torch.equal(argkmin_candidates(*inp["args"], inp["base"], inp["slack"],
                                           k=5)[2], old),
            "argkmin: the -inf kth rows are not exactly the displaced rows")

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
    return max(errs), max(argkmin_errs)


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
    return g, t + 1, launches


GRAPH = ("src", "dst", "wgt", "knn_idx", "knn_wgt")


def phase_stream(vertices, batch_size, ref_graph, ref_batches):
    """``StreamEngine(ingest="device")`` over the stream, batch t+1 submitted
    before batch t is drained.  Wrappers observe (and do not change) each
    batch's host graph update, argkmin launch and solve."""
    require(vertices >= ref_graph.num_nodes, "the engine's stream must cover the first path's")
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=42,
                      class_sep=6.0, noise=0.9)
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    eng = StreamEngine(g, delta=DELTA, ingest="device")
    per, solves, last, last_argkmin = {}, [], {}, {}
    cur = [0]
    real_apply = g.apply_batch

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
    stats, inserts, snap = [], 0, {}

    def report(i, st):
        stats.append(st)
        r = per[i]
        ak = r["argkmin"][0].elapsed_time(r["argkmin"][1]) if "argkmin" in r else 0.0
        print(f"   batch {i:2d}: submit {r['submit_ms']:8.1f} ms  host update "
              f"{r['apply_ms']:8.1f} ms (argkmin {ak:6.2f} ms)  solve {solves[i]:7.1f} ms  "
              f"iterations={st.iterations:4d} U={st.num_unlabeled:6d} (U,K)={st.bucket} "
              f"backend={st.backend} converged={st.converged}", flush=True)
        require(st.converged, f"engine batch {i} did not converge")
        require(st.backend == "ell_cuda", f"engine batch {i} ran on {st.backend!r}")
        if i == ref_batches - 1:  # the first path's last batch: compare
            for name in GRAPH:
                require(snap[name].tobytes() == getattr(ref_graph, name).tobytes(),
                        f"engine {name} != DynLP's after batch {i}")
            view = eng.committed_view()
            for name in ("f", "labels", "alive"):
                require(getattr(view, name).tobytes() == getattr(ref_graph, name).tobytes(),
                        f"engine committed {name} != DynLP's after batch {i}")
            print(f"   after batch {i} ({ref_graph.num_nodes} vertices): engine graph "
                  f"{'/'.join(GRAPH)} and committed labels == DynLP's, byte for byte")

    g.apply_batch = apply_batch
    incremental_knn.argkmin_candidates = argkmin_timed
    ops_module.run_propagation = solve_timed
    ell_propagate_step.launches = 0
    argkmin_candidates.launches = 0
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
        incremental_knn.argkmin_candidates = argkmin_candidates
        ops_module.run_propagation = run_propagation
    ell_launches, argkmin_launches = ell_propagate_step.launches, argkmin_candidates.launches
    sweeps = sum(st.iterations for st in stats)
    print(f"   batches={len(stats)} with insertions={inserts} argkmin launches="
          f"{argkmin_launches}; sweeps={sweeps} sweep-kernel launches={ell_launches}")
    require(argkmin_launches == inserts > 0, "argkmin launches != batches with insertions")
    require(ell_launches == sweeps > 0, "sweep-kernel launches != sweeps")
    require(len(solves) == len(stats) and all(s.backend == "ell_cuda" for s in stats),
            "a batch skipped its solve")
    # submit(t) returns once batch t is staged and its solve queued; it
    # waits only for batch t-1's solve (its drain), never for its own
    sub = np.array([per[i]["submit_ms"] for i in range(len(stats))])
    upd = np.array([per[i]["apply_ms"] for i in range(len(stats))])
    print(f"   per batch, median (max): submit returned in {np.median(sub):.1f} "
          f"({sub.max():.1f}) ms, of which host update {np.median(upd):.1f} "
          f"({upd.max():.1f}) ms; its own solve then ran {np.median(solves):.1f} "
          f"({max(solves):.1f}) ms behind it; store {eng.ingestor.store.capacity} rows, "
          f"{eng.ingestor.store.device_bytes() / 1e6:.1f} MB on the card")

    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    require(np.isfinite(g.f[ids]).all(), "non-finite labels")
    acc = accuracy((g.f[ids] >= 0.5).astype(np.int8), truth[ids])
    print(f"   accuracy vs ground truth: {acc:.4f} over {len(ids)} vertices")
    require(acc >= 0.99, f"accuracy {acc} < 0.99")
    return dict(last=last, argkmin=last_argkmin, ell_launches=ell_launches,
                argkmin_launches=argkmin_launches)


def phase_timing(last):
    """The kernel and its plain version at the main path's inputs: every
    sweep of the last batch's solve, kept from a second run of that solve."""
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
    by = "bytes" if all(b[1] == "bytes" for b in bounds) else "operations"
    # the record is per launch, averaged over the batch's sweeps
    m = len(sweeps)
    return dict(ms=sum(k_ms) / m, plain_ms=sum(p_ms) / m, bound_ms=sum(b_ms) / m,
                max_abs_err=err, bound_by=by)


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
    wide = argkmin_inputs(np.random.default_rng(7), c, 128, m, base + m,
                          real=int(args[4].sum()))
    w_ms = statistics.median(gpu_times(
        [lambda: argkmin_candidates(*wide["args"], wide["base"], wide["slack"], k=5)] * 10,
        per_sleep=10))
    wb = argkmin_bound(wide)
    print(f"   argkmin at D=128, same C and M: kernel {w_ms:.3f} ms  bound {wb[0]:.4f} ms "
          f"({wb[2] / 1e9:.1f} GFLOP, {wb[1]})  kernel/bound {w_ms / wb[0]:.2f}x")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=by,
                max_abs_err=err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the first path's host kNN (numpy, O(N^2) over a stream) takes most of
    # its time, so it stops at 40,000 vertices; the second path, with the
    # candidate search on the card, runs the full 100,000
    ap.add_argument("--vertices", type=int, default=40_000)
    ap.add_argument("--stream-vertices", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=5_000)
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
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   nvcc: {line.strip()}")
    with Phase("kernels vs plain versions on the card"):
        sweep_err, argkmin_err = phase_kernels()
    with Phase("main path 1: DynLP.step over the stream"):
        dyn_graph, dyn_batches, dyn_launches = phase_main(args.vertices, args.batch)
    with Phase("main path 2: StreamEngine(ingest='device') over the stream"):
        out = phase_stream(args.stream_vertices, args.batch, dyn_graph, dyn_batches)
    with Phase("timing at the main path's shapes"):
        tm = phase_timing(out["last"])
        ta = phase_argkmin_timing(out["argkmin"])
    record = {"kernels": [{
        "name": "ell_propagate_step", "route": "cuda",
        "source": "src/repro_torch/csrc/ell_propagate.cu",
        "replaces": "src/repro/kernels/ell_propagate.py:58",
        "launches": out["ell_launches"], "max_abs_err": max(sweep_err, tm["max_abs_err"]),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None,
    }, {
        "name": "argkmin", "route": "cuda",
        "source": "src/repro_torch/csrc/argkmin.cu",
        "replaces": "src/repro/kernels/argkmin.py:117",
        "launches": out["argkmin_launches"],
        "max_abs_err": max(argkmin_err, ta["max_abs_err"]),
        "ms": ta["ms"], "plain_ms": ta["plain_ms"], "bound_ms": ta["bound_ms"],
        "bound_by": ta["bound_by"], "library_ms": ta["library_ms"],
    }]}
    print(f"   DynLP path: {dyn_launches} sweep-kernel launches; engine path: "
          f"{out['ell_launches']} sweep-kernel and {out['argkmin_launches']} argkmin launches")
    print(f"   total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
