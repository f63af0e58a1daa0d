"""The ``stream`` driver: the corpus streamed through ``LPService`` as batches.

A pass is what a service that keeps a review stream labelled does from an
empty graph: one client hands the stream's batches Δ_t (``generator.
make_stream``: insertions, their seeds, deletions) to ``LPService.mutate``
one by one.  The configuration's ``service_opts`` close an admission window
on each Δ_t alone, so each is admitted (``StreamEngine.submit``: device
ingest, the graph update with its deletions and flagged-row merges, the
snapshot, G', the supernode init) as it is enqueued, and the next is
enqueued as soon as that call returns: its submit drains the solve of the
one before, which ran on the card meanwhile (pipelined, closed loop).  The
last Δ_t commits at ``sync``.

The window runs whole passes back to back, each on a fresh service, until
``seconds`` have passed: it finishes the pass in flight, as a fit window
finishes its fit, so every window holds the same Δ_t (at today's speed one
pass, longer than 51 s).  A Δ_t's commit time is from the call that
enqueued it to the return of the call after which the driver sees it
committed (host clock, ``commit_ms``); ``units`` are the inserted vertices
of the committed Δ_t.  Set-up makes the stream and runs one whole pass,
which builds or loads the kernels and meets every shape the window meets.

For the check the driver keeps, of every Δ_t in the window, a copy of the
program's lists right after its ``apply_batch`` (the graph is a subclass of
the program's ``DynamicGraph`` that copies them; the copies run inside the
window, and their time goes to standard error) and the committed ``LabelView``
that holds it.  ``reference`` replays the stream with the plain reference
(``portbench.reference.stream``), and ``readings`` reads every Δ_t by two
numbers:

* ``knn_gap``, the fit's: for every live vertex, the listed neighbours'
  weights as the reference works them out, sorted, against the replay's
  list, and against the weights the program stored; the largest
  difference.  A graph of the wrong size or liveness, a list that names a
  dead vertex, itself, one vertex twice or one out of range, or holds
  another number of entries than the replay's reads 1.
* ``label_residual``: over the live unlabeled vertices whose score the
  problem of that Δ_t's replayed lists determines, the largest
  |F_u − T(F)_u|, T the problem's right-hand side
  (``reference.propagation.residual``): how far the committed scores are
  from solving it.  A view of other vertices or seeds, a seed off its
  label, or a prediction (``LabelView.query``, after the window) off its
  score's side of the 0.5 cut-off reads 1.  The fit's distance from the
  fixed point does not separate the control from sound runs here: on the
  first, small graphs a δ-stopped solve lies farther from it than a
  bfloat16 one (``PERF.md`` §2).

The control (``reference(..., control=True)``, ``control_outputs``) is the
same replay with every weight from a TF32 product and the fixed points in
bfloat16, put in the program's place.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from portbench.generator import UNLABELED, Stream, make_stream
from portbench.reference.knn import canonical_weights, normalize_rows
from portbench.reference.propagation import (Problem, build_problem, determined,
                                             fixed_point, residual)
from portbench.reference.stream import Step, replay

CUTOFF = 0.5  # the service's decision threshold


@dataclasses.dataclass
class DeltaOutput:
    t: int  # the Δ_t's index in its pass
    idx: np.ndarray  # (n, k) int64 the program's lists after the Δ_t
    wgt: np.ndarray  # (n, k) float32
    alive: np.ndarray  # (n,) bool
    view: object = None  # the committed LabelView that holds it, until the window ends
    f: np.ndarray | None = None  # (n,) its committed scores
    pred: np.ndarray | None = None  # (n,) its predictions
    labels: np.ndarray | None = None  # (n,) its seeds
    view_alive: np.ndarray | None = None


@dataclasses.dataclass
class Window:
    items: int  # Δ_t committed
    units: int  # vertices they inserted
    seconds: float  # from the window's start to the last commit
    t0: int  # perf_counter_ns
    t1: int
    item_s: list  # each Δ_t's enqueue call, seconds
    outputs: list
    commit_ms: list  # each Δ_t's enqueue-to-commit time


def _kept_graph():
    """The program's graph class, with a copy of the lists kept after each
    batch."""
    from repro_torch.graph.dynamic import DynamicGraph

    class KeptGraph(DynamicGraph):
        def __init__(self, *args, kept: list, **kwargs):
            super().__init__(*args, **kwargs)
            self.kept = kept
            self.keep_ns = 0

        def apply_batch(self, *args, **kwargs):
            effect = super().apply_batch(*args, **kwargs)
            t = time.perf_counter_ns()
            self.kept.append((self.knn_idx.copy(), self.knn_wgt.copy(), self.alive.copy()))
            self.keep_ns += time.perf_counter_ns() - t
            return effect

    return KeptGraph


class StreamDriver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.device = cfg, device
        self.inputs: Stream = make_stream(cfg, mix, seed)
        self._graph = _kept_graph()

    def service(self, kept: list):
        from repro_torch.core.stream import StreamEngine
        from repro_torch.serving.lp_service import LPService

        c = self.cfg
        g = self._graph(self.inputs.x.shape[1], k=c["k"], kept=kept)
        engine = StreamEngine(g, delta=c["delta"], ingest=c["ingest"],
                              **dict(c["engine_opts"], max_k=c["max_k"], device=self.device))
        return LPService(engine, cutoff=CUTOFF, **c["service_opts"])

    def one_pass(self, log, rec: dict) -> None:
        """Stream Δ_0, Δ_1, ... to the stream's end on a fresh service, then
        sync; what it observes goes to ``rec`` (outputs, commit times,
        enqueue seconds, copy time)."""
        s = self.inputs
        kept: list = []
        t0 = time.perf_counter_ns()
        svc = self.service(kept)
        log.add("stream.new_service", t0, time.perf_counter_ns())
        waiting = []  # (t, ticket, enqueued at)
        try:
            for t, (lo, hi) in enumerate(s.bounds):
                e0 = time.perf_counter_ns()
                ticket = svc.mutate(ins_emb=s.x[lo:hi], ins_labels=s.labels[t],
                                    del_ids=s.dels[t])
                e1 = time.perf_counter_ns()
                log.add("stream.mutate", e0, e1)
                rec["item_s"].append((e1 - e0) / 1e9)
                waiting.append((t, ticket, e0))
                waiting = self._observe(svc, waiting, e1, kept, rec)
            e0 = time.perf_counter_ns()
            svc.sync()
            e1 = time.perf_counter_ns()
            log.add("stream.sync", e0, e1)
            self._observe(svc, waiting, e1, kept, rec)
        finally:
            svc.engine.close()
        rec["keep_ns"] += svc.engine.graph.keep_ns

    def _observe(self, svc, waiting, now: int, kept: list, rec: dict) -> list:
        """Record the Δ_t seen committed at ``now``; returns those still waiting."""
        left = []
        for t, ticket, e0 in waiting:
            if not ticket.committed:
                left.append((t, ticket, e0))
                continue
            rec["commit_ms"].append((now - e0) / 1e6)
            rec["units"] += len(self.inputs.labels[t])
            idx, wgt, alive = kept[t]
            kept[t] = None
            rec["outputs"].append(DeltaOutput(t=t, idx=idx, wgt=wgt, alive=alive,
                                              view=svc.committed_view()))
        return left

    def warm(self) -> None:
        from portbench.spans import SpanLog

        self.one_pass(SpanLog(), _record())

    def window(self, seconds: float, log) -> Window:
        rec = _record()
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        log.item = 0
        passes = 0
        while True:
            self.one_pass(log, rec)
            passes += 1
            log.item = len(rec["outputs"])
            if time.perf_counter_ns() >= end:
                break
        t1 = time.perf_counter_ns()
        log.item = None
        print(f"stream: {passes} pass(es), the list copies kept for the check "
              f"{rec['keep_ns'] / 1e9:.4f} s of the window", file=sys.stderr)
        outputs = rec["outputs"]
        for o in outputs:  # the predictions: the program's own query of the view
            o.pred, _ = o.view.query(np.arange(len(o.view.labels), dtype=np.int64), CUTOFF)
            o.f, o.labels, o.view_alive, o.view = o.view.f, o.view.labels, o.view.alive, None
        return Window(items=len(outputs), units=rec["units"], seconds=(t1 - t0) / 1e9,
                      t0=t0, t1=t1, item_s=rec["item_s"], outputs=outputs,
                      commit_ms=rec["commit_ms"])


def _record() -> dict:
    return {"outputs": [], "commit_ms": [], "item_s": [], "units": 0, "keep_ns": 0}


def make(cfg: dict, mix: dict, seed: int, device: str) -> StreamDriver:
    return StreamDriver(cfg, mix, seed, device)


# ---------------------------------------------------------------------- #
# the check of a stream
# ---------------------------------------------------------------------- #
class Reference:
    """The replay's graph after each Δ_t, its problem, and (for the control)
    the fixed point of that problem, each worked out when first asked for."""

    def __init__(self, stream: Stream, cfg: dict, device: str, control: bool):
        self.cfg, self.device, self.control = cfg, device, control
        self.xh = normalize_rows(stream.x)
        self._replay = replay(stream.x, stream.bounds, stream.labels, stream.dels, cfg["k"],
                              device=device, precision="tf32" if control else "float32")
        self._steps: list[Step] = []
        self.info = {"steps": 0, "problems": 0, "undetermined_max": 0,  # and each Δ_t's
                     "knn_gap_by_t": {}, "label_residual_by_t": {}}  # worst readings

    def step(self, t: int) -> Step:
        while len(self._steps) <= t:
            self._steps.append(next(self._replay))
            self.info["steps"] += 1
        return self._steps[t]

    def problem(self, t: int) -> tuple[np.ndarray, Problem, np.ndarray]:
        """(global ids of the unlabeled rows, the problem of Δ_t's live
        lists, which rows it determines)."""
        st = self.step(t)
        live = np.flatnonzero(st.alive)
        remap = np.full(len(st.alive), -1, np.int64)
        remap[live] = np.arange(len(live))
        i = st.idx[live]
        prob = build_problem(np.where(i >= 0, remap[np.maximum(i, 0)], -1), st.wgt[live],
                             st.labels[live], self.cfg["max_k"])
        det = determined(prob)
        self.info["problems"] += 1
        self.info["undetermined_max"] = max(self.info["undetermined_max"], int((~det).sum()))
        return live[prob.unl_ids], prob, det

    def fixed(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """(global ids, scores) of Δ_t's unlabeled rows: the fixed point, in
        bfloat16 under the control, stopped after the float64 solve's sweeps."""
        ids, prob, _ = self.problem(t)
        sol = fixed_point(prob, device=self.device)
        if self.control:
            sol = fixed_point(prob, device=self.device, dtype=torch.bfloat16,
                              max_iters=sol.iterations)
        return ids, sol.f


def reference(stream: Stream, cfg: dict, device: str, *, control: bool = False) -> Reference:
    """The replay of the stream; ``control=True`` in the lower precisions
    (TF32 weights, bfloat16 fixed points)."""
    return Reference(stream, cfg, device, control)


def knn_gap(ref: Reference, o: DeltaOutput) -> float:
    st = ref.step(o.t)
    n, k = st.idx.shape
    if o.idx.shape != (n, k) or o.wgt.shape != (n, k) or o.alive.shape != (n,):
        return 1.0
    if (o.alive != st.alive).any():
        return 1.0
    live = np.flatnonzero(st.alive)
    idx, wgt, ri, rw = o.idx[live], o.wgt[live], st.idx[live], st.wgt[live]
    valid = idx >= 0
    if (valid.sum(axis=1) != (ri >= 0).sum(axis=1)).any():
        return 1.0
    safe = np.where(valid & (idx < n), idx, 0)
    bad = valid & ((idx >= n) | (idx == live[:, None]) | ~st.alive[safe])
    srt = np.sort(np.where(valid, idx, -1 - np.arange(k)), axis=1)
    bad[:, 1:] |= srt[:, 1:] == srt[:, :-1]
    if bad.any():
        return 1.0
    # a row that lists what the replay lists, in its order, lists its
    # weights; the others are worked out again
    differs = (idx != ri).any(axis=1)
    same = valid & ~differs[:, None]
    gap = float(np.abs(np.where(same, wgt - rw, 0)).max()) if len(live) else 0.0
    other = np.flatnonzero(differs)
    step = 1 << 16
    for lo in range(0, len(other), step):
        r = other[lo:lo + step]
        v = valid[r]
        w = canonical_weights(ref.xh[live[r]][:, None, :], ref.xh[safe[r]])
        listed = -np.sort(-np.where(v, w, -np.inf), axis=1)
        ok = np.isfinite(listed)
        gap = max(gap, float(np.abs(np.where(ok, listed, 0) - np.where(ok, rw[r], 0)).max()),
                  float(np.abs(np.where(v, w - wgt[r], 0)).max()))
    return gap


def label_residual(ref: Reference, o: DeltaOutput) -> float:
    st = ref.step(o.t)
    n = len(st.alive)
    if any(a is None or a.shape != (n,) for a in (o.f, o.pred, o.labels, o.view_alive)):
        return 1.0
    live = st.alive
    if (o.view_alive != live).any() or (o.labels[live] != st.labels[live]).any():
        return 1.0
    seeds = live & (st.labels != UNLABELED)
    if (o.f[seeds] != st.labels[seeds]).any() or (o.pred[seeds] != st.labels[seeds]).any():
        return 1.0
    unl = live & (st.labels == UNLABELED)
    if (o.pred[unl] != (o.f[unl] >= CUTOFF)).any():
        return 1.0
    ids, prob, det = ref.problem(o.t)
    res = residual(prob, o.f[ids])[det]
    return float(res.max()) if len(res) else 0.0


def readings(ref: Reference, o: DeltaOutput) -> dict:
    """The numbers compared for one Δ_t's outputs."""
    out = {"knn_gap": knn_gap(ref, o), "label_residual": label_residual(ref, o)}
    for name, v in out.items():
        by_t = ref.info[f"{name}_by_t"]
        by_t[o.t] = max(by_t.get(o.t, 0.0), float(f"{v:.6g}"))
    return out


def control_outputs(ctl: Reference, stream: Stream) -> list[DeltaOutput]:
    """The control's answer in the form of a whole pass's outputs."""
    out = []
    for t in range(len(stream)):
        st = ctl.step(t)
        ids, fs = ctl.fixed(t)
        f = np.where(st.labels == 1, 1.0, 0.0).astype(np.float32)
        f[ids] = fs
        pred = np.where(st.labels != UNLABELED, st.labels,
                        (f >= CUTOFF).astype(np.int8)).astype(np.int8)
        pred[~st.alive] = UNLABELED
        out.append(DeltaOutput(t=t, idx=st.idx, wgt=st.wgt, alive=st.alive, f=f, pred=pred,
                               labels=st.labels, view_alive=st.alive))
    return out
