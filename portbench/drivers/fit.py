"""The ``fit`` driver: whole-corpus fits through the estimator, back to back.

Each fit is what ``DynLabelPropagation.fit(X, y)`` does for a user and the
paper's protocol for its large-scale runs (Fig. 5, Table 3): a fresh graph,
every vertex in one batch with its share of ground truth, through
``LPService.add_points`` and ``sync`` to ``StreamEngine.submit`` and
``drain`` (device ingest, the argkmin kernel, the graph update, the
snapshot, the frontier solve).  The service would refuse one mutation of N
operations under its default ``max_pending_ops``; the configuration's
``service_opts`` raise it to the corpus.

The window starts whole fits until ``seconds`` have passed, finishes the one
in flight, and keeps every fit's outputs (lists, weights, committed scores
and predictions) for the check.  Set-up makes the corpus and runs one fit
at full size, which builds or loads the kernels and warms every shape the
window uses.

The check of a fit (``reference``, ``readings``): the plain reference
(``portbench.reference``) works the fit out again from the corpus alone,
the exact kNN lists under the configuration's weight and the label fixed
point of the problem those lists make, and each fit is read by two numbers:

* ``knn_gap``, the graph (device ingest and the graph update): for every
  vertex, the listed neighbours' weights as the reference works them out,
  sorted, against the reference's own top k, and against the weights the
  program stored; the largest difference.  A list that is short, repeats a
  vertex, names itself or one out of range, or a graph of the wrong size
  reads 1.
* ``label_gap``, the labels (the snapshot and the frontier solve): over the
  unlabeled vertices whose score the problem fixes, the largest of
  |F - F*| and of how far F* lies on the wrong side of the cut-off from the
  committed prediction; a seed whose score or prediction is not its label
  reads 1.

The control (``reference(..., control=True)``, ``control_outputs``) is the
same reference in the nearest precision below the one the configuration
states, the kNN search in TF32 and the fixed point in bfloat16, put in the
program's place.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.generator import Corpus, make_corpus
from portbench.reference.knn import canonical_weights, exact_knn, normalize_rows
from portbench.reference.propagation import UNLABELED, build_problem, fixed_point

CUTOFF = 0.5  # the estimator's decision threshold


@dataclasses.dataclass
class FitOutput:
    knn_idx: np.ndarray  # (N, k) int64
    knn_wgt: np.ndarray  # (N, k) float32
    f: np.ndarray  # (N,) float32 committed scores
    pred: np.ndarray  # (N,) int8 committed predictions (transduction_)
    num_nodes: int


@dataclasses.dataclass
class Window:
    items: int  # fits completed
    units: int  # vertices fitted
    seconds: float  # from the window's start to the last fit's commit
    t0: int  # perf_counter_ns
    t1: int
    item_s: list  # each fit's seconds
    outputs: list


class FitDriver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.inputs: Corpus = make_corpus(cfg, mix, seed)

    def estimator(self):
        from repro_torch.serving.estimator import DynLabelPropagation

        c = self.cfg
        return DynLabelPropagation(
            k=c["k"], delta=c["delta"], ingest=c["ingest"],
            engine_opts=dict(c["engine_opts"], max_k=c["max_k"], device=self.device),
            service_opts=c["service_opts"])

    def fit_once(self) -> FitOutput:
        clf = self.estimator()
        clf.fit(self.inputs.x, self.inputs.y)
        g = clf.graph_
        out = FitOutput(knn_idx=g.knn_idx, knn_wgt=g.knn_wgt,
                        f=clf.engine_.committed_view().f, pred=clf.transduction_,
                        num_nodes=g.num_nodes)
        clf.engine_.close()
        return out

    def warm(self) -> None:
        self.fit_once()

    def window(self, seconds: float, log) -> Window:
        outputs, item_s = [], []
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        t1 = t0
        while t1 < end:
            log.item = len(outputs)
            s0 = time.perf_counter_ns()
            outputs.append(self.fit_once())
            t1 = time.perf_counter_ns()
            log.add("fit", s0, t1)
            item_s.append((t1 - s0) / 1e9)
        log.item = None
        n = len(self.inputs.y)
        return Window(items=len(outputs), units=n * len(outputs), seconds=(t1 - t0) / 1e9,
                      t0=t0, t1=t1, item_s=item_s, outputs=outputs)


def make(cfg: dict, mix: dict, seed: int, device: str) -> FitDriver:
    return FitDriver(cfg, mix, seed, device)


# ---------------------------------------------------------------------- #
# the check of a fit
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class Reference:
    xh: np.ndarray  # (N, D) normalized corpus
    idx: np.ndarray  # (N, k) exact lists
    wgt: np.ndarray  # (N, k)
    y: np.ndarray  # (N,) seeds
    unl_ids: np.ndarray  # (U,)
    f: np.ndarray  # (U,) fixed point
    determined: np.ndarray  # (U,)
    info: dict


def reference(corpus: Corpus, cfg: dict, device: str, *, control: bool = False) -> Reference:
    """The reference's answer for a corpus; ``control=True`` computes it in
    the lower precisions (TF32 kNN, bfloat16 fixed point)."""
    x, y = corpus.x, corpus.y
    knn = exact_knn(x, cfg["k"], device=device, precision="tf32" if control else "float32")
    prob = build_problem(knn.idx, knn.wgt, y, cfg["max_k"])
    sol = fixed_point(prob, device=device)
    info = dict(widened=knn.widened, jacobi_sweeps=sol.iterations,
                jacobi_residual=sol.residual, undetermined=int((~sol.determined).sum()))
    if control:
        low = fixed_point(prob, device=device, dtype=torch.bfloat16,
                          max_iters=sol.iterations)
        sol = dataclasses.replace(sol, f=low.f)
    return Reference(xh=normalize_rows(x), idx=knn.idx, wgt=knn.wgt, y=y,
                     unl_ids=prob.unl_ids, f=sol.f, determined=sol.determined, info=info)


def knn_gap(ref: Reference, idx: np.ndarray, wgt: np.ndarray, num_nodes: int) -> float:
    n, k = ref.idx.shape
    if num_nodes != n or idx.shape != (n, k) or wgt.shape != (n, k):
        return 1.0
    rows = np.arange(n)[:, None]
    bad = (idx < 0) | (idx >= n) | (idx == rows)
    srt = np.sort(idx, axis=1)
    bad[:, 1:] |= srt[:, 1:] == srt[:, :-1]
    if bad.any():
        return 1.0
    gap = 0.0
    step = 1 << 16
    for lo in range(0, n, step):
        i = idx[lo:lo + step]
        w = canonical_weights(ref.xh[lo:lo + step][:, None, :], ref.xh[i])
        listed = -np.sort(-w, axis=1)
        gap = max(gap, float(np.abs(listed - ref.wgt[lo:lo + step]).max()),
                  float(np.abs(w - wgt[lo:lo + step]).max()))
    return gap


def label_gap(ref: Reference, f: np.ndarray, pred: np.ndarray) -> float:
    n = len(ref.y)
    if len(f) != n or len(pred) != n:
        return 1.0
    seeds = ref.y != UNLABELED
    if ((f[seeds] != ref.y[seeds]).any() or (pred[seeds] != ref.y[seeds]).any()):
        return 1.0
    u = ref.unl_ids[ref.determined]
    fs = ref.f[ref.determined]
    p = pred[u]
    if not np.isin(p, (0, 1)).all():
        return 1.0
    wrong_side = np.where(p == 1, CUTOFF - fs, fs - CUTOFF)
    gap = np.maximum(np.abs(f[u].astype(np.float64) - fs), wrong_side)
    return float(gap.max()) if len(gap) else 0.0


def readings(ref: Reference, out: FitOutput) -> dict:
    """The numbers compared for one fit's outputs."""
    return {"knn_gap": knn_gap(ref, out.knn_idx, out.knn_wgt, out.num_nodes),
            "label_gap": label_gap(ref, out.f, out.pred)}


def control_outputs(ctl: Reference, corpus: Corpus) -> list[FitOutput]:
    """The control's answer in the form of the window's outputs."""
    f = ctl.y.astype(np.float32)
    f[ctl.unl_ids] = ctl.f
    pred = np.where(ctl.y != UNLABELED, ctl.y, (f >= CUTOFF).astype(np.int8)).astype(np.int8)
    return [FitOutput(knn_idx=ctl.idx, knn_wgt=ctl.wgt, f=f, pred=pred,
                      num_nodes=len(corpus.y))]
