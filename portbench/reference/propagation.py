"""The label fixed point of a fit: the plain reference for the labels it commits.

NumPy and plain PyTorch only; nothing of the program is imported.  The
problem is the one the configuration states (paper Alg. 2, the supernode
form):

* the graph is the union of the kNN lists, each edge once with its weight,
  both directions;
* a seed (label 0 or 1) is fixed; every other vertex u has the score

      F_u = (wl1_u + sum_v w_uv F_v) / (sum_v w_uv + wl0_u + wl1_u)

  where v runs over u's unlabeled neighbours and wl0_u, wl1_u sum the weights
  of u's edges to seeds of label 0 and 1;
* a vertex with more than ``max_k`` unlabeled neighbours keeps the ``max_k``
  heaviest (ties to the lower id): the ELL width the configuration caps.

``fixed_point`` solves that system by Jacobi sweeps in float64 until no score
moves by more than ``TOL``; ``dtype=torch.bfloat16`` is the control of
``portbench.check``: each sweep's scores rounded to bfloat16, until they stop
moving.  A vertex from which no path of list edges reaches a seed has no
unique score (``determined`` is False there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

UNLABELED = -1


@dataclasses.dataclass
class Problem:
    unl_ids: np.ndarray  # (U,) global ids of the unlabeled vertices
    nbr: np.ndarray  # (U, K) int64 compact neighbour rows, -1 empty
    wgt: np.ndarray  # (U, K) float64
    wl0: np.ndarray  # (U,) float64
    wl1: np.ndarray  # (U,) float64


@dataclasses.dataclass
class Solution:
    f: np.ndarray  # (U,) float64 scores of the unlabeled vertices
    determined: np.ndarray  # (U,) bool: a path of list edges reaches a seed
    iterations: int
    residual: float  # max |dF| of the last sweep over determined rows


def build_problem(idx: np.ndarray, wgt: np.ndarray, labels: np.ndarray,
                  max_k: int | None) -> Problem:
    """The supernode problem of the kNN graph ``(idx, wgt)`` (N, k) under
    ``labels`` (N,) int8 (-1 unlabeled)."""
    n, k = idx.shape
    a = np.repeat(np.arange(n, dtype=np.int64), k)
    b = idx.ravel()
    w = wgt.ravel().astype(np.float64)
    ok = b >= 0
    a, b, w = a[ok], b[ok], w[ok]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    _, first = np.unique(lo * np.int64(n) + hi, return_index=True)
    lo, hi, w = lo[first], hi[first], w[first]
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    w = np.concatenate([w, w])

    unl = labels == UNLABELED
    unl_ids = np.flatnonzero(unl)
    remap = np.full(n, -1, np.int64)
    remap[unl_ids] = np.arange(len(unl_ids))
    u = len(unl_ids)
    s_unl = unl[src]

    lab = labels[dst]
    wl0 = np.zeros(u)
    wl1 = np.zeros(u)
    to0 = s_unl & (lab == 0)
    to1 = s_unl & (lab == 1)
    np.add.at(wl0, remap[src[to0]], w[to0])
    np.add.at(wl1, remap[src[to1]], w[to1])

    uu = s_unl & unl[dst]
    rs, cs, ws = remap[src[uu]], remap[dst[uu]], w[uu]
    order = np.lexsort((cs, -ws, rs))  # per row: heaviest first, ties to the lower id
    rs, cs, ws = rs[order], cs[order], ws[order]
    deg = np.bincount(rs, minlength=u)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(rs)) - np.repeat(start, deg)
    width = int(deg.max()) if u else 1
    if max_k is not None:
        width = min(width, max_k)
    keep = slot < width
    nbr = np.full((u, max(width, 1)), -1, np.int64)
    wmat = np.zeros((u, max(width, 1)))
    nbr[rs[keep], slot[keep]] = cs[keep]
    wmat[rs[keep], slot[keep]] = ws[keep]
    return Problem(unl_ids=unl_ids, nbr=nbr, wgt=wmat, wl0=wl0, wl1=wl1)


def determined(p: Problem) -> np.ndarray:
    """(U,) bool: a path of neighbour-row edges leads from the row to a seed."""
    mask = p.nbr >= 0
    idx = np.where(mask, p.nbr, 0)
    det = (p.wl0 + p.wl1) > 0
    while True:
        grown = det | (det[idx] & mask).any(axis=1)
        if (grown == det).all():
            return det
        det = grown


def residual(p: Problem, f: np.ndarray) -> np.ndarray:
    """(U,) |F_u - T(F)_u| in float64 for the scores ``f`` (U,) of the
    unlabeled vertices, T the right-hand side of the system above: how far
    ``f`` is from solving it (0 on a row with no edge)."""
    f = np.asarray(f, np.float64)
    mask = p.nbr >= 0
    wall = p.wgt.sum(axis=1) + p.wl0 + p.wl1
    rhs = p.wl1 + (p.wgt * np.where(mask, f[np.where(mask, p.nbr, 0)], 0.0)).sum(axis=1)
    return np.where(wall > 0, np.abs(rhs / np.where(wall > 0, wall, 1.0) - f), 0.0)


TOL = 1e-12  # float64 sweeps stop once no determined score moves more
CHECK_EVERY = 64  # sweeps between two looks at the residual (a host sync)


def fixed_point(p: Problem, *, device="cpu", dtype=torch.float64,
                max_iters: int = 200_000) -> Solution:
    """Jacobi sweeps from F = 0.5 until no determined score moves by more
    than ``TOL`` (float64), or until none moves at all (lower precisions)."""
    nbr = torch.from_numpy(p.nbr).to(device)
    mask = nbr >= 0
    idx = torch.where(mask, nbr, torch.zeros_like(nbr))
    w = torch.from_numpy(p.wgt).to(device=device, dtype=torch.float64)
    wl0 = torch.from_numpy(p.wl0).to(device)
    wl1 = torch.from_numpy(p.wl1).to(device)
    wall = w.sum(dim=1) + wl0 + wl1
    live = wall > 0
    inv = torch.where(live, 1.0 / torch.where(live, wall, 1.0), 0.0)

    det = torch.from_numpy(determined(p)).to(device)

    f = torch.full((len(p.wl0),), 0.5, dtype=dtype, device=device)
    it = 0
    resid = float("inf")
    exact = dtype == torch.float64
    while it < max_iters:
        for _ in range(CHECK_EVERY):
            f64 = f.to(torch.float64)
            new = torch.where(live, (wl1 + (w * f64[idx]).sum(dim=1)) * inv, f64).to(dtype)
            step = (new.to(torch.float64) - f64).abs()
            f = new
            it += 1
        resid = float(torch.where(det, step, 0.0).max()) if len(step) else 0.0
        if resid <= (TOL if exact else 0.0):
            break
    return Solution(f=f.to(torch.float64).cpu().numpy(), determined=det.cpu().numpy(),
                    iterations=it, residual=resid)
