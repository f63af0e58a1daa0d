"""The dynamic kNN graph of a stream: the plain reference for a stream's lists.

NumPy and plain PyTorch only; nothing of the program is imported.  The
replay keeps, for every vertex, the list the configuration's guarantees
define, batch after batch (``configs/imdb-50k.json``):

* deletions first: a deleted vertex is gone, and so is every list entry
  that pointed at it; a surviving row keeps its other entries in order and
  the hole stays at its tail.  An id that is dead or was never handed out
  deletes nothing;
* each inserted vertex takes the next global id and lists its ``k`` most
  similar live vertices, the batch's own included, in the order (weight
  desc, id asc), with the weight of ``reference.knn.canonical_weights``;
* each surviving row merges the batch's new vertices into its list: the top
  ``k`` of both in the same order.

A new row's list is ``reference.knn.knn_lists`` over the live vertices:
the fit's exhaustive search restricted to them.  A surviving row's merge
considers the new vertices whose float32 product cosine (TF32 off), plus
``COS_SLACK``, could reach its k-th weight (every new vertex where the row
has a hole), and works out their weights by the canonical formula.  On a
tie with the k-th entry an older id wins, so no other new vertex can enter.

``precision="tf32"`` is the control of ``portbench.check``: the same
replay with every weight taken from a product of the normalized rows
rounded to TF32, as a TF32 matrix unit would give it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.knn import (COS_SLACK, canonical_weights, knn_lists, no_tf32,
                                     normalize_rows, round_tf32)

_BLOCK_ELEMS = 2**28  # (rows, columns) products per block on the device


@dataclasses.dataclass
class Step:
    """The graph after one batch (global ids, ``n`` vertices handed out)."""

    idx: np.ndarray  # (n, k) int64, -1 in a hole or a dead row
    wgt: np.ndarray  # (n, k) float32, -inf there
    alive: np.ndarray  # (n,) bool
    labels: np.ndarray  # (n,) int8: 0/1 seeds, -1 elsewhere


def _sort_rows(idx: np.ndarray, wgt: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Each row's top ``k`` under (weight desc, id asc), -1/-inf entries last,
    padded with them to ``k`` columns."""
    key_w = np.where(idx >= 0, -wgt.astype(np.float64), np.inf)
    key_i = np.where(idx >= 0, idx, np.iinfo(np.int64).max)
    order = np.lexsort((key_i, key_w), axis=-1)[:, :k]
    out_i = np.full((len(idx), k), -1, np.int64)
    out_w = np.full((len(idx), k), -np.inf, np.float32)
    out_i[:, :order.shape[1]] = np.take_along_axis(idx, order, 1)
    out_w[:, :order.shape[1]] = np.take_along_axis(wgt, order, 1)
    return out_i, out_w


def _blocks(q: torch.Tensor, e: torch.Tensor, tf32: bool):
    """Blocks of ``q @ e.T`` in float32 (TF32 off; under ``tf32`` the rows
    rounded to TF32 first), on their device: yields (row offset, block)."""
    if tf32:
        e, q = round_tf32(e), round_tf32(q)
    block = max(1, _BLOCK_ELEMS // max(1, e.shape[0]))
    for lo in range(0, q.shape[0], block):
        with no_tf32():
            out = q[lo:lo + block] @ e.T
        yield lo, out


def _weights32(cos: torch.Tensor) -> torch.Tensor:
    return (cos + 1.0) * 0.5  # float32: a TF32 unit's weight


def _merge(xh: np.ndarray, e: torch.Tensor, old: np.ndarray, new: np.ndarray,
           idx: np.ndarray, wgt: np.ndarray, k: int, tf32: bool) -> None:
    """Merge the new rows into the lists of the surviving rows ``old``, in place."""
    if not len(old) or not len(new):
        return
    dev = e.device
    kth = torch.from_numpy(wgt[old, k - 1].astype(np.float64)).to(dev)  # -inf: a hole
    e_new = e[torch.from_numpy(new).to(dev)]
    for lo, cos in _blocks(e[torch.from_numpy(old).to(dev)], e_new, tf32):
        th = kth[lo:lo + cos.shape[0], None]
        if tf32:
            w_all = _weights32(cos)
            hit = w_all.double() >= th
        else:
            hit = (cos.double() + COS_SLACK + 1.0) * 0.5 >= th
        r_at, c_at = (a.cpu().numpy() for a in torch.nonzero(hit, as_tuple=True))
        if not len(r_at):
            continue
        rows = old[lo:lo + cos.shape[0]]
        # each hit row's candidates, padded to the most any row has
        counts = np.bincount(r_at, minlength=len(rows))
        slot = np.arange(len(r_at)) - np.repeat(np.cumsum(counts) - counts, counts)
        ci = np.full((len(rows), int(counts.max())), -1, np.int64)
        cw = np.full(ci.shape, -np.inf, np.float32)
        ci[r_at, slot] = new[c_at]
        if tf32:
            cw[r_at, slot] = w_all[torch.from_numpy(r_at).to(dev),
                                   torch.from_numpy(c_at).to(dev)].cpu().numpy()
        else:
            cw[r_at, slot] = canonical_weights(xh[rows[r_at]][:, None, :],
                                               xh[new[c_at]][:, None, :])[:, 0]
        has = np.flatnonzero(counts)
        g = rows[has]
        idx[g], wgt[g] = _sort_rows(np.concatenate([idx[g], ci[has]], axis=1),
                                    np.concatenate([wgt[g], cw[has]], axis=1), k)


def replay(x: np.ndarray, bounds, labels, dels, k: int, *, device="cpu",
           precision: str = "float32"):
    """Yields the graph after each batch in turn: ``bounds[t] = (lo, hi)``
    inserts rows ``x[lo:hi]`` with ``labels[t]`` after deleting ``dels[t]``."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}: want 'float32' or 'tf32'")
    tf32 = precision == "tf32"
    xh = normalize_rows(x)
    e = torch.from_numpy(xh).to(device)
    n_all = len(xh)
    idx = np.full((n_all, k), -1, np.int64)
    wgt = np.full((n_all, k), -np.inf, np.float32)
    alive = np.zeros(n_all, bool)
    lab = np.full(n_all, -1, np.int8)
    for (lo, hi), y, d in zip(bounds, labels, dels):
        d = np.unique(d)
        d = d[(d >= 0) & (d < lo)]
        d = d[alive[d]]
        if len(d):
            alive[d] = False
            idx[d], wgt[d] = -1, -np.inf
            hit = np.isin(idx[:lo], d)
            rows = np.flatnonzero(hit.any(axis=1))
            hidx, hw = idx[rows], wgt[rows]
            hidx[hit[rows]], hw[hit[rows]] = -1, -np.inf
            idx[rows], wgt[rows] = _sort_rows(hidx, hw, k)
        old = np.flatnonzero(alive[:lo])
        new = np.arange(lo, hi)
        alive[lo:hi] = True
        lab[lo:hi] = y
        live = np.flatnonzero(alive[:hi])
        got = knn_lists(xh, e, new, k, cols=live, precision=precision)
        idx[lo:hi], wgt[lo:hi] = got.idx, got.wgt
        _merge(xh, e, old, new, idx, wgt, k, tf32)
        yield Step(idx=idx[:hi].copy(), wgt=wgt[:hi].copy(), alive=alive[:hi].copy(),
                   labels=lab[:hi].copy())
