"""Exact cosine kNN: the plain reference for the graph a fit builds.

NumPy and plain PyTorch only; nothing of the program is imported.  A
vertex's list holds the ``k`` other vertices of largest weight, in the order
(weight desc, id asc), where the configuration states the weight as

    w(i, j) = (cos(x_i, x_j) + 1) / 2,   cos = sum_d xh_i[d] * xh_j[d]

in float32: ``xh = x / max(|x|, 1e-12)``, the ``D`` products rounded each,
reduced by NumPy's float32 sum over the last axis (``canonical_weights``).

The search is exhaustive.  Every pair's cosine comes from a float32 matrix
product of the normalized rows on ``device`` (TF32 off), the ``t`` largest
per row are kept as candidates, each candidate's weight is worked out again
by the formula above, and the top ``k`` are taken.  The product and the
formula differ by at most ``COS_SLACK`` in a cosine, so a column left out
cannot reach the ``k``-th weight when the ``t``-th candidate's cosine plus
that slack stays below it; a row where it could is searched again with more
candidates, and at last over every column (``KnnResult.widened``).

``precision="tf32"`` is the control of ``portbench.check``: the same search
with the normalized rows rounded to TF32 (10 mantissa bits, to nearest even)
before the product, and the weights taken from that product, as a TF32
matrix unit would give them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

COS_SLACK = 1e-5  # > the float32 rounding of a 128-term dot of unit vectors, twice
MARGIN = 8  # candidates kept beyond k in the first pass
WIDE = 256  # candidates kept for a row whose first pass was not enough
_BLOCK_ELEMS = 2**30  # (rows, N) similarity elements per block on the device
_HOST_PAIRS = 2**22  # (row, candidate) pairs per block of the host recompute


@dataclasses.dataclass
class KnnResult:
    idx: np.ndarray  # (N, k) int64 neighbour ids, (weight desc, id asc)
    wgt: np.ndarray  # (N, k) float32 their weights
    widened: int  # rows searched again with more candidates


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """The configuration's normalization, in float32."""
    x = np.asarray(x, np.float32)
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, np.float32(1e-12))


def canonical_weights(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The configuration's weight of each pair of rows ``a[..., :]``,
    ``b[..., :]`` (broadcast): float32 products, NumPy's float32 sum."""
    prod = np.multiply(a, b, dtype=np.float32)
    cos = prod.sum(axis=-1, dtype=np.float32)
    return ((cos + np.float32(1.0)) * np.float32(0.5)).astype(np.float32, copy=False)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _topk_sims(e: torch.Tensor, rows: np.ndarray, t: int) -> tuple[np.ndarray, np.ndarray]:
    """For each of ``rows``: the ``t`` largest cosines to other rows of ``e``
    (self masked) and their columns, from a float32 product on e's device."""
    n = e.shape[0]
    block = max(1, min(len(rows), _BLOCK_ELEMS // n))
    vals, cols = [], []
    for lo in range(0, len(rows), block):
        r = torch.from_numpy(rows[lo:lo + block]).to(e.device)
        s = e[r] @ e.T
        s[torch.arange(len(r), device=e.device), r] = -np.inf
        v, c = torch.topk(s, t, dim=1)
        vals.append(v.cpu().numpy())
        cols.append(c.cpu().numpy().astype(np.int64))
        del s
    return np.concatenate(vals), np.concatenate(cols)


def _canonical_topk(xh: np.ndarray, rows: np.ndarray, cand: np.ndarray, k: int):
    """Top ``k`` of each row's candidates by (canonical weight desc, id asc)."""
    idx = np.empty((len(rows), k), np.int64)
    wgt = np.empty((len(rows), k), np.float32)
    step = max(1, _HOST_PAIRS // cand.shape[1])
    for lo in range(0, len(rows), step):
        c = cand[lo:lo + step]
        w = canonical_weights(xh[rows[lo:lo + step]][:, None, :], xh[c])
        order = np.lexsort((c, -w), axis=-1)[:, :k]
        idx[lo:lo + step] = np.take_along_axis(c, order, 1)
        wgt[lo:lo + step] = np.take_along_axis(w, order, 1)
    return idx, wgt


def _unsafe(top_cos: np.ndarray, kth_w: np.ndarray) -> np.ndarray:
    """Rows where a column beyond the candidates could reach the k-th weight."""
    bound = (top_cos.astype(np.float64) + COS_SLACK + 1.0) * 0.5
    return bound >= kth_w


def exact_knn(x: np.ndarray, k: int, *, device="cpu", precision: str = "float32"
              ) -> KnnResult:
    """Every vertex's ``k`` nearest others by the configuration's weight."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}: want 'float32' or 'tf32'")
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xh = normalize_rows(x)
        n = len(xh)
        e = torch.from_numpy(xh).to(device)
        rows = np.arange(n, dtype=np.int64)
        if precision == "tf32":
            vals, cols = _topk_sims(round_tf32(e), rows, min(k + MARGIN, n - 1))
            w = ((vals + np.float32(1.0)) * np.float32(0.5)).astype(np.float32)
            order = np.lexsort((cols, -w), axis=-1)[:, :k]
            return KnnResult(np.take_along_axis(cols, order, 1),
                             np.take_along_axis(w, order, 1), 0)
        t = min(k + MARGIN, n - 1)
        vals, cols = _topk_sims(e, rows, t)
        idx, wgt = _canonical_topk(xh, rows, cols, k)
        redo = np.flatnonzero(_unsafe(vals[:, -1], wgt[:, -1])) if t < n - 1 else rows[:0]
        widened = len(redo)
        for t_wide in (min(WIDE, n - 1), n - 1):
            if not len(redo):
                break
            v2, c2 = _topk_sims(e, redo, t_wide)
            i2, w2 = _canonical_topk(xh, redo, c2, k)
            idx[redo], wgt[redo] = i2, w2
            redo = (redo[_unsafe(v2[:, -1], w2[:, -1])] if t_wide < n - 1 else redo[:0])
        return KnnResult(idx, wgt, widened)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
