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
``knn_lists`` runs that search for some rows over a subset of the columns,
as the stream's replay needs it for a batch's new rows over the live ones.

``precision="tf32"`` is the control of ``portbench.check``: the same search
with the normalized rows rounded to TF32 (10 mantissa bits, to nearest even)
before the product, and the weights taken from that product, as a TF32
matrix unit would give them.
"""

from __future__ import annotations

import contextlib
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


def _topk_sims(e: torch.Tensor, rows: np.ndarray, t: int, cols: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """For each of ``rows``: the ``t`` largest cosines to the other rows of
    ``e`` among ``cols`` (ascending ids; every row when None), self masked,
    and their ids, from a float32 product on e's device."""
    ec = e if cols is None else e[torch.from_numpy(cols).to(e.device)]
    n = ec.shape[0]
    block = max(1, min(len(rows), _BLOCK_ELEMS // n))
    vals, ids = [], []
    for lo in range(0, len(rows), block):
        rr = rows[lo:lo + block]
        r = torch.from_numpy(rr).to(e.device)
        s = e[r] @ ec.T
        if cols is None:
            s[torch.arange(len(r), device=e.device), r] = -np.inf
        else:
            at = np.minimum(np.searchsorted(cols, rr), n - 1)
            own = np.flatnonzero(cols[at] == rr)
            s[torch.from_numpy(own).to(e.device), torch.from_numpy(at[own]).to(e.device)] = -np.inf
        v, c = torch.topk(s, t, dim=1)
        vals.append(v.cpu().numpy())
        c = c.cpu().numpy().astype(np.int64)
        ids.append(c if cols is None else cols[c])
        del s
    return np.concatenate(vals), np.concatenate(ids)


def _canonical_topk(xh: np.ndarray, rows: np.ndarray, cand: np.ndarray, k: int):
    """Top ``k`` of each row's candidates by (canonical weight desc, id asc)."""
    idx = np.full((len(rows), k), -1, np.int64)  # -1/-inf past the candidates
    wgt = np.full((len(rows), k), -np.inf, np.float32)
    kk = min(k, cand.shape[1])
    step = max(1, _HOST_PAIRS // max(1, cand.shape[1]))
    for lo in range(0, len(rows), step):
        c = cand[lo:lo + step]
        w = canonical_weights(xh[rows[lo:lo + step]][:, None, :], xh[c])
        order = np.lexsort((c, -w), axis=-1)[:, :kk]
        idx[lo:lo + step, :kk] = np.take_along_axis(c, order, 1)
        wgt[lo:lo + step, :kk] = np.take_along_axis(w, order, 1)
    return idx, wgt


def _unsafe(top_cos: np.ndarray, kth_w: np.ndarray) -> np.ndarray:
    """Rows where a column beyond the candidates could reach the k-th weight."""
    bound = (top_cos.astype(np.float64) + COS_SLACK + 1.0) * 0.5
    return bound >= kth_w


@contextlib.contextmanager
def no_tf32():
    """float32 products on the card: TF32 off while the block runs."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def knn_lists(xh: np.ndarray, e: torch.Tensor, rows: np.ndarray, k: int, *,
              cols: np.ndarray | None = None, precision: str = "float32") -> KnnResult:
    """The lists of ``rows`` (ids into ``xh``, ``e`` the same rows on the
    device) over the columns ``cols`` (ascending ids, the rows among them;
    every row when None): the search of the module's docstring.  A row with
    fewer than ``k`` other columns pads its list with -1/-inf."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}: want 'float32' or 'tf32'")
    n = len(xh) if cols is None else len(cols)
    if n < 2:
        return KnnResult(np.full((len(rows), k), -1, np.int64),
                         np.full((len(rows), k), -np.inf, np.float32), 0)
    t = min(k + MARGIN, n - 1)
    with no_tf32():
        if precision == "tf32":
            vals, cand = _topk_sims(round_tf32(e), rows, t, cols)
            w = ((vals + np.float32(1.0)) * np.float32(0.5)).astype(np.float32)
            order = np.lexsort((cand, -w), axis=-1)[:, :k]
            idx = np.full((len(rows), k), -1, np.int64)
            wgt = np.full((len(rows), k), -np.inf, np.float32)
            idx[:, :order.shape[1]] = np.take_along_axis(cand, order, 1)
            wgt[:, :order.shape[1]] = np.take_along_axis(w, order, 1)
            return KnnResult(idx, wgt, 0)
        vals, cand = _topk_sims(e, rows, t, cols)
        idx, wgt = _canonical_topk(xh, rows, cand, k)
        at = np.flatnonzero(_unsafe(vals[:, -1], wgt[:, -1])) if t < n - 1 else rows[:0]
        widened = len(at)
        for t_wide in (min(WIDE, n - 1), n - 1):
            if not len(at):
                break
            v2, c2 = _topk_sims(e, rows[at], t_wide, cols)
            i2, w2 = _canonical_topk(xh, rows[at], c2, k)
            idx[at], wgt[at] = i2, w2
            at = at[_unsafe(v2[:, -1], w2[:, -1])] if t_wide < n - 1 else at[:0]
        return KnnResult(idx, wgt, widened)


def exact_knn(x: np.ndarray, k: int, *, device="cpu", precision: str = "float32"
              ) -> KnnResult:
    """Every vertex's ``k`` nearest others by the configuration's weight."""
    xh = normalize_rows(x)
    return knn_lists(xh, torch.from_numpy(xh).to(device), np.arange(len(xh), dtype=np.int64),
                     k, precision=precision)
