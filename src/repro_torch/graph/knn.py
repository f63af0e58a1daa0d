"""Similarity-graph construction (paper §7.1 datasets pipeline).

Numpy copy of ``repro.graph.knn``: the port keeps its own so that it never
imports the JAX package, and the parity tests hold the two byte-identical.

Non-graph data is modeled as a graph: embeddings → pairwise cosine
similarity → kNN sparsification (k=5 default, following [19] as the paper
does).  We compute blockwise top-k so construction is O(N²/B) memory and runs
for hundreds of thousands of points on the host.

Bit-equality contract (shared with ``ingest/``): every path — this host
oracle, the host staging selector in ``graph.dynamic``, and the device
argkmin kernel in ``kernels.argkmin`` — splits neighbor search into

  1. *candidate selection*: any fast similarity (BLAS sgemm here, an XLA or
     Pallas matmul on device) ranks a superset of ``k + SELECT_MARGIN``
     candidates per query; boundary ties keep the lowest index, and a
     ``selection_slack`` tolerance keeps near-ties in the superset; then
  2. *canonical re-selection*: ``pair_weights`` recomputes the weight of
     every surviving (query, candidate) pair with one fixed summation order,
     and the final top-k is taken under the total order (weight desc,
     index asc).

Step 2 is the only place weights that reach the graph are produced, so two
paths agree bit-for-bit whenever their candidate supersets both cover the
canonical top-k — which step 1's margin + slack guarantees for anything
short of an adversarial >MARGIN-deep rank inversion.
"""

from __future__ import annotations

import numpy as np

from .structures import CSRGraph, coo_to_csr

# Candidate supersets carry this many extra entries beyond k; canonical
# re-selection prunes them.  8 absorbs any realistic fast-path/canonical
# rank divergence (observed divergences are 1-2 deep).
SELECT_MARGIN = 8


def selection_slack(dim: int) -> float:
    """Similarity tolerance for candidate pruning tests (e.g. "does this
    batch displace row i's k-th neighbor?").  Scales with the summation
    length so float32 accumulation drift can never hide a true candidate."""
    return 1e-5 + 1e-7 * dim


def normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def pair_weights(qn: np.ndarray, bn: np.ndarray) -> np.ndarray:
    """Canonical cosine weight for (query, base) pairs — THE edge weight.

    ``qn`` / ``bn`` are row-normalized float32 and broadcast against each
    other; the product is materialized C-contiguous and reduced over the
    last axis, so the summation order depends only on ``D`` — every caller
    (host oracle, staging selector, device merge) gets bit-identical
    weights for the same pair.  Weights are shifted into [0, 1]:
    w = (cos + 1) / 2.
    """
    prod = np.multiply(qn, bn, dtype=np.float32)
    cos = prod.sum(axis=-1, dtype=np.float32)
    return ((cos + np.float32(1.0)) * np.float32(0.5)).astype(np.float32, copy=False)


def topk_pairs(
    wgt: np.ndarray, idx: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k under the canonical order (weight desc, index asc).

    ``wgt`` (R, C) float32 with ``-inf`` marking invalid slots, ``idx``
    (R, C) int64 candidate ids.  Returns (idx, wgt) of shape (R, k), rows
    sorted by the canonical order, invalid tail padded with (-1, -inf).
    """
    r, c = wgt.shape
    kc = min(k, c)
    order = np.lexsort((idx, -wgt), axis=-1)[:, :kc]
    rows = np.arange(r)[:, None]
    top_w = wgt[rows, order]
    top_i = np.where(np.isfinite(top_w), idx[rows, order], -1)
    if kc < k:
        top_i = np.concatenate([top_i, np.full((r, k - kc), -1, top_i.dtype)], axis=1)
        top_w = np.concatenate(
            [top_w, np.full((r, k - kc), -np.inf, np.float32)], axis=1)
    return top_i, top_w


def candidate_mask_to_pairs(
    mask: np.ndarray, wgt_fill: float = -np.inf
) -> tuple[np.ndarray, np.ndarray]:
    """Rectangularize a ragged per-row candidate mask.

    ``mask`` (R, C) bool → (cand_idx (R, W) int64 with -1 padding, valid
    (R, W) bool) where W = max row population.  Row-major order preserves
    ascending column ids per row.
    """
    counts = mask.sum(axis=1)
    w = int(counts.max()) if len(counts) else 0
    r, c = np.nonzero(mask)
    pos = np.arange(len(c)) - np.repeat(np.cumsum(counts) - counts, counts)
    cand = np.full((mask.shape[0], max(w, 1)), -1, np.int64)
    cand[r, pos] = c
    return cand, cand >= 0


def select_candidates(sim: np.ndarray, k: int) -> np.ndarray:
    """Candidate superset per query row from a fast similarity block.

    Takes every column whose similarity reaches the (k + SELECT_MARGIN)-th
    largest value — *including all boundary ties*, so mass-duplicate inputs
    can never evict a canonically-preferred (lower-index) candidate from
    the superset.  Returns (R, W) int64 column ids, -1 padded.
    """
    r, m = sim.shape
    t = min(k + SELECT_MARGIN, m)
    if t >= m:
        thr = np.full(r, -np.inf, np.float32)
    else:
        part = np.argpartition(-sim, t - 1, axis=1)[:, :t]
        thr = sim[np.arange(r)[:, None], part].min(axis=1)
    cand, _ = candidate_mask_to_pairs(sim >= thr[:, None])
    return cand


def knn_edges(
    emb: np.ndarray,
    k: int = 5,
    block: int = 4096,
    base: np.ndarray | None = None,
    base_offset: int = 0,
    self_offset: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k cosine neighbors of ``emb`` within ``base`` (defaults to emb).

    Returns COO (src, dst, wgt) with global ids ``src+self_offset`` /
    ``dst+base_offset``.  Self matches are excluded when the id spaces
    overlap.  Weights are canonical ``pair_weights`` values; per-row order
    is the canonical (weight desc, index asc) total order.
    """
    q = normalize_rows(emb.astype(np.float32))
    b = q if base is None else normalize_rows(base.astype(np.float32))
    n, mb = len(q), len(b)
    srcs, dsts, ws = [], [], []
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        sim = q[lo:hi] @ b.T  # (blk, Mb)
        # mask self-similarity where id spaces overlap (vectorized: the
        # self column of query row i is i + self_offset - base_offset)
        self_col = np.arange(lo, hi) + (self_offset - base_offset)
        inside = (self_col >= 0) & (self_col < mb)
        sim[np.flatnonzero(inside), self_col[inside]] = -np.inf
        kk = min(k, mb - 1) if mb > 1 else 1
        cand = select_candidates(sim, kk)
        # canonical re-selection on the superset
        cw = np.full(cand.shape, -np.inf, np.float32)
        valid = cand >= 0
        qr, qc = np.nonzero(valid)
        cw[qr, qc] = pair_weights(q[lo + qr], b[cand[qr, qc]])
        # re-apply the self mask in canonical space
        if inside.any():
            self_hit = cand == self_col[:, None]
            cw[self_hit & valid] = -np.inf
        top_i, top_w = topk_pairs(cw, cand, kk)
        keep = np.isfinite(top_w)
        rows = np.broadcast_to(np.arange(lo, hi)[:, None], top_i.shape)
        srcs.append((rows + self_offset)[keep].astype(np.int64))
        dsts.append((top_i + base_offset)[keep])
        ws.append(top_w[keep])
    if not srcs:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z.astype(np.float32)
    return (
        np.concatenate(srcs).astype(np.int64),
        np.concatenate(dsts).astype(np.int64),
        np.concatenate(ws).astype(np.float32),
    )


def symmetrize(
    num_nodes: int, src: np.ndarray, dst: np.ndarray, wgt: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union of directed kNN edges; duplicate (u,v) keeps the max weight."""
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    w = np.concatenate([wgt, wgt])
    key = u * np.int64(num_nodes) + v
    order = np.argsort(key, kind="stable")
    key, u, v, w = key[order], u[order], v[order], w[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    # max weight within duplicate group
    grp = np.cumsum(first) - 1
    wmax = np.zeros(grp[-1] + 1 if len(grp) else 0, dtype=np.float32)
    np.maximum.at(wmax, grp, w)
    return u[first], v[first], wmax


def build_knn_graph(emb: np.ndarray, k: int = 5, block: int = 4096) -> CSRGraph:
    src, dst, wgt = knn_edges(emb, k=k, block=block)
    s, d, w = symmetrize(len(emb), src, dst, wgt)
    return coo_to_csr(len(emb), s, d, w)
