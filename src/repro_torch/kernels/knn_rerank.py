"""Canonical re-selection of a batch's kNN lists on the card: CUDA kernel and plain version.

Counterpart of no TPU kernel: the reference re-selects the new rows' lists
on the host (``repro.graph.dynamic.apply_batch``: ``pair_weights``, then
``topk_pairs``).  Device ingest leaves the batch's rows in the embedding
store (row ``base_id + i``) and argkmin's candidate ids on the card, so the
re-selection reads both in place: for every (new row, candidate) pair the
canonical weight ``graph.knn.pair_weights``, then per row the top k under
(weight desc, id asc), an empty or non-finite slot as ``(-1, -inf)``.  The
result is ``topk_pairs(pair_weights(q, b), cand, k)``'s bits.

The weight is numpy's: a float32 multiply per term, then numpy's sum over
the last axis, its ``pairwise_sum`` (eight running sums over the terms
``j, j + 8, ...``, combined as ``((r0 + r1) + (r2 + r3)) + ((r4 + r5) +
(r6 + r7))``, the ``D mod 8`` tail after, in order; plain sequential below
8 terms; above 128 the halves are summed apart and added), over the true
width ``d`` and not the store's padded width.  ``rerank_ref`` is the plain
torch version, op for op; the CUDA kernel (``csrc/knn_rerank.cu``, D up to
128, as argkmin) does the same ops in the same order.  The wrapper
``rerank_candidates`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors.  (Where a NaN input makes a weight NaN,
``topk_pairs`` keeps the NaN with id -1; both versions here give -inf.)
"""

from __future__ import annotations

import numpy as np
import torch

TK_MAX = 32  # candidates a row, one lane each (argkmin's TK_MAX)
D_MAX = 128  # terms the kernel sums (argkmin's D_MAX); numpy recurses above it
_PW_BLOCK = 128  # numpy's PW_BLOCKSIZE


def pairwise_sum(p: torch.Tensor) -> torch.Tensor:
    """numpy's float32 ``sum`` over the last axis of a contiguous array (its
    ``pairwise_sum``), one rounded add at a time."""
    n = p.shape[-1]
    if n < 8:
        s = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
        for i in range(n):
            s = s + p[..., i]
        return s
    if n > _PW_BLOCK:
        h = n // 2
        h -= h % 8
        return pairwise_sum(p[..., :h]) + pairwise_sum(p[..., h:])
    full = n - n % 8
    r = p[..., :8]
    for i in range(8, full, 8):
        r = r + p[..., i:i + 8]
    s = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
        (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for i in range(full, n):
        s = s + p[..., i]
    return s


def rerank_ref(store, base_id, cand, *, d: int, k: int):
    """Plain torch version: ``(idx (M, k) int64, w (M, k) float32)``.

    ``store`` (C, dp) float32, the batch's rows at ``base_id + i``; ``cand``
    (M, TK) int32 or int64 candidate ids, -1 for an empty slot; ``d`` the
    embedding's true width."""
    c = store.shape[0]
    m, tk = cand.shape
    ok = (cand >= 0) & (cand < c)
    q = store[int(base_id):int(base_id) + m, :d]
    b = store[torch.where(ok, cand, 0).long(), :d]
    w = (pairwise_sum(q[:, None, :] * b) + 1.0) * 0.5
    ok &= torch.isfinite(w)
    neg = torch.full((), -np.inf, dtype=torch.float32, device=store.device)
    w = torch.where(ok, w, neg)
    ids = torch.where(ok, cand.long(), -1)
    # (w desc, id asc), full ties in candidate order: two stable sorts
    ids, by_id = torch.sort(ids, dim=1, stable=True)
    w, by_w = torch.sort(w.gather(1, by_id), dim=1, descending=True, stable=True)
    ids = ids.gather(1, by_w)
    kc = min(k, tk)
    out_i = torch.full((m, k), -1, dtype=torch.int64, device=store.device)
    out_w = torch.full((m, k), -np.inf, dtype=torch.float32, device=store.device)
    out_i[:, :kc] = ids[:, :kc]
    out_w[:, :kc] = w[:, :kc]
    return out_i, out_w


def _check(store, base_id, cand, d, k):
    dev = store.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rerank_candidates: unsupported device {dev}")
    if store.dtype != torch.float32 or store.dim() != 2 or not store.is_contiguous():
        raise TypeError("store must be a contiguous 2-D float32 tensor")
    if cand.device != dev:
        raise ValueError(f"cand on {cand.device}, store on {dev}")
    if cand.dtype not in (torch.int32, torch.int64) or cand.dim() != 2:
        raise TypeError(f"cand must be a 2-D int32 or int64 tensor, got {cand.dtype}")
    c, dp = store.shape
    m = cand.shape[0]
    if not 1 <= d <= dp:
        raise ValueError(f"d={d} outside 1..{dp}")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if not 0 <= int(base_id) <= c - m:
        raise ValueError(f"rows {base_id}..{int(base_id) + m} outside the store's {c}")


def rerank_candidates(store, base_id, cand, *, d: int, k: int):
    """The new rows' canonical top-k lists: ``(idx (M, k) int64, w (M, k)
    float32)``, ``topk_pairs(pair_weights(...), cand, k)``'s bits.

    CPU tensors take ``rerank_ref``; CUDA tensors launch the kernel on the
    current stream (building it at the first launch) and bump
    ``rerank_candidates.launches``.  Nothing falls back: inputs the kernel
    does not take (d above 128, TK above 32) raise."""
    _check(store, base_id, cand, d, k)
    if store.device.type == "cpu":
        return rerank_ref(store, base_id, cand, d=d, k=k)
    return rerank_launch(store, base_id, cand, d=d, k=k)


def rerank_launch(store, base_id, cand, *, d: int, k: int):
    """The kernel on CUDA tensors: ``(idx, w)`` as ``rerank_ref`` gives
    them.  Bumps ``rerank_candidates.launches`` once a call."""
    from repro_torch.kernels._build import load_library

    _check(store, base_id, cand, d, k)
    if store.device.type != "cuda":
        raise ValueError(f"rerank_launch runs the CUDA kernel; store is on {store.device}")
    c, dp = store.shape
    m, tk = cand.shape
    if dp % 8 or d > D_MAX:
        raise ValueError(f"the rerank kernel takes dp % 8 == 0 and d <= {D_MAX}; "
                         f"got dp={dp}, d={d}")
    if not 1 <= tk <= TK_MAX:
        raise ValueError(f"the rerank kernel takes 1 to {TK_MAX} candidates; got TK = {tk}")
    if store.data_ptr() % 16:
        raise ValueError("store must be 16-byte aligned")
    if max(c * dp, m * max(tk, k)) >= 2**31:
        raise ValueError("rerank_candidates indexes rows with 32-bit ints")
    dev = store.device
    idx = torch.empty((m, k), dtype=torch.int64, device=dev)
    w = torch.empty((m, k), dtype=torch.float32, device=dev)
    if m == 0:
        return idx, w
    cand = cand.to(torch.int32).contiguous()
    lib = load_library()
    code = lib.lib.knn_rerank(
        store.data_ptr(), cand.data_ptr(), idx.data_ptr(), w.data_ptr(), c, dp, d, m, tk, k,
        int(base_id), torch.cuda.current_stream(dev).cuda_stream)
    lib.check(code, "knn_rerank launch")
    rerank_candidates.launches += 1
    return idx, w


rerank_candidates.launches = 0  # kernel launches since the last reset
