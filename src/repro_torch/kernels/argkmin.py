"""Fused cosine argkmin over the device embedding store: CUDA kernel and plain version.

Counterpart of the Pallas TPU kernel ``repro.kernels.argkmin``
(``_argkmin_pallas_impl``).  One pass over the store answers both questions
an arriving batch poses:

  1. **New-row candidates** — per batch row, the top-TK store rows by
     ``w = (batch·storeᵀ + 1)/2``, dead rows and the row's own store row
     (``base_id + i``) masked.  These are candidate *supersets*: the host
     re-selects the final top-k canonically (``graph.knn``), so the
     kernel's rounding never reaches an edge weight.
  2. **Displacement pruning** — the mask of old valid store rows whose
     current k-th weight some valid batch row beats within ``slack``.

The order is (w desc, store row asc) everywhere: every partial list and
every merge keeps it, so mass-duplicate inputs give the same candidates on
every path.  Empty slots are ``(-inf, -1)``.

A store block may be one shard of a row-sharded store: ``row0`` is the
global id of its row 0 (0 for a whole store), and candidate ids, the
self-match and the displacement test are in global ids.  ``shard_sweep``
runs one launch per shard at its ``row0`` and merges the per-shard lists
(the counterpart of the reference's ``shard_sweep_body``).

``argkmin_ref`` is the plain torch version.  Each dot product sums D terms
in order, one rounded multiply and one rounded add per term, and ``w`` is
``(s + 1) * 0.5``; the CUDA kernel (``csrc/argkmin.cu``) does the same ops in
the same order, so the two give the same bits (values, indices and mask).
The plain version walks the store in tiles and folds each into the running
list with ``merge_topk``, so it never holds an (M, C) temporary.  The
wrapper ``argkmin_candidates`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.graph.knn import SELECT_MARGIN

LIST_BOUNDS = (8, 16, 32)  # the kernel's list lengths, each built for every D
TK_MAX = LIST_BOUNDS[-1]
D_MAX = 128  # the kernel is built for D = 8, 16, ..., 128
ROWS_PER_BLOCK = 128  # batch rows per block of the tile passes, one a thread
SPLIT_TARGET = 1056  # resident blocks assumed where the card is not asked (8 per SM)
TILE_FLOATS = 4096  # floats of the store tile a block stages in shared memory
_PLAIN_TILE_ELEMS = 2**26  # (M, tile) elements per plain-version temporary


def merge_topk(val: torch.Tensor, idx: torch.Tensor, topk: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``topk`` of concatenated candidate lists, ties to the lower
    position.

    ``val``/``idx`` are (M, W); a stable descending sort keeps equal values
    in column order, so when the columns hold ids in ascending order among
    equal values (lists of ascending row blocks, each already in the
    canonical order), lowest position is lowest id.  Slots whose value is
    ``-inf`` come back with id ``-1``.
    """
    mval, pos = torch.sort(val, dim=1, descending=True, stable=True)
    mval = mval[:, :topk]
    midx = idx.gather(1, pos[:, :topk])
    return mval, torch.where(mval == -np.inf, torch.full_like(midx, -1), midx)


def _weights(batch: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """``(batch·tileᵀ + 1) * 0.5``, the dot summed in D order with every
    multiply and add rounded on its own (the kernel's arithmetic)."""
    acc = torch.zeros((batch.shape[0], tile.shape[0]), dtype=torch.float32,
                      device=batch.device)
    for d in range(batch.shape[1]):
        acc = acc + batch[:, d, None] * tile[None, :, d]
    return (acc + 1.0) * 0.5


def argkmin_ref(store, valid, kth, batch, batch_valid, base_id, slack, *,
                topk: int, tile_rows: int | None = None, row0: int = 0):
    """Plain torch version: returns ``(val (M, topk) f32, idx (M, topk)
    i32, disp (C,) bool)``.  ``row0`` is the global id of the store's row 0.
    ``tile_rows`` sets the store tile it walks (default: as many rows as
    keep an (M, tile) temporary at 2**26 elements); the result does not
    depend on it."""
    c, _ = store.shape
    m = batch.shape[0]
    dev = store.device
    tile = tile_rows or max(1, min(c, _PLAIN_TILE_ELEMS // max(m, 1)))
    neg = torch.full((), -np.inf, dtype=torch.float32, device=dev)
    slack_t = torch.full((), float(slack), dtype=torch.float32, device=dev)
    self_row = int(base_id) + torch.arange(m, device=dev)
    val = torch.full((m, topk), -np.inf, dtype=torch.float32, device=dev)
    idx = torch.full((m, topk), -1, dtype=torch.int32, device=dev)
    disp = torch.zeros(c, dtype=torch.bool, device=dev)
    for lo in range(0, c, tile):
        hi = min(lo + tile, c)
        rows = torch.arange(lo + int(row0), hi + int(row0), device=dev)  # global ids
        w = _weights(batch, store[lo:hi])
        if m:
            colmax = torch.where(batch_valid[:, None], w, neg).amax(dim=0)
            disp[lo:hi] = (valid[lo:hi] & (rows < int(base_id))
                           & (colmax > kth[lo:hi] - slack_t))
        ok = valid[lo:hi][None, :] & (rows[None, :] != self_row[:, None])
        val, idx = merge_topk(
            torch.cat([val, torch.where(ok, w, neg)], dim=1),
            torch.cat([idx, rows.to(torch.int32).expand(m, -1)], dim=1), topk)
    return val, idx, disp


def argkmin_geometry(c: int, d: int, m: int, topk: int, *, resident: int = SPLIT_TARGET
                     ) -> dict:
    """The kernel's launch geometry for a (C, D, M, TK) call.

    ``tkb``: the list bound, the smallest of ``LIST_BOUNDS`` that holds
    ``topk``.  ``row_blocks``: blocks of ``ROWS_PER_BLOCK`` batch rows.
    ``tile_rows``: store rows a block stages at a time.  ``splits``: the
    pass over the store deals its tiles round-robin to this many splits,
    as many as fill one wave of ``resident`` blocks (the blocks the card
    holds at once) and no more than there are tiles.  ``smem_bytes``: the
    tile kernel's static shared memory."""
    if not 1 <= topk <= TK_MAX:
        raise ValueError(f"the argkmin kernel keeps 1 to {TK_MAX} candidates; got {topk}")
    if c < 1 or m < 1 or d % 8 or not 8 <= d <= D_MAX:
        raise ValueError(f"no argkmin launch for C={c}, D={d}, M={m}")
    tkb = min(b for b in LIST_BOUNDS if b >= topk)
    row_blocks = -(-m // ROWS_PER_BLOCK)
    tile_rows = (TILE_FLOATS // d) // 8 * 8
    splits = max(1, min(resident // row_blocks, -(-c // tile_rows), 65535))
    return dict(tkb=tkb, row_blocks=row_blocks, tile_rows=tile_rows, splits=splits,
                blocks=row_blocks * splits,
                smem_bytes=tile_rows * d * 4 + tile_rows + 4 * 4 * tile_rows)


@functools.cache
def resident_blocks(d: int, tkb: int, device_index: int) -> int:
    """Blocks of the tile kernel for (D, TKB) that the card holds at once."""
    from repro_torch.kernels._build import load_library

    with torch.cuda.device(device_index):
        n = load_library().lib.argkmin_resident_blocks(d, tkb)
    if n < 1:
        raise RuntimeError(f"argkmin: no occupancy for D={d}, TKB={tkb} ({n})")
    return n


def _check(store, valid, kth, batch, batch_valid, base_id, row0=0):
    dev = store.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"argkmin_candidates: unsupported device {dev}")
    if store.dim() != 2 or batch.dim() != 2:
        raise ValueError("store and batch must be 2-D")
    c, d = store.shape
    m = batch.shape[0]
    want = (("store", store, torch.float32, (c, d)), ("valid", valid, torch.bool, (c,)),
            ("kth", kth, torch.float32, (c,)), ("batch", batch, torch.float32, (m, d)),
            ("batch_valid", batch_valid, torch.bool, (m,)))
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, store on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= int(base_id) <= 2**31 - 1 - m:
        raise ValueError(f"base_id={base_id} out of range")
    if not 0 <= int(row0) <= 2**31 - 1 - c:
        raise ValueError(f"row0={row0} out of range")
    if max(c * d, m * d) >= 2**31:
        raise ValueError("argkmin_candidates indexes with 32-bit ints")


def argkmin_candidates(store, valid, kth, batch, batch_valid, base_id, slack, *, k: int):
    """Fast-path candidates + displacement mask for one embedding batch.

    ``store`` (C, D) f32 normalized rows (row == global id), ``valid`` (C,)
    bool, ``kth`` (C,) f32 (``-inf`` while a row's list is under-full),
    ``batch`` (M, D) f32 (already appended to the store at ``base_id``),
    ``batch_valid`` (M,) bool, ``slack`` the pruning tolerance.  Returns
    ``(val (M, TK) f32, idx (M, TK) i32, disp (C,) bool)`` with
    ``TK = min(k + SELECT_MARGIN, C)``.

    CPU tensors take ``argkmin_ref``; CUDA tensors launch the kernel on the
    current stream (building it at the first launch) and bump
    ``argkmin_candidates.launches``.  Nothing falls back: inputs the kernel
    does not take (D not a multiple of 8 or above 128, TK above 32) raise.
    """
    _check(store, valid, kth, batch, batch_valid, base_id)
    c, d = store.shape
    m = batch.shape[0]
    topk = min(k + SELECT_MARGIN, c)
    if store.device.type == "cpu":
        return argkmin_ref(store, valid, kth, batch, batch_valid, base_id, slack, topk=topk)
    return argkmin_launch(store, valid, kth, batch, batch_valid, base_id, slack, topk=topk)


def argkmin_launch(store, valid, kth, batch, batch_valid, base_id, slack, *, topk: int,
                   row0: int = 0):
    """The kernel on CUDA tensors for any ``1 <= topk <= TK_MAX``:
    ``(val, idx, disp)`` as ``argkmin_ref`` gives them, the store's row 0
    at global id ``row0``.  Bumps ``argkmin_candidates.launches`` once a
    call."""
    from repro_torch.kernels._build import load_library

    _check(store, valid, kth, batch, batch_valid, base_id, row0)
    if store.device.type != "cuda":
        raise ValueError(f"argkmin_launch runs the CUDA kernel; store is on {store.device}")
    c, d = store.shape
    m = batch.shape[0]
    if d % 8 or not 8 <= d <= D_MAX:
        raise ValueError(f"the argkmin kernel takes D = 8, 16, ..., {D_MAX}; got {d}")
    if not 1 <= topk <= min(TK_MAX, c):
        raise ValueError(f"the argkmin kernel keeps 1 to {TK_MAX} candidates, at most C; "
                         f"got TK = {topk}")
    if store.data_ptr() % 16:
        raise ValueError("store must be 16-byte aligned")
    dev = store.device
    val = torch.empty((m, topk), dtype=torch.float32, device=dev)
    idx = torch.empty((m, topk), dtype=torch.int32, device=dev)
    disp = torch.empty(c, dtype=torch.uint8, device=dev)
    if m == 0:
        return val, idx, disp.zero_().view(torch.bool)
    tkb = min(b for b in LIST_BOUNDS if b >= topk)
    geo = argkmin_geometry(c, d, m, topk, resident=resident_blocks(d, tkb, dev.index or 0))
    pval = torch.empty((geo["splits"], m, topk), dtype=torch.float32, device=dev)
    pidx = torch.empty((geo["splits"], m, topk), dtype=torch.int32, device=dev)
    pcol = torch.empty((geo["row_blocks"], c), dtype=torch.float32, device=dev)
    lib = load_library()
    code = lib.lib.argkmin(
        store.data_ptr(), valid.data_ptr(), kth.data_ptr(), batch.data_ptr(),
        batch_valid.data_ptr(), val.data_ptr(), idx.data_ptr(), disp.data_ptr(),
        pval.data_ptr(), pidx.data_ptr(), pcol.data_ptr(), c, d, m, topk, geo["tkb"],
        geo["splits"], int(base_id), int(row0), float(slack),
        torch.cuda.current_stream(dev).cuda_stream)
    lib.check(code, "argkmin launch")
    argkmin_candidates.launches += 1
    return val, idx, disp.view(torch.bool)


argkmin_candidates.launches = 0  # kernel launches since the last reset


def shard_sweep(stores, valids, kths, batches, batch_valids, base_id, slack, *, topk: int):
    """The move-the-batch sweep over a row-sharded store (the reference's
    ``shard_sweep_body``).

    Shard s holds global rows ``[s·c_loc, (s+1)·c_loc)`` as ``stores[s]``,
    ``valids[s]``, ``kths[s]`` on its device, and ``batches[s]`` /
    ``batch_valids[s]`` are the batch's copy there.  Each shard runs one
    pass at ``row0 = s·c_loc`` for its top-``tk_loc`` (``min(topk,
    c_loc)``): the plain version for CPU tensors, the kernel for CUDA
    tensors (one launch a shard).  The lists are gathered onto the first
    shard's device and merged by ``merge_topk``: a stable sort over columns
    in shard order, each list in (w desc, id asc), so ties go to the lowest
    global id, as in one pass over the whole store.  The displacement masks
    are concatenated in shard order.  Returns ``(val (M, topk), idx (M,
    topk), disp (C,))`` on the first shard's device, the bits of one pass
    over the unsharded store."""
    c_loc = stores[0].shape[0]
    tk_loc = min(topk, c_loc)
    home = stores[0].device
    vals, idxs, disps = [], [], []
    for s, args in enumerate(zip(stores, valids, kths, batches, batch_valids)):
        run = argkmin_ref if args[0].device.type == "cpu" else argkmin_launch
        val, idx, disp = run(*args, base_id, slack, topk=tk_loc, row0=s * c_loc)
        vals.append(val.to(home, non_blocking=True))
        idxs.append(idx.to(home, non_blocking=True))
        disps.append(disp.to(home, non_blocking=True))
    mval, midx = merge_topk(torch.cat(vals, dim=1), torch.cat(idxs, dim=1), topk)
    return mval, midx, torch.cat(disps)
