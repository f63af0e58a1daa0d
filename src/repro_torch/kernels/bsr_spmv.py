"""Block-sparse SpMV for the ``bsr`` backend: CUDA kernel and plain version.

Counterpart of ``repro.kernels.bsr_spmv``.  After the rows are put in
component order (paper Step 1), the adjacency is stored as row-padded BSR:
block row ``i`` has ``J`` tile slots, each a dense ``(BS, BS)`` tile and a
block-column id (``-1`` for an empty slot).  The neighbor aggregation
``y = A·x`` is then a loop of small dense tile products.

The BSR form is built from the ELL tensor, never through a dense
``(U, U)`` matrix:

  * ``ell_bsr_layout`` (host, numpy, O(nnz log nnz)) gives every ELL edge
    a slot in its block row, and reports the slot requirement and the
    touched tiles' fill.  A numpy copy of the reference's: the same bytes.
  * ``fill_bsr_blocks`` (device, O(nnz) scatter) turns the staged ELL
    ``(nbr, wgt)`` and the slot map into the ``(R, J, BS, BS)`` tiles and
    the ``(R, J)`` block-column ids.

``bsr_spmv_ref`` is the SpMV in plain torch ops: per tile row, the
column-order dot product as separate multiplies and adds, then the slots
added into ``y`` in slot order, empty slots skipped.  The CUDA kernel
(``csrc/bsr_spmv.cu``) does the same operations in the same order, so the
two give the same bits.  ``bsr_spmv`` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# --------------------------------------------------------------------- #
# Host layout (numpy copy of the reference's)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class BsrLayout:
    """Host-side slot assignment for one ELL snapshot.

    ``slot[u, k]`` is the tile slot (within block row ``u // block_size``)
    that edge ``(u, nbr[u, k])`` scatters into, or -1 on empty ELL lanes.
    ``num_slots`` is the layout's exact requirement (most distinct block
    columns in any block row); callers run with a budget ≥ it.
    """

    slot: np.ndarray  # (U_pad, K) int32, -1 on empty lanes
    num_slots: int  # max distinct block cols in any block row (≥ 1)
    n_blocks: int  # distinct (block row, block col) pairs with an edge
    nnz: int  # real ELL edges
    block_size: int

    @property
    def fill(self) -> float:
        """Fraction of the touched tiles' entries that carry an edge."""
        cap = self.n_blocks * self.block_size * self.block_size
        return self.nnz / cap if cap else 0.0


def ell_bsr_layout(nbr: np.ndarray, block_size: int) -> BsrLayout:
    """Assign every ELL edge a BSR tile slot (host, O(nnz log nnz)).

    Rows are expected in their final order; the layout never reorders.
    ``len(nbr)`` must be a multiple of ``block_size`` (callers pad rows).
    """
    m, _ = nbr.shape
    if m % block_size:
        raise ValueError(f"rows {m} not a multiple of block_size {block_size}")
    valid = nbr >= 0
    nnz = int(valid.sum())
    r = m // block_size
    if nnz == 0:
        return BsrLayout(slot=np.full(nbr.shape, -1, np.int32), num_slots=1,
                         n_blocks=0, nnz=0, block_size=block_size)
    br = np.repeat(np.arange(r, dtype=np.int64), block_size)[:, None]
    n_cols = int(nbr.max()) // block_size + 1
    # one key per (block row, block col) pair; rank each row's distinct
    # pairs by searchsorted into the global sorted-unique key list
    key = np.where(valid, br * n_cols + nbr // block_size, -1)
    uniq = np.unique(key[valid])
    pos = np.searchsorted(uniq, key)
    seg = np.searchsorted(uniq // n_cols, np.arange(r, dtype=np.int64))
    slot = np.where(valid, pos - seg[br], -1).astype(np.int32)
    counts = np.diff(np.append(seg, len(uniq)))
    return BsrLayout(slot=slot, num_slots=int(max(1, counts.max())),
                     n_blocks=len(uniq), nnz=nnz, block_size=block_size)


def fill_bsr_blocks(nbr: torch.Tensor, wgt: torch.Tensor, slot: torch.Tensor,
                    *, block_size: int, num_slots: int):
    """Device-side O(nnz) scatter: staged ELL rows → row-padded BSR.

    Lanes whose slot falls outside ``[0, num_slots)`` (and empty lanes) are
    dropped: they write into one spare element past the tiles (and the
    column ids), which is cut off, so an out-of-budget slot never lands in
    a neighboring block row's tile.  Every real edge owns a distinct
    target (rows list each neighbor once), so the plain writes are exact
    and deterministic, and the whole fill runs without a host sync.
    Returns ``(blocks, block_cols)``: ``(R, J, BS, BS)`` float32 and
    ``(R, J)`` int32, ``J = num_slots``.
    """
    m, k = nbr.shape
    bs = block_size
    r = m // bs
    dev = nbr.device
    rows = torch.arange(m, dtype=torch.int64, device=dev)[:, None]
    br, ur = rows // bs, rows % bs
    c = nbr.to(torch.int64)
    s = slot.to(torch.int64)
    valid = (c >= 0) & (s >= 0) & (s < num_slots)
    n_tiles = r * num_slots
    total = n_tiles * bs * bs
    tile = br * num_slots + s  # (m, k) target tile of each lane
    flat = torch.where(valid, (tile * bs + ur) * bs + c % bs, total)
    blocks = torch.zeros(total + 1, dtype=torch.float32, device=dev)
    blocks.index_put_((flat.reshape(-1),),
                      torch.where(valid, wgt.to(torch.float32), 0.0).reshape(-1))
    cols = torch.full((n_tiles + 1,), -1, dtype=torch.int32, device=dev)
    cols.scatter_reduce_(0, torch.where(valid, tile, n_tiles).reshape(-1),
                         torch.where(valid, c // bs, -1).to(torch.int32).reshape(-1),
                         "amax")
    return blocks[:total].view(r, num_slots, bs, bs), cols[:n_tiles].view(r, num_slots)


def dense_to_bsr(a: np.ndarray, bs: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense (N, M) → row-padded BSR ``(blocks, block_cols)`` as numpy.

    The test oracle for ``ell_bsr_layout``/``fill_bsr_blocks`` only (it
    builds the dense matrix); no path of the port calls it."""
    a = np.asarray(a)
    n, m = a.shape
    if n % bs or m % bs:
        raise ValueError(f"shape {a.shape} not a multiple of {bs}")
    rb, cb = n // bs, m // bs
    tiles = a.reshape(rb, bs, cb, bs).transpose(0, 2, 1, 3)  # (rb, cb, bs, bs)
    nz = tiles.reshape(rb, cb, -1).any(axis=2)
    jmax = max(1, int(nz.sum(1).max()))
    blocks = np.zeros((rb, jmax, bs, bs), a.dtype)
    cols = np.full((rb, jmax), -1, np.int32)
    for i in range(rb):
        js = np.flatnonzero(nz[i])
        blocks[i, : len(js)] = tiles[i, js]
        cols[i, : len(js)] = js
    return blocks, cols


# --------------------------------------------------------------------- #
# The SpMV: plain version and kernel wrapper
# --------------------------------------------------------------------- #
def bsr_spmv_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the SpMV (the kernel's arithmetic, op for op).

    Tiles and ``x`` are widened to float32.  Per tile row the dot product
    runs in column order as separate multiplies and adds (no ``einsum`` or
    ``matmul``, whose internal order is not fixed); then each block row's
    slots are added into ``y`` in slot order, empty slots skipped."""
    r, j, bs, _ = blocks.shape
    valid = block_cols >= 0
    if x.numel():
        xt = x.view(-1, bs)[torch.where(valid, block_cols, 0).long()].float()
    else:  # no column blocks: every slot is empty
        xt = torch.zeros((r, j, bs), dtype=torch.float32, device=x.device)
    a = blocks.float()
    s = torch.zeros((r, j, bs), dtype=torch.float32, device=blocks.device)
    for c in range(bs):
        s = s + a[..., c] * xt[..., c, None]
    y = torch.zeros((r, bs), dtype=torch.float32, device=blocks.device)
    for jj in range(j):
        y = torch.where(valid[:, jj, None], y + s[:, jj], y)
    return y.reshape(r * bs)


_DTYPES = (torch.float32, torch.bfloat16)


def _check(blocks, block_cols, x):
    dev = blocks.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bsr_spmv: unsupported device {dev}")
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3] or blocks.shape[2] < 1:
        raise ValueError(f"blocks must be (R, J, BS, BS), got {tuple(blocks.shape)}")
    r, j, bs, _ = blocks.shape
    if blocks.dtype not in _DTYPES:
        raise TypeError(f"blocks must be float32 or bfloat16, got {blocks.dtype}")
    if x.dtype != blocks.dtype:
        raise TypeError(f"x must be {blocks.dtype} like blocks, got {x.dtype}")
    if block_cols.dtype != torch.int32:
        raise TypeError(f"block_cols must be int32, got {block_cols.dtype}")
    if tuple(block_cols.shape) != (r, j):
        raise ValueError(f"block_cols must have shape {(r, j)}, got {tuple(block_cols.shape)}")
    if x.dim() != 1 or x.shape[0] % bs:
        raise ValueError(f"x must be 1-D with a multiple of {bs} entries, got {tuple(x.shape)}")
    for name, t in (("blocks", blocks), ("block_cols", block_cols), ("x", x)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, blocks on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(r * bs, x.shape[0]) >= 2**31:
        raise ValueError("bsr_spmv indexes rows and x with 32-bit ints")


def bsr_spmv(blocks: torch.Tensor, block_cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A·x`` over row-padded BSR tiles; ``y`` is ``(R·BS,)`` float32.

    CPU tensors take ``bsr_spmv_ref``; CUDA tensors launch the kernel on
    the current stream (building it at the first launch) and bump
    ``bsr_spmv.launches``.  Shapes, types and contiguity are checked; the
    column ids are not read (that would cost a host sync per sweep), so
    the caller guarantees ``block_cols < len(x) / BS``."""
    _check(blocks, block_cols, x)
    if blocks.device.type == "cpu":
        return bsr_spmv_ref(blocks, block_cols, x)
    from repro_torch.kernels._build import load_library

    r, j, bs, _ = blocks.shape
    y = torch.empty(r * bs, dtype=torch.float32, device=blocks.device)
    if r == 0:
        return y
    lib = load_library()
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    code = lib.lib.bsr_spmv(blocks.data_ptr(), block_cols.data_ptr(), x.data_ptr(),
                            y.data_ptr(), r * bs, j, bs,
                            int(blocks.dtype == torch.bfloat16), stream)
    lib.check(code, "bsr_spmv launch")
    bsr_spmv.launches += 1
    return y


bsr_spmv.launches = 0  # kernel launches since the last reset
