"""Bucket-ladder device-resident embedding store (single device).

Counterpart of ``repro.ingest.embedding_store.EmbeddingStore``.  Holds every
vertex's row-normalized embedding on the device, row-indexed by *global
vertex id* — the store never compacts, deletions just clear ``valid`` —
plus each row's current k-th neighbor weight, which the argkmin kernel
prunes displacement candidates against.  Three tensors: ``emb`` (C, dp)
float32, ``valid`` (C,) bool and ``kth`` (C,) float32.

Capacity grows on a doubling ladder (``cap_bucket``) and batches pad on
their own (``batch_bucket``), as in the reference, so the kernel sees a
bounded set of (C, Mp) shapes over any stream.  PyTorch has no jit cache to
bound; the store records the distinct shapes its updates and the kernel
have seen instead (``store_cache_size``), and ``ingest_ladder_bound`` bounds
that count.

Updates happen in place (``copy_`` / ``index_put_`` into the resident
tensors): the port's form of the reference's donated jit updates, which
alias their input buffers.  ``grow`` allocates the doubled rung and copies
the old rows over.  Ids out of range are dropped, as ``mode="drop"`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

CAP_FLOOR = 1024  # a multiple of the reference kernel's 256-row tile
BATCH_FLOOR = 8

# (kind, *shape) of every update and kernel call seen in this process: the
# port's stand-in for the reference's live jit-cache entries
_SHAPES: set[tuple] = set()


def cap_bucket(n: int, floor: int = CAP_FLOOR) -> int:
    """Store capacity ladder: doubling from ``floor``."""
    b = floor
    while b < n:
        b *= 2
    return b


def batch_bucket(m: int, floor: int = BATCH_FLOOR) -> int:
    """Batch/scatter row-count ladder (doubling)."""
    b = floor
    while b < m:
        b *= 2
    return b


def dim_pad(d: int) -> int:
    """Pad the feature axis to a multiple of 8 (zeros are inert under dot
    products)."""
    return max(8, -8 * (-d // 8))


def note_shape(kind: str, *dims: int) -> None:
    """Record one update or kernel shape (see ``store_cache_size``)."""
    _SHAPES.add((kind, *map(int, dims)))


def store_cache_size() -> int:
    """Distinct (kind, shape) pairs the store updates and the argkmin
    kernel have seen in this process."""
    return len(_SHAPES)


class EmbeddingStore:
    """Device-resident (capacity, dim_pad) normalized embedding tensor."""

    def __init__(self, emb_dim: int, capacity_floor: int = CAP_FLOOR,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.emb_dim = emb_dim
        self.dp = dim_pad(emb_dim)
        self.count = 0  # rows ever assigned (== graph num_nodes when synced)
        self.grows = 0
        self.appends = 0
        cap = cap_bucket(max(1, capacity_floor))
        self.emb = torch.zeros((cap, self.dp), dtype=torch.float32, device=self.device)
        self.valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self.kth = torch.full((cap,), -np.inf, dtype=torch.float32, device=self.device)

    @property
    def capacity(self) -> int:
        return self.emb.shape[0]

    def device_bytes(self) -> int:
        """Resident bytes of the store's three tensors."""
        return sum(t.numel() * t.element_size() for t in (self.emb, self.valid, self.kth))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # torch.from_numpy wants a writable array
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def _in_range(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        return (ids >= 0) & (ids < self.capacity)

    # ------------------------------------------------------------------ #
    def ensure(self, rows: int) -> None:
        """Grow the ladder until ``rows`` fit (the doubled rung is a new
        allocation; the old rows are copied over)."""
        if rows <= self.capacity:
            return
        old, new_cap = self.capacity, cap_bucket(rows)
        note_shape("grow", old, new_cap)
        emb = torch.zeros((new_cap, self.dp), dtype=torch.float32, device=self.device)
        valid = torch.zeros(new_cap, dtype=torch.bool, device=self.device)
        kth = torch.full((new_cap,), -np.inf, dtype=torch.float32, device=self.device)
        emb[:old].copy_(self.emb)
        valid[:old].copy_(self.valid)
        kth[:old].copy_(self.kth)
        self.emb, self.valid, self.kth = emb, valid, kth
        self.grows += 1

    def _adopt(self, emb_h: np.ndarray, valid_h: np.ndarray, kth_h: np.ndarray) -> None:
        self.emb = self._put(np.asarray(emb_h, np.float32))
        self.valid = self._put(np.asarray(valid_h, bool))
        self.kth = self._put(np.asarray(kth_h, np.float32))

    def backfill(self, embn: np.ndarray, alive: np.ndarray, kth: np.ndarray) -> None:
        """One-shot adoption of an existing graph's rows (host → device);
        used when an ingestor attaches to a non-empty graph."""
        n = len(embn)
        cap = max(self.capacity, cap_bucket(max(n, 1)))
        emb_h = np.zeros((cap, self.dp), np.float32)
        emb_h[:n, : self.emb_dim] = embn
        valid_h = np.zeros(cap, bool)
        valid_h[:n] = alive
        kth_h = np.full(cap, -np.inf, np.float32)
        kth_h[:n] = kth
        self._adopt(emb_h, valid_h, kth_h)
        self.count = n

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """Copies of the store's device state.  The tensors are updated in
        place, so a caller that keeps them while the stream goes on needs
        copies, not the live tensors."""
        return {"emb": self.emb.clone(), "valid": self.valid.clone(),
                "kth": self.kth.clone()}

    def load_state_arrays(self, arrays, count: int) -> None:
        """Adopt a ``state_arrays`` snapshot (numpy arrays or tensors, this
        store's or the reference's); the saved capacity is already a ladder
        rung."""
        host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in arrays.items()}
        if host["emb"].shape[1] != self.dp:
            raise ValueError(
                f"store snapshot dim {host['emb'].shape[1]} != padded dim {self.dp} "
                f"(emb_dim {self.emb_dim})")
        self._adopt(host["emb"], host["valid"], host["kth"])
        self.count = int(count)

    def append(self, embn: np.ndarray) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Append a normalized batch at the next free rows.

        Returns ``(batch (Mp, dp), batch_valid (Mp,), base_id)`` on the
        device, ready for ``kernels.argkmin``: padding rows are zero and
        flagged invalid; the next append overwrites them.
        """
        m = len(embn)
        mp = batch_bucket(max(m, 1))
        base_id = self.count
        self.ensure(base_id + mp)
        note_shape("append", self.capacity, mp)
        block = np.zeros((mp, self.dp), np.float32)
        block[:m, : self.emb_dim] = embn
        batch = self._put(block)
        bvalid = self._put(np.arange(mp) < m)
        self.emb[base_id:base_id + mp].copy_(batch)
        self.valid[base_id:base_id + mp].copy_(bvalid)
        self.kth[base_id:base_id + mp].fill_(-np.inf)
        self.count += m
        self.appends += 1
        return batch, bvalid, base_id

    def landmark_rows(self, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` as a device view, dim-padded: the landmark
        backend's assignment blocks (``kernels.landmark_propagate``) come
        straight off the resident tensor, with no host staging."""
        return self.emb[lo:hi]

    def landmark_gather(self, ids: np.ndarray) -> torch.Tensor:
        """The sampled landmark rows by global id, gathered on the device
        (one small gather a resample, never a copy of the store)."""
        return self.emb[self._put(np.asarray(ids, np.int64))]

    def kill(self, ids: np.ndarray) -> None:
        """Mark rows dead (deletions): they stop matching at once."""
        if not len(ids):
            return
        note_shape("kill", self.capacity, batch_bucket(len(ids)))
        ids = np.asarray(ids, np.int64)
        self.valid[self._put(ids[self._in_range(ids)])] = False

    def set_kth(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Refresh the pruning thresholds of rows whose lists changed."""
        if not len(rows):
            return
        note_shape("set_kth", self.capacity, batch_bucket(len(rows)))
        rows = np.asarray(rows, np.int64)
        keep = self._in_range(rows)
        self.kth[self._put(rows[keep])] = self._put(np.asarray(vals, np.float32)[keep])
