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

``ShardedEmbeddingStore`` is the mesh twin: the same ladder and updates,
but every (capacity, ·) tensor is cut into the mesh's shards, each holding
``cap / D`` contiguous rows as tensors of its own on its device, and the
candidate search flips to move-the-batch (``core.distributed.
StoreShardPlan``, ``kernels.argkmin.shard_sweep``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import telemetry
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
    """Record one update or kernel shape (see ``store_cache_size``); a
    shape seen first ticks the ``ingest.new_shapes`` counter."""
    key = (kind, *map(int, dims))
    if key not in _SHAPES:
        _SHAPES.add(key)
        telemetry.count("ingest.new_shapes")


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

    @property
    def n_shards(self) -> int:
        """Shards the store's rows are cut into (1 here)."""
        return 1

    def device_bytes(self) -> int:
        """Resident bytes of the store's three tensors (the largest shard's
        on a sharded store)."""
        return sum(t.numel() * t.element_size() for t in (self.emb, self.valid, self.kth))

    def host_state(self) -> dict[str, np.ndarray]:
        """Full host copies of ``emb``/``valid``/``kth``, taken now (the
        checkpoint's leaves; the same arrays on every mesh shape)."""
        return {k: getattr(self, k).to("cpu", copy=True).numpy()
                for k in ("emb", "valid", "kth")}

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


class ShardedEmbeddingStore(EmbeddingStore):
    """Row-sharded twin of ``EmbeddingStore`` over a ``DeviceMesh``.

    Shard s holds global rows ``[s·cap/D, (s+1)·cap/D)`` as its own
    ``emb_s[s]``/``valid_s[s]``/``kth_s[s]`` on its device.  A grow re-cuts
    the doubled rung: each new shard copies its rows from the old shards
    that held them.  ``append`` moves the batch (one copy on every device of
    the mesh) and writes the new rows into the shards that own them;
    ``kill``/``set_kth`` write each id in its owner shard.  ``emb``,
    ``valid`` and ``kth`` are whole-store copies on the mesh's first device
    (for inspection and persistence, not the hot path);
    ``landmark_rows``/``landmark_gather`` hand the landmark backend one
    tensor on the first device.  The ladder floor must divide over the
    shards, or construction raises.
    """

    def __init__(self, emb_dim: int, mesh, capacity_floor: int = CAP_FLOOR):
        floor_cap = cap_bucket(max(1, capacity_floor))
        if floor_cap % mesh.n_devices:
            raise ValueError(
                f"store capacity floor {floor_cap} not divisible by mesh device count "
                f"{mesh.n_devices}; the doubling ladder keeps rows divisible only for "
                "power-of-two meshes up to the floor")
        self.mesh = mesh
        self.device = mesh.device
        self.emb_dim = emb_dim
        self.dp = dim_pad(emb_dim)
        self.count = 0
        self.grows = 0
        self.appends = 0
        self._adopt(np.zeros((floor_cap, self.dp), np.float32), np.zeros(floor_cap, bool),
                    np.full(floor_cap, -np.inf, np.float32))

    @property
    def n_shards(self) -> int:
        return self.mesh.n_devices

    @property
    def rows_per_shard(self) -> int:
        return self.emb_s[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.rows_per_shard * self.n_shards

    def _whole(self, parts) -> torch.Tensor:
        return torch.cat([t.to(self.device) for t in parts])

    @property
    def emb(self) -> torch.Tensor:
        return self._whole(self.emb_s)

    @property
    def valid(self) -> torch.Tensor:
        return self._whole(self.valid_s)

    @property
    def kth(self) -> torch.Tensor:
        return self._whole(self.kth_s)

    def device_bytes(self) -> int:
        """The largest shard's resident bytes: ``1/D`` of the unsharded
        ladder's."""
        return max(sum(t.numel() * t.element_size() for t in parts)
                   for parts in zip(self.emb_s, self.valid_s, self.kth_s))

    def host_state(self) -> dict[str, np.ndarray]:
        return {k: np.concatenate([t.cpu().numpy() for t in getattr(self, f"{k}_s")])
                for k in ("emb", "valid", "kth")}

    def state_arrays(self) -> dict[str, torch.Tensor]:
        return {"emb": self.emb, "valid": self.valid, "kth": self.kth}

    def _adopt(self, emb_h, valid_h, kth_h) -> None:
        """Land full host arrays in the shards (backfill and restore:
        elastic across mesh shapes, since the arrays are whole)."""
        from repro_torch.core.distributed import shard_rows

        self.emb_s = shard_rows(self.mesh, np.asarray(emb_h, np.float32))
        self.valid_s = shard_rows(self.mesh, np.asarray(valid_h, bool))
        self.kth_s = shard_rows(self.mesh, np.asarray(kth_h, np.float32))

    def _owners(self, ids: np.ndarray):
        """(shard, local rows, positions in ``ids``) for each shard owning
        some of ``ids``; out-of-range ids are dropped."""
        ids = np.asarray(ids, np.int64)
        pos = np.flatnonzero(self._in_range(ids))
        m = self.rows_per_shard
        owner = ids[pos] // m
        for s in np.unique(owner):
            sel = pos[owner == s]
            yield int(s), ids[sel] - s * m, sel

    def ensure(self, rows: int) -> None:
        if rows <= self.capacity:
            return
        old_m, new_cap = self.rows_per_shard, cap_bucket(rows)
        note_shape("grow", self.capacity, new_cap)
        m = new_cap // self.n_shards
        parts = {"emb": [], "valid": [], "kth": []}
        for s, dev in enumerate(self.mesh.devices):
            emb = torch.zeros((m, self.dp), dtype=torch.float32, device=dev)
            valid = torch.zeros(m, dtype=torch.bool, device=dev)
            kth = torch.full((m,), -np.inf, dtype=torch.float32, device=dev)
            lo, hi = s * m, min((s + 1) * m, self.capacity)
            for t in range(lo // old_m, -(-hi // old_m)) if hi > lo else ():
                a, b = max(lo, t * old_m), min(hi, (t + 1) * old_m)
                emb[a - lo:b - lo].copy_(self.emb_s[t][a - t * old_m:b - t * old_m])
                valid[a - lo:b - lo].copy_(self.valid_s[t][a - t * old_m:b - t * old_m])
                kth[a - lo:b - lo].copy_(self.kth_s[t][a - t * old_m:b - t * old_m])
            parts["emb"].append(emb)
            parts["valid"].append(valid)
            parts["kth"].append(kth)
        self.emb_s, self.valid_s, self.kth_s = (tuple(parts[k]) for k in ("emb", "valid", "kth"))
        self.grows += 1

    def append(self, embn: np.ndarray):
        """Append a normalized batch at the next free rows.  Returns
        ``(batches, batch_valids, base_id)``: the batch's copy on each
        shard's device (one copy a device, shared by the shards on it)."""
        m = len(embn)
        mp = batch_bucket(max(m, 1))
        base_id = self.count
        self.ensure(base_id + mp)
        note_shape("append", self.capacity, mp)
        block = np.zeros((mp, self.dp), np.float32)
        block[:m, : self.emb_dim] = embn
        block_t, bvalid_t = torch.from_numpy(block), torch.from_numpy(np.arange(mp) < m)
        moved = {d: (block_t.to(d, copy=True), bvalid_t.to(d, copy=True))
                 for d in self.mesh.distinct}  # move the batch
        rows = self.rows_per_shard
        for s in range(base_id // rows, -(-(base_id + mp) // rows)):
            a, b = max(base_id, s * rows), min(base_id + mp, (s + 1) * rows)
            batch, bvalid = moved[self.mesh.devices[s]]
            self.emb_s[s][a - s * rows:b - s * rows].copy_(batch[a - base_id:b - base_id])
            self.valid_s[s][a - s * rows:b - s * rows].copy_(bvalid[a - base_id:b - base_id])
            self.kth_s[s][a - s * rows:b - s * rows].fill_(-np.inf)
        self.count += m
        self.appends += 1
        return (tuple(moved[d][0] for d in self.mesh.devices),
                tuple(moved[d][1] for d in self.mesh.devices), base_id)

    def landmark_rows(self, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` as one tensor on the mesh's first device (the
        range may span shards)."""
        rows = self.rows_per_shard
        parts = [self.emb_s[s][max(lo, s * rows) - s * rows:min(hi, (s + 1) * rows) - s * rows]
                 for s in range(lo // rows, -(-hi // rows))] if hi > lo else []
        if not parts:
            return torch.zeros((0, self.dp), dtype=torch.float32, device=self.device)
        return torch.cat([t.to(self.device) for t in parts])

    def landmark_gather(self, ids: np.ndarray) -> torch.Tensor:
        """The sampled landmark rows by global id, gathered in their owner
        shards, as one tensor on the mesh's first device."""
        ids = np.asarray(ids, np.int64)
        out = torch.zeros((len(ids), self.dp), dtype=torch.float32, device=self.device)
        for s, local, sel in self._owners(ids):
            got = self.emb_s[s][self._put_on(local, s)]
            out[torch.from_numpy(sel).to(self.device)] = got.to(self.device)
        return out

    def _put_on(self, a: np.ndarray, s: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.mesh.devices[s])

    def kill(self, ids: np.ndarray) -> None:
        if not len(ids):
            return
        note_shape("kill", self.capacity, batch_bucket(len(ids)))
        for s, local, _ in self._owners(ids):
            self.valid_s[s][self._put_on(local, s)] = False

    def set_kth(self, rows: np.ndarray, vals: np.ndarray) -> None:
        if not len(rows):
            return
        note_shape("set_kth", self.capacity, batch_bucket(len(rows)))
        vals = np.asarray(vals, np.float32)
        for s, local, sel in self._owners(rows):
            self.kth_s[s][self._put_on(local, s)] = self._put_on(vals[sel], s)
