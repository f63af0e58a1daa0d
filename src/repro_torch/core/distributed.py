"""Vertex-partitioned label propagation over a single-process device mesh.

Counterpart of ``repro.core.distributed``.  The reference shards rows over
a ``jax.sharding.Mesh`` with ``shard_map`` in one process; the port's mesh
is a ``DeviceMesh``: an ordered tuple of ``torch.device``s, one per shard,
where a device may repeat.  ``DeviceMesh.local(8, device="cpu")`` is eight
shards on the CPU (the tests' mesh), ``DeviceMesh.local(8)`` eight shards
on the card, ``DeviceMesh.visible()`` one shard per visible card.

Each shard owns a contiguous row block as tensors of its own, on its
device: shard s holds rows ``[s·m, (s+1)·m)`` of the ELL problem, whose
neighbor ids index the GLOBAL label vector.  A collective is a set of
explicit copies between the shards' tensors (peer copies across cards,
device copies on one card), so the sharded code runs and moves its bytes
even when every shard sits on one card.  Per sweep:

    gather F  →  each shard's update  →  δ-threshold  →  gather changed
    →  each shard's frontier  →  one ``any`` over the shards' flags

The ``any`` is the one host sync a sweep, as in the single-device loop.

The per-shard update body is the selected single-device backend's:
``ref`` is ``core.propagate.update_island`` (plain torch); ``ell_cuda``
launches the sweep kernel over the shard's rows with ``row_offset = s·m``;
``bsr`` scatters the shard's tiles once a solve (``fill_bsr_blocks``,
block columns global) and runs the SpMV kernel against the gathered
full-length F; ``landmark`` (whose hot/cold split is staging, done by the
engine) solves exactly with the ``ell_cuda`` body, as its single-device
solve does.  Every body does the single-device arithmetic row for row, so
sharded labels equal the single-device engine's bit for bit.

Two transports build the gathered vector:

  * ``"allgather"`` copies every shard's block into one (N,) buffer per
    device, which the shards on that device share.
  * ``"halo"`` copies only each shard's first ``export_max`` rows: rows are
    laid out so every cross-shard-referenced row leads its shard
    (``graph.partition.build_halo_plan``).  Each shard gets a substitute
    vector of its own: its own block exact, the other shards' export
    prefixes, zeros elsewhere.  Shards that share a device do not share
    it (a shared buffer would hold every shard's full block, all-gather
    under another name).  The substitute equals the all-gathered F at
    every position a shard reads, so the labels are the same bits.

Each gather counts the bytes it copies (``PropagateResult.transport_bytes``).
On one card halo copies more than all-gather: every shard's substitute is
written, where all-gather writes one buffer the shards share; halo saves
bytes only between cards.

``StreamShardPlan``/``StreamHaloPlan`` package a transport for
``core.stream.StreamEngine``: one plan per ladder rung (and export budget),
memoized; ``StoreShardPlan`` is the row-sharded embedding store's
candidate sweep (``kernels.argkmin.shard_sweep``).  PyTorch has no jit
cache, so ``plan_count`` and ``store_plan_count`` count the plans built in
place of the reference's cache sizes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.propagate import (PropagateResult, PropagationProblem, _delta, _max_abs,
                                        bsr_update_island, update_island)
from repro_torch.core.snapshot import ViewSharding
from repro_torch.device import resolve_device
from repro_torch.graph.structures import PAD
from repro_torch.kernels.bsr_spmv import bsr_spmv, fill_bsr_blocks
from repro_torch.kernels.ell_propagate import ell_propagate_step

STREAM_BACKENDS = ("ref", "ell_cuda", "bsr", "landmark")
TRANSPORTS = ("allgather", "halo")


def _normalize(device) -> torch.device:
    """``resolve_device``, with a bare ``cuda`` pinned to its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """A single-process device mesh: one ``torch.device`` per shard, in
    shard order.  A device may repeat (several shards on one card or on the
    CPU); all shards share one device type."""

    def __init__(self, devices):
        devs = tuple(_normalize(d) for d in devices)
        if not devs:
            raise ValueError("a DeviceMesh needs at least one shard")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a DeviceMesh's shards share one device type, got {devs}")
        self.devices = devs

    @classmethod
    def local(cls, n: int, device: str | torch.device | None = None) -> "DeviceMesh":
        """``n`` shards on one device (``None`` → ``cuda``; raises when
        there is none, as ``resolve_device`` does)."""
        if n < 1:
            raise ValueError(f"a DeviceMesh needs at least one shard, got {n}")
        return cls([_normalize(device)] * n)

    @classmethod
    def visible(cls) -> "DeviceMesh":
        """One shard per visible CUDA device (collectives are peer copies)."""
        resolve_device("cuda")
        return cls([torch.device("cuda", i) for i in range(torch.cuda.device_count())])

    @property
    def n_devices(self) -> int:
        """Shards in the mesh (the reference's ``mesh.devices.size``)."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first shard's device: where results and the engine live."""
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices without repeats, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


# ---------------------------------------------------------------------- #
# Serving read placement
# ---------------------------------------------------------------------- #
def read_replica_device(mesh: DeviceMesh) -> torch.device | None:
    """The first visible CUDA device outside ``mesh``: the serving read
    replica, whose gathers never queue behind the solve's work.  None on a
    CPU mesh or when the mesh covers every card."""
    if mesh.device.type != "cuda":
        return None
    used = set(mesh.devices)
    for i in range(torch.cuda.device_count()):
        if torch.device("cuda", i) not in used:
            return torch.device("cuda", i)
    return None


def view_sharding(mesh: DeviceMesh) -> ViewSharding:
    """The committed view's node axis cut into one contiguous block per
    distinct mesh device.  On a mesh whose shards all sit on one device the
    sharded view is that device's one view."""
    return ViewSharding(mesh.distinct)


def read_placement(mesh: DeviceMesh | None):
    """Default placement for published device views: None (the engine's
    device) without a mesh; with one, the read replica if a spare card
    exists, else ``view_sharding``."""
    if mesh is None:
        return None
    return read_replica_device(mesh) or view_sharding(mesh)


# ---------------------------------------------------------------------- #
# Sharded problems
# ---------------------------------------------------------------------- #
class ShardedProblem(NamedTuple):
    """PropagationProblem padded to a multiple of the device count."""

    problem: PropagationProblem
    n_orig: int


def pad_problem(problem: PropagationProblem, n_devices: int) -> ShardedProblem:
    n = problem.num_unlabeled
    pad = (-n) % n_devices
    if pad == 0:
        return ShardedProblem(problem, n)

    def rows(x, fill):
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    padded = PropagationProblem(nbr=rows(problem.nbr, PAD), wgt=rows(problem.wgt, 0),
                                wl0=rows(problem.wl0, 0), wl1=rows(problem.wl1, 0),
                                valid=rows(problem.valid, False))
    return ShardedProblem(padded, n)


@dataclasses.dataclass
class MeshProblem:
    """A problem cut into the mesh's row blocks: shard s's
    ``PropagationProblem`` holds rows ``[s·m, (s+1)·m)`` on its device,
    neighbor ids global."""

    shards: tuple[PropagationProblem, ...]

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].num_unlabeled

    @property
    def num_unlabeled(self) -> int:
        return self.rows_per_shard * len(self.shards)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_unlabeled, self.shards[0].nbr.shape[1])


def shard_rows(mesh: DeviceMesh, x) -> tuple[torch.Tensor, ...]:
    """A per-row array (numpy or tensor, rows first) cut into the mesh's
    contiguous row blocks, each copied to its shard's device."""
    n, d = len(x), mesh.n_devices
    if n % d:
        raise ValueError(f"{n} rows do not split over {d} shards")
    m = n // d
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return tuple(t[s * m:(s + 1) * m].to(dev, copy=True) for s, dev in enumerate(mesh.devices))


def shard_problem(mesh: DeviceMesh, nbr, wgt, wl0, wl1, valid) -> MeshProblem:
    """Host or device arrays of one problem cut into the mesh's shards."""
    cols = [shard_rows(mesh, a) for a in (nbr, wgt, wl0, wl1, valid)]
    return MeshProblem(tuple(PropagationProblem(*parts) for parts in zip(*cols)))


# ---------------------------------------------------------------------- #
# The transports
# ---------------------------------------------------------------------- #
class _Gather:
    """One vector's per-sweep collective over a solve: every shard's view
    of the global (N,) vector, built by explicit copies between the
    shards' tensors.  ``bytes`` counts what the copies wrote."""

    def __init__(self, mesh: DeviceMesh, m: int, transport: str, export_max: int | None,
                 dtype: torch.dtype):
        self.mesh, self.m, self.transport = mesh, m, transport
        self.bytes = 0
        self._isz = torch.empty((), dtype=dtype).element_size()
        n = mesh.n_devices * m
        if transport == "allgather":
            # one buffer per device, shared by the shards on it
            self._bufs = {d: torch.empty(n, dtype=dtype, device=d) for d in mesh.distinct}
        else:
            # one substitute per SHARD, zeros outside the export prefixes
            self._e = min(export_max, m)
            self._bufs = [torch.zeros(n, dtype=dtype, device=d) for d in mesh.devices]

    def __call__(self, blocks) -> list[torch.Tensor]:
        mesh, m, nd = self.mesh, self.m, self.mesh.n_devices
        if self.transport == "allgather":
            for d, buf in self._bufs.items():
                torch.cat([b.to(d, non_blocking=True) for b in blocks], out=buf)
                self.bytes += nd * m * self._isz
            return [self._bufs[d] for d in mesh.devices]
        e = self._e
        for d in mesh.distinct:
            exports = torch.cat([b[:e].to(d, non_blocking=True) for b in blocks])
            self.bytes += nd * e * self._isz
            for s in range(nd):
                if mesh.devices[s] != d:
                    continue
                buf = self._bufs[s]
                buf.view(nd, m)[:, :e].copy_(exports.view(nd, e))
                buf[s * m:(s + 1) * m].copy_(blocks[s])  # own block exact
                self.bytes += (nd * e + m) * self._isz
        return self._bufs


def timed_ms(mesh: DeviceMesh, fn) -> float:
    """``fn()`` timed in ms: CUDA events around it on every card of the
    mesh (the longest of them), the host clock on a CPU mesh."""
    cards = [d for d in mesh.distinct if d.type == "cuda"]
    if not cards:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    for d in cards:
        torch.cuda.synchronize(d)
    start = {d: torch.cuda.Event(enable_timing=True) for d in cards}
    end = {d: torch.cuda.Event(enable_timing=True) for d in cards}
    for d in cards:
        start[d].record(torch.cuda.current_stream(d))
    fn()
    for d in cards:
        end[d].record(torch.cuda.current_stream(d))
    for d in cards:
        end[d].synchronize()
    return max(start[d].elapsed_time(end[d]) for d in cards)


def _any(flags, home: torch.device) -> bool:
    """One ``any`` over the shards' frontier flags: one host sync."""
    return bool(torch.stack([x.any().to(home, non_blocking=True) for x in flags]).any())


def make_sharded_propagate_fn(
    mesh: DeviceMesh,
    *,
    backend: str = "ref",
    delta: float = 1e-4,
    max_iters: int = 100_000,
    transport: str = "allgather",
    export_max: int | None = None,
    block_size: int = 0,
    num_slots: int = 0,
):
    """Build the sharded frontier solve ``run(problem: MeshProblem, f0,
    frontier0, slot=None) -> PropagateResult``.

    ``f0``/``frontier0`` (and ``bsr``'s per-edge ``slot`` map) are tuples
    of per-shard blocks.  ``iterations`` counts the sweeps, ``converged``
    is an empty frontier, ``max_residual`` the largest |ΔF| of the last
    sweep, ``f`` the solved (N,) vector on the mesh's first device, and
    ``transport_bytes`` what the two gathers (F and ``changed``) copied
    over the solve.  ``block_size``/``num_slots`` fix a ``bsr`` plan's
    tile layout: because the layout is the plan's, ``bsr`` labels are the
    same bits under both transports for the same row layout (the engine
    stages ``bsr`` in the halo layout under both for that reason).
    """
    if backend not in STREAM_BACKENDS:
        raise ValueError(f"sharded backend {backend!r} not supported; want one of "
                         f"{STREAM_BACKENDS}")
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} not supported; want one of {TRANSPORTS}")
    if transport == "halo" and (export_max is None or export_max < 1):
        raise ValueError("transport='halo' needs export_max >= 1")
    if backend == "bsr" and (block_size < 1 or num_slots < 1):
        raise ValueError("sharded backend='bsr' needs block_size >= 1 and num_slots >= 1 "
                         "(the plan's tile layout)")
    body = "ell" if backend in ("ell_cuda", "landmark") else backend

    def run(problem: MeshProblem, f0, frontier0, slot=None) -> PropagateResult:
        shards = problem.shards
        nd, m = len(shards), problem.rows_per_shard
        if nd != mesh.n_devices:
            raise ValueError(f"problem has {nd} shards, the mesh {mesh.n_devices}")
        if body == "bsr" and slot is None:
            raise ValueError("a bsr shard plan needs the per-edge slot map (slot=)")
        home = mesh.device
        masks = [p.nbr != PAD for p in shards]
        idxs = [torch.where(mk, p.nbr, 0) for mk, p in zip(masks, shards)]
        deltas = {d: _delta(delta, d) for d in mesh.distinct}
        f = [x.to(torch.float32).contiguous() for x in f0]
        fr = [(x & p.valid).contiguous() for x, p in zip(frontier0, shards)]
        gather_f = _Gather(mesh, m, transport, export_max, torch.float32)
        gather_c = _Gather(mesh, m, transport, export_max, torch.bool)
        # Wall is loop-invariant; update_island and the bsr update take it as
        # PropagationProblem.wall() sums it (the sweep kernel sums its own)
        walls = [p.wall() for p in shards] if body != "ell" else None
        if body == "bsr":  # once a solve; block columns stay global
            tiles = [fill_bsr_blocks(p.nbr, p.wgt, sl, block_size=block_size,
                                     num_slots=num_slots) for p, sl in zip(shards, slot)]
        prev, it = f, 0
        while it < max_iters and _any(fr, home):
            full = gather_f(f)
            new_f, changed = [], []
            for s, p in enumerate(shards):
                if body == "ell":
                    fn, ch = ell_propagate_step(p.nbr, p.wgt, p.wl0, p.wl1, fr[s], full[s],
                                                delta=delta, row_offset=s * m)
                elif body == "bsr":
                    y = bsr_spmv(*tiles[s], full[s])
                    fn = torch.where(fr[s], bsr_update_island(y, p.wl1, walls[s], f[s]), f[s])
                    ch = (fn - f[s]).abs() > deltas[p.device]
                else:  # ref: the exact Jacobi arithmetic of core.propagate
                    fu = update_island(p.wgt, p.wl0, p.wl1, f[s], full[s][idxs[s]], masks[s],
                                       wall=walls[s])
                    fn = torch.where(fr[s], torch.where(p.valid, fu, f[s]), f[s])
                    ch = (fn - f[s]).abs() > deltas[p.device]
                new_f.append(fn)
                changed.append(ch & p.valid)
            seen = gather_c(changed)  # the changed-neighbor test rides the transport
            fr = [(changed[s] | (seen[s][idxs[s]] & masks[s]).any(dim=1)) & p.valid
                  for s, p in enumerate(shards)]
            prev, f, it = f, new_f, it + 1
        converged = not _any(fr, home)
        resid = max((float(_max_abs(a - b)) for a, b in zip(f, prev)), default=0.0)
        return PropagateResult(f=torch.cat([x.to(home) for x in f]), iterations=it,
                               converged=converged, max_residual=resid,
                               transport_bytes=gather_f.bytes + gather_c.bytes)

    return run


def distributed_propagate(
    problem: PropagationProblem,
    f0: torch.Tensor,
    frontier0: torch.Tensor,
    mesh: DeviceMesh,
    delta: float = 1e-4,
    max_iters: int = 100_000,
    backend: str = "ref",
) -> PropagateResult:
    """DynLP Step 3 with rows sharded over the mesh (all-gather)."""
    sp = pad_problem(problem, mesh.n_devices)
    p = sp.problem
    n = p.num_unlabeled
    pad = n - len(f0)
    f0 = torch.cat([f0.to(torch.float32), f0.new_zeros(pad, dtype=torch.float32)])
    frontier0 = torch.cat([frontier0, frontier0.new_zeros(pad, dtype=torch.bool)]) & p.valid
    plan = build_stream_plan(mesh, tuple(p.nbr.shape), backend=backend, delta=delta,
                             max_iters=max_iters)
    res = plan(plan.put_problem(p.nbr, p.wgt, p.wl0, p.wl1, p.valid), plan.put_row(f0),
               plan.put_row(frontier0))
    return res._replace(f=res.f[: sp.n_orig])


def distributed_propagate_halo(
    problem: PropagationProblem,  # rows already in HaloPlan layout
    f0: torch.Tensor,
    frontier0: torch.Tensor,
    mesh: DeviceMesh,
    export_max: int,
    delta: float = 1e-4,
    max_iters: int = 100_000,
    backend: str = "ref",
) -> PropagateResult:
    """DynLP Step 3 on the halo transport; the caller lays the rows out
    with ``graph.partition.build_halo_plan`` (which pads to the mesh)."""
    n = problem.num_unlabeled
    if n % mesh.n_devices:
        raise ValueError(f"{n} rows do not split over {mesh.n_devices} shards; lay them "
                         "out with build_halo_plan")
    plan = build_stream_halo_plan(mesh, tuple(problem.nbr.shape), export_max,
                                  backend=backend, delta=delta, max_iters=max_iters)
    p = problem
    return plan(plan.put_problem(p.nbr, p.wgt, p.wl0, p.wl1, p.valid),
                plan.put_row(f0.to(torch.float32)), plan.put_row(frontier0))


# --------------------------------------------------------------------- #
# Streaming partition plans (core.stream.StreamEngine on a mesh)
# --------------------------------------------------------------------- #
_PLAN_CACHE: dict = {}
_STORE_PLAN_CACHE: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class StreamShardPlan:
    """Shape-keyed partition plan: one per bucket-ladder rung.

    Holds what a stream needs to run batches of one bucket shape on a
    mesh: the row split used to stage host snapshots and vectors, and the
    solve.  Plans are topology-independent (contiguous row blocks), so one
    plan serves every batch in its rung (``StreamEngine.plan_builds`` ≤
    rungs touched)."""

    mesh: DeviceMesh
    bucket_key: tuple[int, int]
    backend: str
    delta: float
    max_iters: int
    run: object  # make_sharded_propagate_fn's solve
    # bsr plans carry their tile layout (0 otherwise): the engine checks
    # each Δ_t's slot requirement against num_slots before running on it
    block_size: int = 0
    num_slots: int = 0

    transport = "allgather"

    @property
    def n_devices(self) -> int:
        return self.mesh.n_devices

    @property
    def rows_per_shard(self) -> int:
        return self.bucket_key[0] // self.mesh.n_devices

    def put_row(self, x) -> tuple[torch.Tensor, ...]:
        """Stage a per-row array (host or device; a vector, or (rows, K)
        like the bsr slot map) cut over the shards by rows."""
        return shard_rows(self.mesh, x)

    def put_problem(self, nbr, wgt, wl0, wl1, valid) -> MeshProblem:
        return shard_problem(self.mesh, nbr, wgt, wl0, wl1, valid)

    def __call__(self, problem: MeshProblem, f0, frontier0, slot=None) -> PropagateResult:
        if tuple(problem.shape) != tuple(self.bucket_key):
            raise ValueError(f"problem shape {problem.shape} does not match plan rung "
                             f"{self.bucket_key}")
        if self.backend == "bsr" and slot is None:
            raise ValueError("bsr shard plan needs the per-edge slot map (stage it with "
                             "put_row)")
        return self.run(problem, f0, frontier0, slot)


@dataclasses.dataclass(frozen=True, eq=False)
class StreamHaloPlan(StreamShardPlan):
    """Per-rung halo plan: ``StreamShardPlan`` and the rung's export-prefix
    budget.  The budget (``export_max``) is fixed once per rung; the export
    layout is re-derived per Δ_t by the engine and may overshoot the real
    export set (stale prefix rows carry committed labels, which is
    harmless).  A batch whose export counts exceed the budget runs on the
    rung's all-gather twin instead."""

    export_max: int = 0

    transport = "halo"


def _check_bucket(bucket_key, mesh: DeviceMesh, block_size: int = 0) -> None:
    u_pad, _ = bucket_key
    nd = mesh.n_devices
    if u_pad % nd:
        raise ValueError(f"bucket rows {u_pad} not divisible by mesh device count {nd}; "
                         f"build snapshots with row_multiple={nd}")
    if block_size and (u_pad // nd) % block_size:
        raise ValueError(f"bsr needs each shard's {u_pad // nd} rows to be a multiple of "
                         f"block_size {block_size}; build snapshots with "
                         f"row_multiple={nd * block_size}")


def _plan(cls, mesh, bucket_key, *, backend, delta, max_iters, block_size, num_slots,
          **halo):
    _check_bucket(bucket_key, mesh, block_size if backend == "bsr" else 0)
    key = (cls, mesh, tuple(bucket_key), backend, float(delta), max_iters, block_size,
           num_slots, tuple(halo.items()))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        transport = "halo" if halo else "allgather"
        run = make_sharded_propagate_fn(
            mesh, backend=backend, delta=delta, max_iters=max_iters, transport=transport,
            export_max=halo.get("export_max"), block_size=block_size, num_slots=num_slots)
        plan = cls(mesh=mesh, bucket_key=tuple(bucket_key), backend=backend,
                   delta=float(delta), max_iters=max_iters, run=run, block_size=block_size,
                   num_slots=num_slots, **halo)
        _PLAN_CACHE[key] = plan
    return plan


def build_stream_plan(
    mesh: DeviceMesh,
    bucket_key: tuple[int, int],
    *,
    backend: str = "ref",
    delta: float = 1e-4,
    max_iters: int = 100_000,
    block_size: int = 0,
    num_slots: int = 0,
) -> StreamShardPlan:
    """Build (or fetch, memoized) the all-gather plan for one ladder rung.
    ``bucket_key[0]`` must be a multiple of the mesh's shard count (times
    ``block_size`` for ``bsr``; ``core.snapshot.build_host_problem(
    row_multiple=)`` pads to it)."""
    return _plan(StreamShardPlan, mesh, bucket_key, backend=backend, delta=delta,
                 max_iters=max_iters, block_size=block_size, num_slots=num_slots)


def build_stream_halo_plan(
    mesh: DeviceMesh,
    bucket_key: tuple[int, int],
    export_max: int,
    *,
    backend: str = "ref",
    delta: float = 1e-4,
    max_iters: int = 100_000,
    block_size: int = 0,
    num_slots: int = 0,
) -> StreamHaloPlan:
    """Halo twin of ``build_stream_plan``: one plan per (rung, export
    budget), memoized.  Callers stage problems in the export-prefix layout
    of ``graph.partition.build_halo_plan`` and guarantee
    ``export_counts.max() <= export_max`` for every batch they run on it."""
    m = bucket_key[0] // mesh.n_devices
    return _plan(StreamHaloPlan, mesh, bucket_key, backend=backend, delta=delta,
                 max_iters=max_iters, block_size=block_size, num_slots=num_slots,
                 export_max=int(min(max(1, export_max), max(m, 1))))


def plan_count() -> int:
    """Stream plans built in this process (the port's stand-in for the
    reference's ``sharded_cache_size``)."""
    return len(_PLAN_CACHE)


# --------------------------------------------------------------------- #
# Sharded embedding-store sweep plans (ingest.ShardedEmbeddingStore)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True, eq=False)
class StoreShardPlan:
    """Per-rung plan for the move-the-batch argkmin sweep over a
    row-sharded embedding store.

    Each shard keeps its ``cap / D`` store rows resident and receives the
    batch; ``sweep`` runs ``kernels.argkmin.shard_sweep`` (one pass a
    shard at its global ``row0``, the lists merged) and returns ``(val,
    idx, disp)`` on the mesh's first device, the bits of one pass over the
    unsharded store, so canonical host re-selection keeps every graph
    byte-identical to the single-device path."""

    mesh: DeviceMesh
    cap_key: tuple[int, int]  # (capacity rung, padded emb dim)

    @property
    def n_devices(self) -> int:
        return self.mesh.n_devices

    def sweep(self, emb, valid, kth, batch, bvalid, base_id, slack, *, topk: int):
        """Run the sharded candidate sweep for one appended batch: ``emb``,
        ``valid``, ``kth`` per shard, ``batch``/``bvalid`` the batch's copy
        on each shard's device."""
        from repro_torch.kernels.argkmin import shard_sweep

        cap, dp = self.cap_key
        shape = (cap // self.n_devices, dp)
        if len(emb) != self.n_devices or any(tuple(e.shape) != shape for e in emb):
            raise ValueError(f"store shards {[tuple(e.shape) for e in emb]} do not match "
                             f"plan rung {self.cap_key} over {self.n_devices} shards")
        return shard_sweep(emb, valid, kth, batch, bvalid, base_id, slack, topk=topk)


def build_store_shard_plan(mesh: DeviceMesh, cap_key: tuple[int, int]) -> StoreShardPlan:
    """Build (or fetch, memoized) the sharded-store sweep plan for one
    capacity rung; the capacity must divide over the mesh's shards."""
    cap, dp = (int(x) for x in cap_key)
    if cap % mesh.n_devices:
        raise ValueError(f"store capacity {cap} not divisible by mesh device count "
                         f"{mesh.n_devices}")
    key = (mesh, cap, dp)
    plan = _STORE_PLAN_CACHE.get(key)
    if plan is None:
        plan = StoreShardPlan(mesh=mesh, cap_key=(cap, dp))
        _STORE_PLAN_CACHE[key] = plan
    return plan


def store_plan_count() -> int:
    """Store sweep plans built in this process (the port's stand-in for
    the reference's ``store_sweep_cache_size``)."""
    return len(_STORE_PLAN_CACHE)
