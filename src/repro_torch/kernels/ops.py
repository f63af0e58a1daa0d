"""Kernel dispatch layer — a capability-declaring backend registry.

Counterpart of the single-device half of ``repro.kernels.ops``.  Every
propagation backend registers a ``BackendSpec``; ``run_propagation`` and
``select_backend`` iterate the registry instead of hard-coding names.

Registered backends:

  * ``"ref"``      — the plain torch engine (``core.propagate.propagate``),
                     the right answer on the CPU and the yardstick on the
                     card.
  * ``"ell_cuda"`` — the frontier loop around the hand-written CUDA sweep
                     (``propagate_ell``; kernel in ``kernels.ell_propagate``).
                     The counterpart of the reference's ``ell_pallas``.
  * ``"bsr"``      — the aggregation as a block-sparse SpMV over
                     component-ordered rows (``propagate_bsr``; kernel in
                     ``kernels.bsr_spmv``), tiles scattered on the device
                     from the ELL tensor and a host slot map.  Taken only
                     when asked for by name.
  * ``"landmark"`` — the approximate hot/cold split of the streaming engine
                     (``kernels.landmark_propagate``): the engine stages the
                     hot working set with the cold tail folded in as
                     boundary weights, and serves the cold tail from a
                     low-rank landmark pass at commit.  The staged problem
                     is solved exactly (``propagate_ell`` on a CUDA device,
                     ``propagate`` on the CPU), so a standalone call gets
                     the exact answer.  Auto-eligible only when the caller
                     declares ``ProblemInfo.landmark_ready`` and the rows
                     reach ``LANDMARK_AUTO_MIN_ROWS``.

``backend=None``/``"auto"`` takes the highest-priority backend whose
``auto_eligible`` accepts the solve: ``landmark`` where the engine runs
the hot/cold machinery (above), else ``ell_cuda`` on a CUDA device at
every size (the reference's TPU row threshold was never measured on a
GPU), ``ref`` on the CPU.  ``bsr`` is never auto-eligible here: the
reference admits it on a TPU only, above a tile fill
(``bsr_auto_fill_min``) that no measurement on the H100 has made a case
for.  The ``REPRO_BACKEND`` environment variable replaces the auto default
(a fleet-wide hint): an explicitly passed backend still wins, and a hint
naming a backend with no sharded form degrades to the auto scan for a
sharded solve instead of failing.

Every backend declares whether it has a mesh form (``sharded``); all four
do, over ``core.distributed``, under either transport.  ``run_propagation(mesh=...)`` or
``shard_plan=`` takes that arm.

``propagate_full_ell`` is ITLP's iteration (every row, every sweep) through
the same sweep kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.core.components import component_order, permute_ell_rows
from repro_torch.core.propagate import (PropagateResult, PropagationProblem, _delta,
                                        _max_abs, bsr_update_island, frontier_live,
                                        propagate)
from repro_torch.core.snapshot import bucket_k
from repro_torch.device import resolve_device
from repro_torch.kernels.bsr_spmv import bsr_spmv, ell_bsr_layout, fill_bsr_blocks
from repro_torch.kernels.ell_propagate import ell_propagate_step

# auto may take the approximate landmark backend only at row counts where
# exact staging pressure is real (the reference's threshold)
LANDMARK_AUTO_MIN_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class ProblemInfo:
    """What auto-selection may know about a solve.

    ``block_fill`` is the post-component-reorder BSR fill; only the
    streaming engine measures it (at rung entry).  ``landmark_ready``
    declares that the caller runs the landmark hot/cold machinery (the
    engine does, once its landmark state is sampled); plain callers leave
    it False, which keeps ``landmark`` out of their auto scan."""

    device_type: str  # "cuda" or "cpu"
    num_rows: int | None = None
    block_fill: float | None = None
    sharded: bool = False
    landmark_ready: bool = False


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One propagation backend's declared capabilities."""

    name: str
    auto_priority: int  # auto scans high → low
    auto_eligible: Callable[[ProblemInfo], bool]
    run: Callable  # (problem, f0, frontier0, *, delta, max_iters) -> PropagateResult
    sharded: bool = True  # has a core.distributed per-shard update body
    # tile edge per device type, for a backend that tiles its aggregation
    # (its ``run`` then also takes slot=, num_slots=, block_size=)
    block_size: Callable[[str], int] | None = None


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(spec: BackendSpec) -> BackendSpec:
    """Add a backend to the dispatch registry (last registration wins)."""
    _REGISTRY[spec.name] = spec
    return spec


def backend_names() -> tuple[str, ...]:
    """Registered backend names, registration order."""
    return tuple(_REGISTRY)


def backend_spec(name: str) -> BackendSpec:
    """The registered ``BackendSpec`` for ``name`` (raises on unknown)."""
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"unknown backend {name!r}; want one of {backend_names()}")
    return spec


def bsr_block_size(device_type: str = "cuda") -> int:
    """The ``bsr`` backend's tile edge on ``device_type``."""
    return backend_spec("bsr").block_size(device_type)


def bsr_auto_fill_min(device_type: str = "cuda") -> float:
    """The touched-tile fill at which a tile product pays for its padding:
    a tile costs its BS² entries whatever their fill, an ELL lane costs one
    edge, so the break-even density scales as ~2/BS (the reference's
    rule).  ``bsr`` is not auto-eligible on ``cpu`` or ``cuda`` at any
    fill; the threshold is kept beside the tile edge it follows from."""
    return 2.0 / bsr_block_size(device_type)


def _by_priority() -> list[BackendSpec]:
    return sorted(_REGISTRY.values(), key=lambda s: -s.auto_priority)


def _auto_select(info: ProblemInfo) -> str:
    for spec in _by_priority():
        if info.sharded and not spec.sharded:
            continue
        if spec.auto_eligible(info):
            return spec.name
    raise RuntimeError("no auto-eligible backend registered")  # pragma: no cover


def select_backend(backend: str | None = None,
                   problem: PropagationProblem | None = None,
                   *,
                   device: str | torch.device | None = None,
                   num_rows: int | None = None,
                   sharded: bool = False,
                   block_fill: float | None = None,
                   landmark_ready: bool = False,
                   use_env: bool = True) -> str:
    """Resolve ``backend`` (None/"auto" → the ``REPRO_BACKEND`` hint, else a
    registry scan on ``device``'s type, which defaults to the problem's
    device, else ``cuda``).

    An explicit backend wins.  A hint naming a backend with no sharded form
    degrades to the auto scan when ``sharded`` (a fleet-wide hint must not
    kill a stream).  ``use_env=False`` skips the hint: the streaming engine
    reads it once at construction (its row padding and candidate set depend
    on it), so a mid-stream change of the variable does not reach later
    rungs."""
    from_env = False
    if backend in (None, "auto"):
        backend = os.environ.get("REPRO_BACKEND", "auto") if use_env else "auto"
        from_env = backend != "auto"
    if device is None:
        device = problem.device if problem is not None else "cuda"
    if num_rows is None and problem is not None:
        num_rows = problem.num_unlabeled
    info = ProblemInfo(device_type=torch.device(device).type, num_rows=num_rows,
                       block_fill=block_fill, sharded=sharded, landmark_ready=landmark_ready)
    if backend == "auto":
        return _auto_select(info)
    spec = backend_spec(backend)
    if from_env and sharded and not spec.sharded:
        return _auto_select(info)
    return spec.name


def backend_candidates(backend: str | None = None, *,
                       device: str | torch.device = "cuda",
                       sharded: bool = False) -> tuple[str, ...]:
    """Every backend ``backend`` could resolve to on ``device``, the
    ``REPRO_BACKEND`` hint included.

    The streaming engine asks once, at construction, whether ``bsr`` is
    among them; only then does it pad rows to the tile edge and measure
    the tile fill at each rung's entry.  The scan is optimistic: every
    measured property at its most favourable, ``landmark_ready`` too."""
    if backend not in (None, "auto"):
        return (backend_spec(backend).name,)
    env = os.environ.get("REPRO_BACKEND", "auto")
    if env != "auto":
        spec = backend_spec(env)
        if not (sharded and not spec.sharded):
            return (spec.name,)
    optimistic = ProblemInfo(device_type=torch.device(device).type, block_fill=1.0,
                             sharded=sharded, landmark_ready=True)
    return tuple(s.name for s in _by_priority()
                 if (not sharded or s.sharded) and s.auto_eligible(optimistic))


def propagate_ell(
    problem: PropagationProblem,
    f0: torch.Tensor,
    frontier0: torch.Tensor,
    delta: float = 1e-4,
    max_iters: int = 100_000,
) -> PropagateResult:
    """Frontier propagation loop driven by the fused sweep kernel.

    Per sweep: the kernel, then ``changed &= valid``, the frontier
    expansion ``(changed | any(changed[nbr] & mask)) & valid`` and the
    residual, as plain torch ops.  The frontier test costs one host sync
    per sweep; ``iterations`` counts the sweeps.
    """
    p = problem
    mask = p.nbr >= 0
    idx = torch.where(mask, p.nbr, 0)
    f = f0.to(torch.float32).contiguous()
    frontier = (frontier0 & p.valid).contiguous()
    it = 0
    resid = torch.zeros((), dtype=torch.float32, device=p.device)
    while it < max_iters and frontier_live(frontier):
        f_new, changed = ell_propagate_step(p.nbr, p.wgt, p.wl0, p.wl1,
                                            frontier, f, delta=delta)
        changed = changed & p.valid
        nbr_changed = (changed[idx] & mask).any(dim=1)
        frontier = (changed | nbr_changed) & p.valid
        resid = _max_abs(f_new - f)
        f, it = f_new, it + 1
    return PropagateResult(f=f, iterations=it, converged=not bool(frontier.any()),
                           max_residual=float(resid))


def propagate_full_ell(
    problem: PropagationProblem,
    f0: torch.Tensor,
    delta: float = 1e-4,
    max_iters: int = 100_000,
) -> PropagateResult:
    """ITLP's full iteration (``core.propagate.propagate_full``) through the
    fused sweep kernel: every valid row updates every sweep (the frontier
    is ``valid``, the rows ``propagate_full`` updates), until no row's
    ``changed`` is set, which is ``max|ΔF| > δ`` on the same float32
    values.  One host sync a sweep; the residual is reduced once, after
    the last sweep.  Gives ``propagate_full``'s bits and iteration count.
    """
    p = problem
    on = p.valid.contiguous()
    f = prev = f0.to(torch.float32).contiguous()
    it = 0
    moving = True
    while it < max_iters and moving:
        prev, (f, changed) = f, ell_propagate_step(p.nbr, p.wgt, p.wl0, p.wl1, on, f,
                                                   delta=delta)
        it += 1
        moving = bool(changed.any())
    resid = float(_max_abs(f - prev)) if it else float("inf")
    return PropagateResult(f=f, iterations=it, converged=bool(it) and not moving,
                           max_residual=resid)


def _bsr_fixpoint(problem: PropagationProblem, slot: torch.Tensor, f0: torch.Tensor,
                  frontier0: torch.Tensor, delta: float, max_iters: int,
                  block_size: int, num_slots: int) -> PropagateResult:
    """Frontier fixpoint with the aggregation as a BSR SpMV.  The tiles
    are scattered from the staged ELL arrays once per solve, on the
    device.  Per sweep: the SpMV, ``bsr_update_island`` on frontier rows,
    then the residual, ``changed`` and the frontier expansion as plain
    torch ops; one host sync per sweep, and ``iterations`` counts sweeps."""
    p = problem
    blocks, bcols = fill_bsr_blocks(p.nbr, p.wgt, slot, block_size=block_size,
                                    num_slots=num_slots)
    mask = p.nbr >= 0
    idx = torch.where(mask, p.nbr, 0)
    delta_ = _delta(delta, p.device)
    wall = p.wall()
    n = p.num_unlabeled
    f = f0.to(torch.float32).contiguous()
    frontier = frontier0 & p.valid
    it = 0
    resid = torch.zeros((), dtype=torch.float32, device=p.device)
    while it < max_iters and frontier_live(frontier):
        y = bsr_spmv(blocks, bcols, f)[:n]
        f_all = bsr_update_island(y, p.wl1, wall, f)
        f_new = torch.where(frontier & p.valid, f_all, f)
        step = (f_new - f).abs()
        changed = (step > delta_) & p.valid
        nbr_changed = (changed[idx] & mask).any(dim=1)
        frontier = (changed | nbr_changed) & p.valid
        f, it, resid = f_new, it + 1, _max_abs(step)
    return PropagateResult(f=f, iterations=it, converged=not bool(frontier.any()),
                           max_residual=float(resid))


def propagate_bsr(
    problem: PropagationProblem,
    f0: torch.Tensor,
    frontier0: torch.Tensor,
    delta: float = 1e-4,
    max_iters: int = 100_000,
    block_size: int | None = None,
    slot: torch.Tensor | np.ndarray | None = None,
    num_slots: int | None = None,
) -> PropagateResult:
    """Frontier propagation with the aggregation as a BSR SpMV.

    Streaming callers (``core.stream.StreamEngine``) pass a problem already
    in component order, its per-edge ``slot`` map and the rung's tile-slot
    budget ``num_slots`` (``kernels.bsr_spmv.ell_bsr_layout``).  One-shot
    callers pass neither: the rows are then component-ordered on the host
    (paper Step 1), laid out in O(nnz), solved in that order and folded
    back, with no dense (U, U) matrix at any size.
    """
    if block_size is None:
        block_size = bsr_block_size(problem.device.type)
    dev = problem.device
    if slot is not None:
        if num_slots is None:
            raise ValueError("propagate_bsr with slot= needs num_slots= "
                             "(the tile-slot budget)")
        if problem.num_unlabeled % block_size:
            raise ValueError(f"rows {problem.num_unlabeled} not a multiple of "
                             f"block_size {block_size}")
        if isinstance(slot, np.ndarray):
            if slot.size and int(slot.max()) >= num_slots:
                # a slot past the budget would belong to the next block
                # row's tile: refuse (a device slot map's caller checked
                # its budget, and fill_bsr_blocks drops such lanes)
                raise ValueError(
                    f"slot map needs {int(slot.max()) + 1} tile slots but "
                    f"num_slots={num_slots}; pass the layout's num_slots "
                    "(padded up is fine)")
            slot = torch.from_numpy(slot)
        return _bsr_fixpoint(problem, slot.to(dev), f0, frontier0, delta, max_iters,
                             block_size, num_slots)

    # one-shot: reorder + layout on the host, O(nnz)
    n = problem.num_unlabeled
    pad = (-n) % block_size
    nbr_h = problem.nbr.cpu().numpy()
    if pad:
        nbr_h = np.concatenate([nbr_h, np.full((pad, nbr_h.shape[1]), -1, np.int32)])
    order = component_order(nbr_h)
    nbr_p, inv = permute_ell_rows(nbr_h, order)
    layout = ell_bsr_layout(nbr_p, block_size)
    order_dev = torch.from_numpy(order).to(dev)

    def rpad(x, fill=0):
        """Pad per-row tensors to the block multiple, then permute."""
        if pad:
            x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                         dtype=x.dtype, device=dev)])
        return x[order_dev].contiguous()

    pp = PropagationProblem(
        nbr=torch.from_numpy(nbr_p).to(dev), wgt=rpad(problem.wgt),
        wl0=rpad(problem.wl0), wl1=rpad(problem.wl1), valid=rpad(problem.valid, False))
    res = _bsr_fixpoint(pp, torch.from_numpy(layout.slot).to(dev),
                        rpad(f0.to(dev, torch.float32)), rpad(frontier0.to(dev), False),
                        delta, max_iters, block_size, bucket_k(layout.num_slots))
    return res._replace(f=res.f[torch.from_numpy(inv[:n]).to(dev)])


def _run_landmark(problem, f0, frontier0, *, delta, max_iters):
    """The landmark backend's solve: the exact one on the staged (hot)
    problem, ``propagate_ell`` on a CUDA device and ``propagate`` on the
    CPU; the approximation lives in how the engine stages for it."""
    run = propagate_ell if problem.device.type == "cuda" else propagate
    return run(problem, f0, frontier0, delta=delta, max_iters=max_iters)


register_backend(BackendSpec(
    name="ref",
    auto_priority=10,  # the always-eligible floor of the scan
    auto_eligible=lambda info: True,
    run=propagate,
))

register_backend(BackendSpec(
    name="ell_cuda",
    auto_priority=20,
    auto_eligible=lambda info: info.device_type == "cuda",
    run=propagate_ell,
))

register_backend(BackendSpec(
    name="bsr",
    auto_priority=30,  # the reference's rank: above the ELL kernel where eligible
    # the reference admits bsr on a TPU only; on the H100 no measurement
    # says a tile product beats the ELL sweep, so it is taken by name only
    auto_eligible=lambda info: False,
    run=propagate_bsr,
    # 8 on the card: the simple kernel uses no tensor cores, so a larger
    # edge buys nothing yet, and on this repo's kNN streams it only
    # multiplies the bytes (touched-tile fill 0.016 at 8 against 0.0043 at
    # 16, PERF.md).  8 on the CPU as the reference off TPU, so the host
    # state stays byte-identical to the JAX package's.
    block_size=lambda device_type: 8,
))

register_backend(BackendSpec(
    name="landmark",
    auto_priority=40,  # when the caller runs hot/cold, scale wins
    auto_eligible=lambda info: info.landmark_ready and (
        info.num_rows is None or info.num_rows >= LANDMARK_AUTO_MIN_ROWS),
    run=_run_landmark,
))


def run_propagation(
    problem,
    f0,
    frontier0,
    *,
    delta: float = 1e-4,
    max_iters: int = 100_000,
    backend: str | None = None,
    device: str | torch.device | None = None,
    stream: torch.cuda.Stream | None = None,
    slot: torch.Tensor | np.ndarray | None = None,
    num_slots: int | None = None,
    block_size: int | None = None,
    mesh=None,
    shard_plan=None,
    transport: str | None = None,
    export_max: int | None = None,
) -> PropagateResult:
    """Single propagation entry point: the solve runs on ``device``
    (``None`` → ``cuda``), with the inputs moved there, through the
    backend ``select_backend`` resolves.

    ``stream`` (CUDA only) is the stream the solve's work is queued on; the
    caller orders it after whatever produced the inputs (``StreamEngine``
    runs each solve on a side stream behind an event).  ``None`` queues on
    the current stream.  ``slot``/``num_slots``/``block_size`` go to a
    tiled backend (``bsr``): the per-edge tile-slot map of a problem
    already in component order and its slot budget, which
    ``StreamEngine`` derives per Δ_t; without them ``bsr`` orders and lays
    out the problem itself.

    ``mesh`` (a ``core.distributed.DeviceMesh``) takes the sharded arm:
    the backend's update body runs per shard over the transport
    ``transport`` (``"allgather"``, the default, or ``"halo"``, which
    needs ``export_max`` and the rows already in a halo export-prefix
    layout, ``core.snapshot.apply_halo_layout``); the problem's row count
    must split over the mesh.  ``problem``/``f0``/``frontier0`` are then
    whole (host or device) arrays, staged over the shards here.  Callers
    that stream pass a prebuilt ``shard_plan`` (one per rung, which fixes
    the transport) with a ``core.distributed.MeshProblem`` and per-shard
    ``f0``/``frontier0``/``slot`` blocks.  ``bsr`` on a mesh needs
    ``slot``/``num_slots``."""
    sharded = mesh is not None or shard_plan is not None
    if transport not in (None, "allgather", "halo"):
        raise ValueError(f"unknown transport {transport!r}; want 'allgather' or 'halo'")
    if transport == "halo" and not sharded:
        raise ValueError("transport='halo' needs mesh= or a shard_plan (single-device "
                         "solves have no collective)")
    if sharded:
        return _run_sharded(problem, f0, frontier0, delta=delta, max_iters=max_iters,
                            backend=backend, mesh=mesh, plan=shard_plan, transport=transport,
                            export_max=export_max, slot=slot, num_slots=num_slots,
                            block_size=block_size)
    dev = resolve_device(device)
    if stream is not None and dev.type != "cuda":
        raise ValueError(f"stream= needs a CUDA device, got {dev}")
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        problem = problem.to(dev)
        spec = backend_spec(select_backend(backend, problem))
        tiled = {}
        if spec.block_size is not None:
            tiled = dict(slot=slot, num_slots=num_slots, block_size=block_size)
        elif any(v is not None for v in (slot, num_slots, block_size)):
            raise ValueError(f"backend {spec.name!r} takes no slot map "
                             "(slot=/num_slots=/block_size= are for bsr)")
        return spec.run(problem, f0.to(dev), frontier0.to(dev),
                        delta=delta, max_iters=max_iters, **tiled)


def _run_sharded(problem, f0, frontier0, *, delta, max_iters, backend, mesh, plan,
                 transport, export_max, slot, num_slots, block_size) -> PropagateResult:
    """``run_propagation``'s mesh arm (see there)."""
    from repro_torch.core import distributed

    dev = (plan.mesh if plan is not None else mesh).device
    backend = select_backend(backend, device=dev, num_rows=problem.num_unlabeled,
                             sharded=True)
    spec = backend_spec(backend)
    if not spec.sharded:
        raise ValueError(f"backend {backend!r} is single-device only; registry sharded "
                         f"backends: {tuple(s.name for s in _REGISTRY.values() if s.sharded)}")
    if plan is None:
        bsr_kw = {}
        if backend == "bsr":
            if slot is None or num_slots is None:
                raise ValueError("sharded backend='bsr' needs slot= and num_slots= (the "
                                 "per-edge BSR slot map and its tile budget from "
                                 "kernels.bsr_spmv.ell_bsr_layout)")
            bsr_kw = dict(block_size=(block_size if block_size is not None
                                      else bsr_block_size(dev.type)), num_slots=num_slots)
        shape = tuple(problem.nbr.shape)
        if transport == "halo":
            if export_max is None:
                raise ValueError("transport='halo' without a shard_plan needs export_max "
                                 "(the per-shard export-prefix length)")
            plan = distributed.build_stream_halo_plan(mesh, shape, export_max, backend=backend,
                                                      delta=delta, max_iters=max_iters, **bsr_kw)
        else:
            plan = distributed.build_stream_plan(mesh, shape, backend=backend, delta=delta,
                                                 max_iters=max_iters, **bsr_kw)
        problem = plan.put_problem(problem.nbr, problem.wgt, problem.wl0, problem.wl1,
                                   problem.valid)
        f0, frontier0 = plan.put_row(f0), plan.put_row(frontier0)
        if slot is not None:
            slot = plan.put_row(slot)
    else:
        # the plan's own settings drive the solve: refuse arguments that
        # disagree with them
        want = (backend, float(delta), max_iters,
                transport if transport is not None else plan.transport)
        have = (plan.backend, plan.delta, plan.max_iters, plan.transport)
        if want != have:
            raise ValueError(f"shard_plan mismatch: called with (backend, delta, max_iters, "
                             f"transport)={want} but the plan was built with {have}")
        if backend == "bsr" and num_slots is not None and num_slots != plan.num_slots:
            raise ValueError(f"shard_plan mismatch: num_slots={num_slots} but the plan "
                             f"has {plan.num_slots}")
    if plan.backend == "bsr" and isinstance(slot, np.ndarray):
        slot = plan.put_row(slot)
    return plan(problem, f0, frontier0, slot=slot)
