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

``backend=None``/``"auto"`` takes the highest-priority backend whose
``auto_eligible`` accepts the solve: ``ell_cuda`` on a CUDA device at every
size (the reference's TPU row threshold was never measured on a GPU),
``ref`` on the CPU.  So a ``ProblemInfo`` holds the device type alone; a
backend whose eligibility depends on the problem adds the field it reads.
The port reads no environment variable to change that.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.propagate import PropagateResult, PropagationProblem, _max_abs, propagate
from repro_torch.device import resolve_device
from repro_torch.kernels.ell_propagate import ell_propagate_step


@dataclasses.dataclass(frozen=True)
class ProblemInfo:
    """What auto-selection may know about a solve."""

    device_type: str  # "cuda" or "cpu"


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One propagation backend's declared capabilities."""

    name: str
    auto_priority: int  # auto scans high → low
    auto_eligible: Callable[[ProblemInfo], bool]
    run: Callable  # (problem, f0, frontier0, *, delta, max_iters) -> PropagateResult


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


def select_backend(backend: str | None = None,
                   problem: PropagationProblem | None = None,
                   *,
                   device: str | torch.device | None = None) -> str:
    """Resolve ``backend`` (None/"auto" → registry scan on ``device``'s
    type, which defaults to the problem's device, else ``cuda``)."""
    if backend not in (None, "auto"):
        return backend_spec(backend).name
    if device is None:
        device = problem.device if problem is not None else "cuda"
    info = ProblemInfo(device_type=torch.device(device).type)
    for spec in sorted(_REGISTRY.values(), key=lambda s: -s.auto_priority):
        if spec.auto_eligible(info):
            return spec.name
    raise RuntimeError("no auto-eligible backend registered")  # pragma: no cover


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
    while it < max_iters and bool(frontier.any()):
        f_new, changed = ell_propagate_step(p.nbr, p.wgt, p.wl0, p.wl1,
                                            frontier, f, delta=delta)
        changed = changed & p.valid
        nbr_changed = (changed[idx] & mask).any(dim=1)
        frontier = (changed | nbr_changed) & p.valid
        resid = _max_abs(f_new - f)
        f, it = f_new, it + 1
    return PropagateResult(f=f, iterations=it, converged=not bool(frontier.any()),
                           max_residual=float(resid))


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


def run_propagation(
    problem: PropagationProblem,
    f0: torch.Tensor,
    frontier0: torch.Tensor,
    *,
    delta: float = 1e-4,
    max_iters: int = 100_000,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> PropagateResult:
    """Single propagation entry point: the solve runs on ``device``
    (``None`` → ``cuda``), with the inputs moved there, through the
    backend ``select_backend`` resolves."""
    dev = resolve_device(device)
    problem = problem.to(dev)
    name = select_backend(backend, problem)
    return backend_spec(name).run(problem, f0.to(dev), frontier0.to(dev),
                                  delta=delta, max_iters=max_iters)
