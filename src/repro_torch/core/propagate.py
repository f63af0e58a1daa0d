"""Iterative label propagation engines (paper Alg. 2 Step 3 and ITLP).

The torch counterpart of ``repro.core.propagate``.  The problem lives over
the *unlabeled* vertices only: labeled classes are folded into per-node
scalar weights ``wl0``/``wl1`` (the paper's supernode decomposition, §4
"Iterative Propagation"), and the ELL neighbor list holds
unlabeled-unlabeled edges.

Rounding is part of the contract.  Every sum over the neighbor axis runs in
column order 0..K-1 as separate elementwise ops (each rounded to float32 on
its own), so the hand-written CUDA sweep (``kernels.ell_propagate``), which
uses the same order and no fused multiply-add, gives the same bits.  Do not
``torch.compile`` these functions: fusion may contract a multiply and an add
into one FMA and move a row's update by one ULP.

The loops run on the host, one sweep per iteration, and check the frontier
with one device-to-host sync per sweep (``frontier_live``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch import telemetry
from repro_torch.graph.structures import PAD


@dataclasses.dataclass
class PropagationProblem:
    """One LP system over U unlabeled vertices (tensors on one device).

    Attributes:
      nbr:   (U, K) int32 — unlabeled-neighbor ids (compact), PAD for empty.
      wgt:   (U, K) float32 — weights of those edges.
      wl0:   (U,) float32 — Σ w(u, v) over v ∈ L0 (class-0 supernode edge sum).
      wl1:   (U,) float32 — Σ w(u, v) over v ∈ L1.
      valid: (U,) bool — real rows (False for bucket padding rows).
    """

    nbr: torch.Tensor
    wgt: torch.Tensor
    wl0: torch.Tensor
    wl1: torch.Tensor
    valid: torch.Tensor

    @property
    def num_unlabeled(self) -> int:
        return self.nbr.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    def to(self, device) -> "PropagationProblem":
        return PropagationProblem(
            *(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))

    def wall(self) -> torch.Tensor:
        """Total incident weight per node: unlabeled nbrs + label supernodes."""
        return _row_sum(self.wgt) + self.wl0 + self.wl1


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis in column order (not ``sum(dim=1)``, whose
    internal order is not fixed)."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _gather_labels(f: torch.Tensor, nbr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather neighbor labels; returns (labels, slot_mask)."""
    mask = nbr != PAD
    idx = torch.where(mask, nbr, 0)
    return f[idx], mask


def update_island(wgt, wl0, wl1, f, f_v, mask, wall=None):
    """The per-row Jacobi arithmetic, in the reference's op order.

    ``nbr_term = Σ_k wgt·(F_v − F_u)`` (masked lanes give 0) and
    ``Wall = Σ_k wgt + wl0 + wl1``, each summed in column order; then
    ``F' = F_u + (Wall > 0 ? ΔF / max(Wall, 1e-30) : 0)`` with
    ``ΔF = (0 − F_u)·wl0 + (1 − F_u)·wl1 + nbr_term``.  Each lane's
    difference and product is one elementwise op over the (U, K) block
    (each rounded on its own, as the per-column ops would be), then the
    lanes are added in column order.  ``wall`` may be passed in, as
    ``PropagationProblem.wall()`` computes it (it does not change across
    sweeps).
    """
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    lanes = wgt * torch.where(mask, f_v - f[:, None], zero)
    nbr_term = _row_sum(lanes)
    if wall is None:
        wall = _row_sum(wgt) + wl0 + wl1
    d_f = (0.0 - f) * wl0 + (1.0 - f) * wl1 + nbr_term
    return f + torch.where(wall > 0, d_f / torch.clamp_min(wall, 1e-30), zero)


def bsr_update_island(y, wl1, wall, f):
    """The ``bsr`` backend's per-row update: ``F' = (y + wl1) / Wall`` where
    ``Wall > 0``, else ``F``.

    ``y`` is the block-sparse aggregation ``Σ_v w(u,v)·F_v``; the weighted
    average form (paper §5) replaces the Jacobi-delta form of
    ``update_island`` because the SpMV gives the sum directly."""
    return torch.where(wall > 0, (y + wl1) / torch.clamp_min(wall, 1e-30), f)


def lp_update(problem: PropagationProblem, f: torch.Tensor) -> torch.Tensor:
    """One unmasked LP update for every row (paper Eq. in §4 / Alg.2 L28).

    F'_u = F_u + (0-F_u)·wl0/Wall + (1-F_u)·wl1/Wall + Σ_v (F_v-F_u)·w(u,v)/Wall
    which §5 proves equals the classic weighted neighborhood average.
    """
    nbr_f, mask = _gather_labels(f, problem.nbr)
    fu = update_island(problem.wgt, problem.wl0, problem.wl1, f, nbr_f, mask)
    return torch.where(problem.valid, fu, f)


def _expand_frontier(problem: PropagationProblem, changed: torch.Tensor) -> torch.Tensor:
    """Neighbors of changed vertices join the frontier (Alg.2 L30).

    The graph is undirected (both edge directions are stored), so
    "neighbors of changed" equals "rows with a changed neighbor" — a gather
    with the same ELL access pattern as the label update."""
    mask = problem.nbr != PAD
    idx = torch.where(mask, problem.nbr, 0)
    return (changed[idx] & mask).any(dim=1)


class PropagateResult(NamedTuple):
    f: torch.Tensor
    iterations: int
    converged: bool
    max_residual: float  # max |ΔF| at the final iteration
    transport_bytes: int = 0  # bytes a sharded solve's gathers copied (0 on one device)


def _max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| with 0 for an empty tensor (``jnp.max(..., initial=0)``)."""
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return x.abs().amax()


def frontier_live(frontier: torch.Tensor) -> bool:
    """Whether any row is left on the frontier: the loop's one host sync a
    sweep.  While the recorder is on, the host's time blocked in it goes to
    the ``solve.host_wait_ns`` counter."""
    if not telemetry.enabled():
        return bool(frontier.any())
    t0 = time.perf_counter_ns()
    live = bool(frontier.any())
    telemetry.count("solve.host_wait_ns", time.perf_counter_ns() - t0)
    return live


def _delta(delta, device) -> torch.Tensor:
    """δ as a float32 scalar on ``device``, made there (``torch.tensor``
    from a Python float would copy it from the host and wait for the copy)."""
    return torch.full((), float(delta), dtype=torch.float32, device=device)


def propagate(
    problem: PropagationProblem,
    f0: torch.Tensor,
    frontier0: torch.Tensor,
    delta: float = 1e-4,
    max_iters: int = 100_000,
) -> PropagateResult:
    """DynLP frontier-restricted propagation (Alg. 2 Step 3), the ``ref``
    backend.

    Only frontier rows are *applied* each iteration; a row whose update moves
    more than ``delta`` keeps itself and enrolls its neighbors for the next
    iteration; otherwise it leaves the frontier.  Terminates when the frontier
    empties (or at ``max_iters``).
    """
    delta = _delta(delta, problem.device)
    f = f0.to(torch.float32)
    frontier = frontier0 & problem.valid
    it = 0
    resid = torch.zeros((), dtype=torch.float32, device=problem.device)
    while it < max_iters and frontier_live(frontier):
        fu = torch.where(frontier, lp_update(problem, f), f)
        step = (fu - f).abs()
        changed = step > delta
        frontier = (changed | _expand_frontier(problem, changed)) & problem.valid
        f, it, resid = fu, it + 1, _max_abs(step)
    return PropagateResult(f=f, iterations=it, converged=not bool(frontier.any()),
                           max_residual=float(resid))


def propagate_full(
    problem: PropagationProblem,
    f0: torch.Tensor,
    delta: float = 1e-4,
    max_iters: int = 100_000,
) -> PropagateResult:
    """ITLP: every unlabeled vertex updates every iteration; stop when the
    global max |ΔF| drops to ``delta`` (classic Zhu et al. iteration [40])."""
    delta = _delta(delta, problem.device)
    f = f0.to(torch.float32)
    it = 0
    resid = torch.tensor(float("inf"), device=problem.device)
    while it < max_iters and bool(resid > delta):
        fu = lp_update(problem, f)
        f, it, resid = fu, it + 1, _max_abs(fu - f)
    return PropagateResult(f=f, iterations=it, converged=bool(resid <= delta),
                           max_residual=float(resid))


def harmonic_residual(problem: PropagationProblem, f: torch.Tensor) -> torch.Tensor:
    """max_u |T(F)_u - F_u| — distance from the harmonic fixed point."""
    return _max_abs(lp_update(problem, f) - f)
