"""STLP baseline: temporal label propagation via short-circuiting
(Wagner et al. [34]) and its approximate-inverse variant STLP(γ) [22].

Counterpart of ``repro.core.stlp``.  Short-circuiting contracts each
ground-truth class to one representative node with parallel-edge sums; in
the ``PropagationProblem`` form that contraction is already there
(``wl0``/``wl1``).  The harmonic solution on the contracted graph is

    F_U = L_UU⁻¹ · wl1          (since F_L = [0, 1] makes −L_UL F_L = wl1)

with L_UU = diag(Wall) − W_UU.  The dense solve is STLP's O(U²) memory
wall (the paper's Table 5: it stops at ~50K nodes).

STLP(γ) replaces the exact inverse with a truncated Neumann series
L_UU⁻¹ ≈ Σ_{i<T} (D⁻¹A)ⁱ D⁻¹, T = max(1, ⌈10/γ⌉).

The solve is ``torch.linalg.solve`` and the Neumann terms dense products,
library calls as the reference's ``jnp.linalg.solve`` and matmul are.
``problem_to_dense`` scatters one ELL column at a time, so every (row,
col) entry sums its lanes in column order without atomics, on any device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.propagate import PropagationProblem
from repro_torch.core.snapshot import build_problem
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import BatchUpdate, DynamicGraph
from repro_torch.graph.structures import PAD


def problem_to_dense(problem: PropagationProblem) -> torch.Tensor:
    """Densify the unlabeled-unlabeled adjacency (O(U²), by design).

    Within one ELL column every row appears once, so each column's scatter
    writes distinct (row, col) entries and needs no atomics; columns are
    added in order 0..K-1."""
    u = problem.num_unlabeled
    dev = problem.device
    rows = torch.arange(u, device=dev)
    dense = torch.zeros((u, u), dtype=torch.float32, device=dev)
    for j in range(problem.nbr.shape[1]):
        mask = problem.nbr[:, j] != PAD
        cols = torch.where(mask, problem.nbr[:, j], 0).long()
        w = torch.where(mask, problem.wgt[:, j], 0.0)
        dense[rows, cols] = dense[rows, cols] + w
    return dense


def _wall(problem: PropagationProblem, w_uu: torch.Tensor) -> torch.Tensor:
    return w_uu.sum(dim=1) + problem.wl0 + problem.wl1


def harmonic_solve(problem: PropagationProblem) -> torch.Tensor:
    """Exact harmonic solution on the short-circuited graph (dense solve),
    on the problem's device."""
    w_uu = problem_to_dense(problem)
    wall = _wall(problem, w_uu)
    isolated = wall <= 0
    l_uu = w_uu.neg_()  # diag(Wall) − W_UU in place: U² floats once, not twice
    l_uu.diagonal().add_(torch.where(isolated, 1.0, wall))
    rhs = torch.where(isolated, 0.5, problem.wl1)
    return torch.linalg.solve(l_uu, rhs).clamp(0.0, 1.0)


def _neumann_solve(problem: PropagationProblem, t: int) -> torch.Tensor:
    """STLP(γ): ``t`` terms of the Neumann series of L_UU⁻¹ applied to wl1."""
    w_uu = problem_to_dense(problem)
    wall = _wall(problem, w_uu)
    isolated = wall <= 0
    d_inv = torch.where(isolated, 0.0, 1.0 / wall.clamp_min(1e-30))
    x = acc = d_inv * problem.wl1
    for _ in range(int(t) - 1):
        x = d_inv * (w_uu @ x)
        acc = acc + x
    return torch.where(isolated, 0.5, acc).clamp(0.0, 1.0)


@dataclasses.dataclass
class STLPStats:
    num_unlabeled: int
    wall_ms: float
    dense_bytes: int  # the O(U²) footprint this method materializes


class STLP:
    """Per-batch harmonic recomputation on the short-circuited graph.

    ``gamma=None`` is exact STLP; a float takes the approximate variant.
    ``max_unlabeled`` guards the dense O(U²) allocation (the paper could not
    run exact STLP past 50K vertices either).
    """

    def __init__(
        self,
        graph: DynamicGraph,
        gamma: float | None = None,
        tau: float | None = None,
        max_degree: int | None = None,
        max_unlabeled: int = 60_000,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.gamma = gamma
        self.tau = tau
        self.max_degree = max_degree
        self.max_unlabeled = max_unlabeled

    def step(self, batch: BatchUpdate) -> STLPStats:
        t0 = time.perf_counter()
        g = self.graph
        g.apply_batch(batch, tau=self.tau)
        snap = build_problem(g, max_degree=self.max_degree, auto_bucket=True,
                             device=self.device)
        u = len(snap.unl_ids)
        if u > self.max_unlabeled:
            raise MemoryError(
                f"STLP dense solve needs {u}² floats = "
                f"{u * u * 4 / 2**30:.1f} GiB (> cap); the paper hits the same "
                "wall at 50K vertices (Table 5).")
        if self.gamma is None:
            f = harmonic_solve(snap.problem)
        else:
            f = _neumann_solve(snap.problem, max(1, int(np.ceil(10.0 / self.gamma))))
        g.f[snap.unl_ids] = f[:u].cpu().numpy()
        return STLPStats(
            num_unlabeled=u,
            wall_ms=(time.perf_counter() - t0) * 1e3,
            dense_bytes=u * u * 4,
        )
