"""ITLP baseline: full iterative label propagation from scratch per batch
(Zhu et al. [40]; the paper's primary speed baseline, §7.3).

Counterpart of ``repro.core.itlp``.  After every Δ_t the labels of *all*
unlabeled vertices are recomputed: uniform 0.5 initialization, dense (no
frontier) iteration until the global max |ΔF| falls to δ.  The iteration
runs through the fused sweep kernel (``kernels.ops.propagate_full_ell``),
which on CPU tensors takes the kernel's plain version and gives the plain
``core.propagate.propagate_full``'s bits and iteration count.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.snapshot import build_problem
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import BatchUpdate, DynamicGraph
from repro_torch.kernels.ops import propagate_full_ell


@dataclasses.dataclass
class ITLPStats:
    iterations: int
    converged: bool
    num_unlabeled: int
    wall_ms: float


class ITLP:
    def __init__(
        self,
        graph: DynamicGraph,
        delta: float = 1e-4,
        tau: float | None = None,
        max_iters: int = 200_000,
        max_degree: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.delta = delta
        self.tau = tau
        self.max_iters = max_iters
        self.max_degree = max_degree

    def step(self, batch: BatchUpdate) -> ITLPStats:
        t0 = time.perf_counter()
        g = self.graph
        g.apply_batch(batch, tau=self.tau)
        snap = build_problem(g, max_degree=self.max_degree, auto_bucket=True,
                             device=self.device)
        f0 = torch.full((snap.problem.num_unlabeled,), 0.5, dtype=torch.float32,
                        device=self.device)
        res = propagate_full_ell(snap.problem, f0, delta=self.delta, max_iters=self.max_iters)
        g.f[snap.unl_ids] = res.f[: len(snap.unl_ids)].cpu().numpy()
        return ITLPStats(
            iterations=res.iterations,
            converged=res.converged,
            num_unlabeled=len(snap.unl_ids),
            wall_ms=(time.perf_counter() - t0) * 1e3,
        )
