"""DynLP — Dynamic Batch Parallel Label Propagation (paper Algorithm 2).

Counterpart of ``repro.core.dynlp``.  Orchestrates the three steps per
arriving batch Δ_t:

  1. Change adjustment & sparsification — apply Δ_t to the host graph, seed
     the affected set, build G' over the new vertices (edges with w > τ) and
     find its connected components (``core.components``).
  2. Label initialization — supernode edge sums to L0/L1 give each component
     a shared initial label (``core.init_labels``).
  3. Iterative propagation — frontier-restricted δ-thresholded LP
     (``kernels.ops.run_propagation``) until the affected set empties; on a
     CUDA device through the hand-written sweep kernel.

The graph stays on the host (numpy); the problem, the component search,
the supernode init and the solve run on ``device``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.components import compact_labels, connected_components
from repro_torch.core.init_labels import supernode_init
from repro_torch.core.snapshot import Snapshot, bucket_k, build_problem
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.graph.structures import coo_to_csr, csr_to_ell_fast
from repro_torch.kernels.ops import run_propagation


def gprime_components(effect, m: int, device: torch.device) -> torch.Tensor:
    """Connected components of G' (new-vertex τ-subgraph), local ids."""
    if len(effect.gprime_src) == 0:
        return torch.arange(m, dtype=torch.int32, device=device)
    s = np.concatenate([effect.gprime_src, effect.gprime_dst])
    d = np.concatenate([effect.gprime_dst, effect.gprime_src])
    w = np.concatenate([effect.gprime_wgt, effect.gprime_wgt])
    ell = csr_to_ell_fast(coo_to_csr(m, s, d, w))
    k = ell.nbr.shape[1]
    kb = bucket_k(k)  # the reference's K bucket, kept so both pad alike
    nbr = torch.full((m, kb), -1, dtype=torch.int32)
    wgt = torch.zeros((m, kb), dtype=torch.float32)
    nbr[:, :k] = ell.nbr
    wgt[:, :k] = ell.wgt
    return connected_components(nbr.to(device), wgt.to(device), tau=0.0).labels


@dataclasses.dataclass
class StepStats:
    iterations: int
    converged: bool
    num_components: int
    frontier_size: int
    num_unlabeled: int
    wall_ms: float
    max_residual: float


class DynLP:
    """Stateful dynamic label-propagation engine over a ``DynamicGraph``."""

    def __init__(
        self,
        graph: DynamicGraph,
        delta: float = 1e-4,
        tau: float | None = None,
        max_iters: int = 200_000,
        max_degree: int | None = None,
        backend: str | None = None,
        auto_bucket: bool = True,
        max_k: int | None | str = "auto",
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.delta = delta
        self.tau = tau
        self.max_iters = max_iters
        self.max_degree = max_degree
        # max_k caps the ELL neighbor axis via heaviest-edge truncation;
        # "auto" = 4x the graph's kNN k, None = uncapped
        if isinstance(max_k, str) and max_k != "auto":
            raise ValueError(
                f"max_k={max_k!r} invalid; want an int, None (uncapped), "
                "or 'auto' (4x the graph's kNN k)")
        self.max_k = 4 * graph.k if max_k == "auto" else max_k
        # backend: kernels.ops dispatch (None/"auto", "ref", "ell_cuda").
        # auto_bucket=False builds at the exact (U, K) every batch.
        self.backend = backend
        self.auto_bucket = auto_bucket
        self.last_snapshot: Snapshot | None = None
        # per-engine max_k truncation-warning dedup
        self._max_k_warned: set[tuple[int, int]] = set()

    # ------------------------------------------------------------------ #
    def step(self, batch: BatchUpdate) -> StepStats:
        t0 = time.perf_counter()
        g = self.graph
        dev = self.device

        # ---- Step 1: change adjustment & sparsification ----
        effect = g.apply_batch(batch, tau=self.tau)
        m = len(effect.new_ids)
        n_components = 0

        # ---- Step 2: supernode label initialization for new vertices ----
        snap = build_problem(g, max_degree=self.max_degree,
                             auto_bucket=self.auto_bucket, max_k=self.max_k,
                             warned=self._max_k_warned, device=dev)
        new_unl = effect.new_ids[g.labels[effect.new_ids] == UNLABELED]
        if m and len(new_unl):
            comp_local = gprime_components(effect, m, dev)
            # component id per *unlabeled* new vertex (local new-batch index)
            local_idx = torch.from_numpy(new_unl - effect.new_ids[0]).to(dev)
            comp = compact_labels(comp_local)[local_idx]
            n_components = int(comp.max()) + 1
            rows = torch.from_numpy(snap.remap[new_unl]).to(dev)
            f_init = supernode_init(comp, snap.problem.wl0[rows],
                                    snap.problem.wl1[rows],
                                    num_segments=max(m, 1))
            g.f[new_unl] = f_init.cpu().numpy()

        # ---- Step 3: frontier-restricted iterative propagation ----
        u = len(snap.unl_ids)
        u_pad = snap.problem.num_unlabeled
        f0 = np.full(u_pad, 0.5, np.float32)
        f0[:u] = g.f[snap.unl_ids]
        frontier = np.zeros(u_pad, bool)
        aff_rows = snap.remap[effect.affected]
        frontier[aff_rows[aff_rows >= 0]] = True
        res = run_propagation(
            snap.problem, torch.from_numpy(f0), torch.from_numpy(frontier),
            delta=self.delta, max_iters=self.max_iters, backend=self.backend,
            device=dev,
        )
        g.f[snap.unl_ids] = res.f[:u].cpu().numpy()
        self.last_snapshot = snap
        return StepStats(
            iterations=res.iterations,
            converged=res.converged,
            num_components=n_components,
            frontier_size=int(frontier.sum()),
            num_unlabeled=u,
            wall_ms=(time.perf_counter() - t0) * 1e3,
            max_residual=res.max_residual,
        )

    # ------------------------------------------------------------------ #
    def predictions(self, cutoff: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
        """(global ids, binary predictions) for alive unlabeled vertices."""
        g = self.graph
        ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
        return ids, (g.f[ids] >= cutoff).astype(np.int8)
