"""Connected components — Shiloach–Vishkin as tensor ops (paper §6.2).

Counterpart of ``repro.core.components``.  The same fixpoint over the ELL
neighbor tensor:

  hook:  par'[u] = min(par[u], min_v∈N(u) par[v])   — a masked row min-reduce
  jump:  par''   = par'[par']                        — a gather (path halving)

looped on the host until no parent changes (one sync per round).  Labels
are exact integers, so the port must give the reference's labels exactly.

Requires a *symmetric* adjacency (both directions present and identically
masked), because the min-hook only pulls labels down-edge.

``host_components``, ``component_order`` and ``permute_ell_rows`` are
numpy copies of the reference's host passes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.structures import PAD


class CCResult(NamedTuple):
    labels: torch.Tensor  # (N,) int32 — component id = min vertex id in component
    iterations: int


def connected_components(
    nbr: torch.Tensor,
    wgt: torch.Tensor | None = None,
    tau: float = 0.0,
    max_iters: int = 10_000,
) -> CCResult:
    """Components of the graph whose edges satisfy ``wgt > tau``.

    The τ-thresholding implements the paper's sparsification step (Alg.2
    L10 / Fig.2a): masked ELL slots point at their own row.
    """
    n = nbr.shape[0]
    mask = nbr != PAD
    if wgt is not None:
        mask &= wgt > tau
    own = torch.arange(n, dtype=torch.int32, device=nbr.device)
    idx = torch.where(mask, nbr, own[:, None])  # masked slots point at self
    par = own
    it, changed = 0, True
    while changed and it < max_iters:
        hooked = par
        if idx.shape[1]:
            hooked = torch.minimum(par, par[idx].amin(dim=1))
        jumped = hooked[hooked]
        jumped = jumped[jumped]
        changed = bool((jumped != par).any())
        par, it = jumped, it + 1
    return CCResult(labels=par, iterations=it)


def host_components(nbr, max_iters: int = 10_000):
    """Numpy twin of ``connected_components`` for host-side passes."""
    n = len(nbr)
    own = np.arange(n)
    idx = np.where(nbr >= 0, nbr, own[:, None])
    par = own.copy()
    for _ in range(max_iters):
        hooked = np.minimum(par, par[idx].min(axis=1))
        jumped = hooked[hooked]
        jumped = jumped[jumped]
        if np.array_equal(jumped, par):
            break
        par = jumped
    return par


def component_order(nbr):
    """Step-1 clustering order: row permutation (new → old) grouping rows
    by connected component (stable within a component)."""
    return np.argsort(host_components(nbr), kind="stable")


def permute_ell_rows(nbr, order):
    """Permute ELL rows by ``order`` (new → old), remapping neighbor ids
    into the new row space (-1 lanes stay -1).  Returns ``(nbr', inv)``
    with ``inv`` the old → new map (``inv[order] == arange``)."""
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    p = nbr[order]
    out = np.where(p >= 0, inv[np.where(p >= 0, p, 0)], -1).astype(np.int32)
    return out, inv


def compact_labels(labels: torch.Tensor) -> torch.Tensor:
    """Make component ids sequential 0..C-1 (paper: thrust prefix scan)."""
    n = labels.shape[0]
    is_root = labels == torch.arange(n, dtype=labels.dtype, device=labels.device)
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    return rank[labels]


def num_components(labels: torch.Tensor) -> torch.Tensor:
    n = labels.shape[0]
    return (labels == torch.arange(n, dtype=labels.dtype, device=labels.device)).sum()
