"""Supernode label initialization (paper Alg. 2 Step 2).

Counterpart of ``repro.core.init_labels``.  Each connected component c of
the new-vertex graph G' is a supernode; the two ground-truth classes are
supernodes L0/L1.  With parallel-edge sums W_c^{L0} = Σ_{u∈c} Σ_{v∈L0}
w(u,v) (and likewise L1), every vertex of c is initialized to

    F = W^{L1} / (W^{L0} + W^{L1})            (0.5 when both sums are zero)

The per-component sums are two ``index_add_``s keyed by component id.  On
CUDA ``index_add_`` accumulates with atomics in no fixed order, so the call
runs under deterministic algorithms (a sort of the keys, then a fixed-order
sum per key): the sums are the same bits on every run.  Their order may
still differ from the CPU's sequential one by a rounding, so the CPU and
the card agree within float32 ULPs, not bit for bit.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _deterministic():
    """Turn on ``torch.use_deterministic_algorithms`` for the block and
    restore the caller's setting after it (not thread-safe: the setting is
    process-wide)."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def supernode_init(
    comp: torch.Tensor,  # (M,) int32 component id per new vertex (0..num_segments-1)
    wl0: torch.Tensor,  # (M,) float32 — Σ w(u, v∈L0) for each new vertex u
    wl1: torch.Tensor,  # (M,) float32
    num_segments: int,
) -> torch.Tensor:
    """Returns (M,) float32 initial labels for the new vertices."""
    idx = comp.long()
    zeros = torch.zeros(num_segments, dtype=torch.float32, device=comp.device)
    with _deterministic():
        cw0 = zeros.clone().index_add_(0, idx, wl0)
        cw1 = zeros.clone().index_add_(0, idx, wl1)
    tot = cw0 + cw1
    half = torch.tensor(0.5, dtype=torch.float32, device=comp.device)
    f_comp = torch.where(tot > 0, cw1 / torch.clamp_min(tot, 1e-30), half)
    return f_comp[idx]
