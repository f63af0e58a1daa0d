"""Graph partitioning for distributed LP: contiguous row shards with
export-prefix reordering (the halo-exchange layout).

A numpy copy of ``repro.graph.partition``: the same plans, byte for byte.

Shard s owns rows [s·m, (s+1)·m).  A row is EXPORTED if any other shard
references it.  Rows are permuted so each shard's exports form a prefix;
then one gather of the (padded) export prefixes replaces the full-vector
all-gather.

Plans are built per call from a concrete ELL topology.  The streaming
engine (``core.stream.StreamEngine(transport="halo")``) rebuilds the
layout per Δ_t (an O(U·K) host pass, the same order as the snapshot build
it rides along with) but fixes one export budget per bucket-ladder rung
(``export_budget``), so in-rung topology drift keeps one plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HaloPlan:
    nbr: np.ndarray  # (N_pad, K) int32 — remapped neighbor ids
    perm: np.ndarray  # (N_pad,) new_id -> old_id (identity on padding)
    inv_perm: np.ndarray  # old_id -> new_id
    n_shards: int
    rows_per_shard: int
    export_max: int  # padded export-prefix length per shard
    export_counts: np.ndarray  # (n_shards,)


def build_halo_plan(nbr: np.ndarray, n_shards: int) -> HaloPlan:
    """Reorder rows so cross-shard-referenced rows lead each shard."""
    n = len(nbr)
    pad = (-n) % n_shards
    n_pad = n + pad
    m = n_pad // n_shards
    if pad:
        nbr = np.concatenate([nbr, np.full((pad, nbr.shape[1]), -1, np.int32)])

    owner = np.arange(n_pad) // m
    valid = nbr >= 0
    src_owner = np.repeat(owner[:, None], nbr.shape[1], axis=1)
    tgt = np.where(valid, nbr, 0)
    cross = valid & (owner[tgt] != src_owner)
    exported = np.zeros(n_pad, bool)
    exported[np.unique(tgt[cross])] = True

    # within each shard, exported rows first: a stable sort on
    # (shard, not-exported) keeps the original order inside both groups
    perm = np.argsort(owner * 2 + (~exported), kind="stable")  # new -> old
    counts = np.bincount(owner[exported], minlength=n_shards).astype(np.int64)
    inv = np.empty(n_pad, np.int64)
    inv[perm] = np.arange(n_pad)

    remapped = np.where(nbr[perm] >= 0, inv[np.where(nbr[perm] >= 0, nbr[perm], 0)], -1)
    e_max = int(max(1, counts.max()))
    e_max = -8 * (-e_max // 8)  # round up for alignment
    return HaloPlan(nbr=remapped.astype(np.int32), perm=perm, inv_perm=inv,
                    n_shards=n_shards, rows_per_shard=m, export_max=min(e_max, m),
                    export_counts=counts)


def apply_plan(plan: HaloPlan, arr: np.ndarray, fill=0) -> np.ndarray:
    """Reorder a per-row array into the plan's layout (padding with fill)."""
    n_pad = len(plan.perm)
    out = np.full((n_pad,) + arr.shape[1:], fill, arr.dtype)
    valid = plan.perm < len(arr)
    out[valid] = arr[plan.perm[valid]]
    return out


def unapply_plan(plan: HaloPlan, arr: np.ndarray, n_orig: int) -> np.ndarray:
    """Inverse reordering back to original row ids."""
    return arr[plan.inv_perm[:n_orig]]


def export_budget(plan: HaloPlan, n_valid: int, headroom: float = 3.0) -> int:
    """Per-shard export-prefix length a ladder rung should fix.

    The streaming halo transport fixes one ``export_max`` per bucket rung
    and reuses the rung's plan for every batch in it, so the budget must
    absorb in-rung growth: the observed max export count scaled by the
    rung's remaining fill factor (a rung entered at ``n_valid`` rows can
    grow to its full padded row count, and export sets grow roughly with
    it) times ``headroom`` for topology drift, rounded up to a multiple of
    8 and capped at the shard size.  A batch that still exceeds it runs on
    all-gather for that Δ_t (logged by the engine), so the budget is a
    performance knob, never a correctness one.
    """
    n_pad = len(plan.perm)
    fill = n_pad / max(1, n_valid)
    want = int(np.ceil(max(1, int(plan.export_counts.max())) * fill * headroom))
    want = -8 * (-want // 8)
    return int(min(want, plan.rows_per_shard))
