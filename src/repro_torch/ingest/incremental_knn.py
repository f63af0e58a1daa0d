"""Device ingest selector: embedding batches → ``apply_batch`` candidates.

Counterpart of the single-device ``repro.ingest.incremental_knn``.
``DeviceIngestor`` implements the selector protocol of
``graph.dynamic.apply_batch`` (``on_delete`` / ``select`` / ``finalize``)
on top of the device-resident ``EmbeddingStore`` and the argkmin kernel:

  * ``on_delete`` masks the rows out of the store (they stop matching at
    once);
  * ``select`` appends the batch to the store and runs one argkmin over
    it, returning the new rows' candidate supersets and the displaced-row
    ``flagged`` set, pruned against each row's current k-th weight.  Only
    the (C,) mask crosses back to the host: the (M, TK) candidate ids stay
    on the card as a tensor;
  * ``rerank`` re-selects the new rows' lists canonically from those
    candidates on the card (``kernels.knn_rerank``, the batch's rows read in
    place in the store) and brings the (M, k) lists back;
  * ``finalize`` pushes the refreshed k-th weights of every row whose list
    changed back to the store, keeping the next batch's pruning exact.

The canonical weights are ``graph.knn.pair_weights``'s bits wherever they
are computed, so the ingestor's streams are bit-identical to the
``HostKNNSelector`` path (``graph.knn`` docstring); the list merges stay in
``DynamicGraph``.

With a mesh (``DeviceIngestor(..., mesh=...)``) the ingestor builds the
row-sharded store and the candidate search moves the batch to the shards:
``core.distributed.StoreShardPlan`` (one per capacity rung) runs one
argkmin launch a shard at its global row offset and merges the lists, so
the candidates and the displacement mask are the single-device ones and
sharded streams stay bit-identical to single-device ones.  Its candidates
come back to the host as numpy, and ``DynamicGraph`` re-selects them there:
a row's candidates may sit in shards on other cards.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.graph.dynamic import Selection
from repro_torch.graph.knn import SELECT_MARGIN, selection_slack
from repro_torch.kernels.argkmin import argkmin_candidates
from repro_torch.kernels.knn_rerank import rerank_candidates

from .embedding_store import (
    BATCH_FLOOR,
    CAP_FLOOR,
    EmbeddingStore,
    ShardedEmbeddingStore,
    batch_bucket,
    cap_bucket,
    note_shape,
    store_cache_size,
)


def ingest_cache_size() -> int:
    """Distinct shapes the ingest path has run at (store updates and the
    argkmin kernel): the port's counterpart of the reference's live jit
    entries, the quantity ``ingest_ladder_bound`` bounds."""
    return store_cache_size()


def _rungs(floor: int, hi: int) -> int:
    n, b = 1, floor
    while b < hi:
        b *= 2
        n += 1
    return n


def ingest_ladder_bound(max_rows: int, max_batch: int, *, sharded: bool = False) -> int:
    """A-priori bound on ``ingest_cache_size()`` for a stream that never
    exceeds ``max_rows`` total rows or ``max_batch`` rows per batch.

    Every update and kernel call is keyed by bucketed shapes only, so the
    count is bounded by the ladder cross-product, independent of the
    stream's length.  Scatter updates (kill / set_kth) can touch up to the
    whole store, hence the ``max_rows`` rung count for those terms.
    ``sharded=True`` adds the sharded sweep's (capacity rung, batch bucket)
    pairs.
    """
    n_cap = _rungs(CAP_FLOOR, cap_bucket(max_rows))
    n_b = _rungs(BATCH_FLOOR, batch_bucket(max(max_batch, 1)))
    n_s = _rungs(BATCH_FLOOR, batch_bucket(max_rows))
    return (
        n_cap * n_b      # append
        + n_cap * n_b    # argkmin (one entry per (C, Mp) pair)
        + (n_cap - 1)    # grow
        + n_cap * n_s    # kill
        + n_cap * n_s    # set_kth
        + (n_cap * n_b if sharded else 0)  # the sharded sweep
    )


class DeviceIngestor:
    """Selector running candidate search on the device embedding store.

    Construct once per graph/engine and pass as ``apply_batch(...,
    selector=ingestor)`` (``StreamEngine(ingest="device")`` does this).
    ``attach`` adopts a non-empty graph's rows; afterwards the store tracks
    the graph batch for batch.  ``store=`` adopts a prepared store (a
    hand-over from the reference, ``state.store_from_reference``).
    ``mesh=`` (a ``core.distributed.DeviceMesh``) builds the row-sharded
    store; a mesh whose shard count does not divide the capacity ladder
    gets the single-device store on the mesh's first device, with a
    warning, as in the reference.
    """

    def __init__(self, emb_dim: int, *, capacity_floor: int = CAP_FLOOR,
                 device: str | torch.device | None = None,
                 store: EmbeddingStore | None = None, mesh=None):
        self.mesh = None
        if mesh is not None:
            if cap_bucket(max(1, capacity_floor)) % mesh.n_devices:
                warnings.warn(
                    f"mesh device count {mesh.n_devices} does not divide the store "
                    "capacity ladder; using the single-device embedding store on the "
                    "mesh's first device", stacklevel=2)
            else:
                self.mesh = mesh
            device = mesh.device
        if store is not None:
            self.store = store
        elif self.mesh is not None:
            self.store = ShardedEmbeddingStore(emb_dim, self.mesh, capacity_floor=capacity_floor)
        else:
            self.store = EmbeddingStore(emb_dim, capacity_floor=capacity_floor, device=device)

    def attach(self, g) -> None:
        """Adopt an existing graph's rows (host → device backfill)."""
        rows = np.arange(g.num_nodes, dtype=np.int64)
        self.store.backfill(g.embn, g.alive, g.kth_weights(rows))

    # ----- selector protocol ------------------------------------------- #
    def on_delete(self, g, del_ids: np.ndarray) -> None:
        self.store.kill(np.asarray(del_ids, np.int64))

    def select(self, g, new_ids: np.ndarray, embn_new: np.ndarray) -> Selection:
        base_id = int(new_ids[0])
        with telemetry.span("ingest.store_append"):
            if self.store.count != base_id:
                if self.store.count == 0 and base_id > 0:
                    # lazy attach: adopt the pre-batch rows (they live at
                    # g[:base_id]; apply_batch appended the batch already)
                    self.store.backfill(
                        g.embn[:base_id], g.alive[:base_id],
                        g.kth_weights(np.arange(base_id, dtype=np.int64)))
                else:
                    raise RuntimeError(
                        f"DeviceIngestor out of sync with graph: store has "
                        f"{self.store.count} rows, batch starts at {base_id}. "
                        "Use one ingestor per graph and route every batch "
                        "through it.")
            batch, bvalid, bid = self.store.append(np.ascontiguousarray(embn_new, np.float32))
        assert bid == base_id
        s = self.store
        with telemetry.span("ingest.search"):
            if self.mesh is not None:
                from repro_torch.core.distributed import build_store_shard_plan

                note_shape("argkmin_sharded", s.capacity, batch[0].shape[0])
                plan = build_store_shard_plan(self.mesh, (s.capacity, s.dp))
                val, idx, disp = plan.sweep(s.emb_s, s.valid_s, s.kth_s, batch, bvalid,
                                            base_id, selection_slack(g.emb_dim),
                                            topk=min(g.k + SELECT_MARGIN, s.capacity))
            else:
                note_shape("argkmin", s.capacity, batch.shape[0])
                val, idx, disp = argkmin_candidates(
                    s.emb, s.valid, s.kth, batch, bvalid, base_id,
                    selection_slack(g.emb_dim), k=g.k)
        m = len(new_ids)
        # the first read waits for the search.  On the single-device store
        # the candidates stay on the card for ``rerank``; the mesh's lists
        # come back whole and are sliced on the host
        with telemetry.span("ingest.readback"):
            if self.mesh is None:
                cand = torch.where(torch.isfinite(val[:m]), idx[:m], -1)
            else:
                val = val.cpu().numpy()[:m]
                cand = np.where(np.isfinite(val), idx.cpu().numpy()[:m].astype(np.int64), -1)
            flagged = np.flatnonzero(disp.cpu().numpy()).astype(np.int64)
        return Selection(cand_idx=cand, flagged=flagged)

    def rerank(self, g, cand: torch.Tensor, base_id: int) -> tuple[np.ndarray, np.ndarray]:
        """The new rows' canonical lists from the candidates ``select`` left
        on the card, read with the batch's rows in place in the store:
        ``(idx (M, k) int64, wgt (M, k) float32)`` on the host, the bits of
        ``topk_pairs(pair_weights(...), cand, k)``."""
        telemetry.count("graph.rerank_store_rows", len(cand))
        idx, wgt = rerank_candidates(self.store.emb, base_id, cand, d=g.emb_dim, k=g.k)
        return idx.cpu().numpy(), wgt.cpu().numpy()

    def finalize(self, g, rows: np.ndarray, kth: np.ndarray) -> None:
        self.store.set_kth(np.asarray(rows, np.int64), np.asarray(kth, np.float32))
