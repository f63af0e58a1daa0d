"""Host-side dynamic similarity graph (paper §3.2, §6.3).

Numpy copy of ``repro.graph.dynamic``; the parity tests hold its edge
lists, kNN lists and ``BatchEffect``s byte-identical to the reference's.
Device ingest is ``repro_torch.ingest.DeviceIngestor``, a selector that
runs the argkmin kernel over the device-resident embedding store.

The paper keeps the evolving graph in CPU memory (growable 2-D vectors) and
ships per-batch subgraphs to the device.  We mirror that: numpy arrays grow
per batch; every batch produces (i) the updated topology, (ii) the
affected-vertex set, and (iii) the new-vertex subgraph G' used for
connected-component label initialization (Alg. 2 Step 1).

Topology is maintained *incrementally* as a true kNN graph: every alive
vertex keeps its directed top-k neighbor list (canonical order: weight
desc, index asc; see ``graph.knn``), and an arriving batch both builds the
new rows' lists and **displaces** the weakest entries of existing rows it
beats — so after any insert-only stream the graph is bit-identical to a
from-scratch ``build_knn_graph`` rebuild.  Deletions drop a vertex and
every list entry pointing at it (holes refill as later arrivals merge in).
The undirected edge arrays (both directions stored) are regenerated from
the lists after each batch.

*Where* the candidate search runs is pluggable: ``apply_batch`` takes a
selector — ``HostKNNSelector`` (the blockwise-BLAS staging path, default)
or ``ingest.incremental_knn.DeviceIngestor`` (the argkmin kernel over the
device-resident embedding store).  Selectors only nominate
candidate *supersets*; the canonical re-selection and list merges here are
shared, which is what makes the two paths bit-identical (``graph.knn``
module docstring).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import telemetry

from .knn import (
    normalize_rows,
    pair_weights,
    select_candidates,
    selection_slack,
    topk_pairs,
)
from .structures import CSRGraph, ELLGraph, coo_to_csr, csr_to_ell_fast

UNLABELED = -1

# flagged-row merges are chunked so the (rows, batch, dim) canonical
# weight tensor stays bounded regardless of how many rows a batch displaces
_MERGE_CHUNK = 4096


@dataclasses.dataclass
class BatchUpdate:
    """One Δ_t = {Δ_ins, Δ_del[, Δ_rel]}.

    Advanced/internal type: service callers should prefer the typed
    ``LPService.add_points`` / ``remove_points`` / ``relabel`` entry points
    (embedding-first API) over constructing deltas by hand.
    """

    ins_emb: np.ndarray  # (M, D) float32 — embeddings of inserted vertices
    ins_labels: np.ndarray  # (M,) int8 — ground truth 0/1 or UNLABELED
    del_ids: np.ndarray  # (R,) int64 — global ids to delete
    rel_ids: np.ndarray | None = None  # (S,) int64 — ids to relabel
    rel_labels: np.ndarray | None = None  # (S,) int8 — new labels (or UNLABELED)


@dataclasses.dataclass
class BatchEffect:
    """What the batch touched — inputs to DynLP's update."""

    new_ids: np.ndarray  # global ids assigned to inserted vertices
    affected: np.ndarray  # global ids requiring label updates (V_aff seed)
    gprime_src: np.ndarray  # COO among new vertices, *local* new-vertex ids
    gprime_dst: np.ndarray
    gprime_wgt: np.ndarray


@dataclasses.dataclass
class Selection:
    """A selector's nomination for one batch (global ids everywhere).

    ``cand_idx`` (M, W) int64: per new row, a candidate superset covering
    its canonical top-k (−1 padding; never self, never dead).  A selector
    may leave it on the device as an integer tensor instead; it then
    re-selects the lists itself (``rerank(g, cand_idx, base_id)``, as
    ``DeviceIngestor`` does).  ``flagged`` (A,) int64: alive pre-batch rows
    whose current k-th weight the batch may beat (superset — pruned
    against each row's k-th similarity plus ``selection_slack``); only
    these rows pay a merge.
    """

    cand_idx: np.ndarray  # or a device tensor (see above)
    flagged: np.ndarray


class HostKNNSelector:
    """Blockwise host staging path (the ``graph.knn`` economics).

    Every batch re-stages the full candidate base on the host: gather the
    alive embeddings, astype, row-normalize, concatenate with the batch,
    then blockwise sgemm + top-(k+margin).  This is the reference selector
    the device ingest path is measured and bit-checked against.
    """

    def __init__(self, block: int = 4096):
        self.block = block

    def on_delete(self, g: "DynamicGraph", del_ids: np.ndarray) -> None:
        pass

    def finalize(self, g: "DynamicGraph", rows: np.ndarray, kth: np.ndarray) -> None:
        pass

    def select(
        self, g: "DynamicGraph", new_ids: np.ndarray, embn_new: np.ndarray
    ) -> Selection:
        base_id = int(new_ids[0])
        old_alive = np.flatnonzero(g.alive[:base_id])
        n_old = len(old_alive)
        # host staging: raw gather + astype + normalize, every batch
        base_raw = np.concatenate([g.emb[old_alive], g.emb[base_id:]])
        base = normalize_rows(base_raw.astype(np.float32))
        base_map = np.concatenate([old_alive, new_ids])
        q = base[n_old:]
        m = len(q)
        slack = selection_slack(g.emb_dim)
        kth = g.kth_weights(old_alive)
        colmax = np.full(n_old, -np.inf, np.float32)
        cands: list[np.ndarray] = []
        for lo in range(0, m, self.block):
            hi = min(lo + self.block, m)
            sim = q[lo:hi] @ base.T  # (blk, n_old + m)
            self_col = n_old + np.arange(lo, hi)
            sim[np.arange(hi - lo), self_col] = -np.inf
            if n_old:
                colmax = np.maximum(colmax, sim[:, :n_old].max(axis=0))
            cand = select_candidates(sim, g.k)
            # map local → global; drop -inf-similarity slots (self / masked)
            cw = np.where(cand >= 0, sim[np.arange(hi - lo)[:, None], cand], -np.inf)
            cand = np.where(np.isfinite(cw), base_map[np.maximum(cand, 0)], -1)
            cands.append(cand)
        cand_idx = _stack_ragged(cands)
        flagged = old_alive[((colmax + 1.0) * 0.5) > kth - slack] if n_old else (
            np.zeros(0, np.int64))
        return Selection(cand_idx=cand_idx, flagged=flagged)


def _stack_ragged(blocks: list[np.ndarray]) -> np.ndarray:
    """Stack (Ri, Wi) candidate blocks, right-padding widths with -1."""
    if not blocks:
        return np.zeros((0, 1), np.int64)
    w = max(b.shape[1] for b in blocks)
    out = []
    for b in blocks:
        if b.shape[1] < w:
            pad = np.full((b.shape[0], w - b.shape[1]), -1, np.int64)
            b = np.concatenate([b, pad], axis=1)
        out.append(b)
    return np.concatenate(out).astype(np.int64)


class DynamicGraph:
    """Evolving undirected weighted similarity graph (incremental kNN)."""

    # (buffer attr, fill value) — grown together on the doubling ladder
    _BUFS = (("_emb_b", 0.0), ("_embn_b", 0.0), ("_labels_b", 0),
             ("_alive_b", False), ("_f_b", 0.0), ("_ki_b", -1),
             ("_kw_b", -np.inf))

    def __init__(self, emb_dim: int, k: int = 5, knn_block: int = 4096):
        self.emb_dim = emb_dim
        self.k = k
        self.knn_block = knn_block
        # per-vertex state lives in capacity-doubling private buffers; the
        # public arrays (emb/embn/labels/alive/f/knn_idx/knn_wgt) are views
        # of the first num_nodes rows, re-sliced on append — so a stream of
        # B-sized batches pays O(B) per append amortized, not O(N) copies
        self._cap = 0
        self._emb_b = np.zeros((0, emb_dim), np.float32)
        self._embn_b = np.zeros((0, emb_dim), np.float32)  # row-normalized
        self._labels_b = np.zeros((0,), np.int8)
        self._alive_b = np.zeros((0,), bool)
        self._f_b = np.zeros((0,), np.float32)  # current fractional labels
        # directed per-row top-k lists, canonical order, holes at the tail
        self._ki_b = np.zeros((0, k), np.int64)
        self._kw_b = np.zeros((0, k), np.float32)
        self._reslice(0)
        # undirected edge arrays (both directions stored), maintained in
        # (src asc, dst asc) order incrementally per batch
        self.src = np.zeros((0,), np.int64)
        self.dst = np.zeros((0,), np.int64)
        self.wgt = np.zeros((0,), np.float32)
        self._host_selector = HostKNNSelector(block=knn_block)

    def _reslice(self, n: int) -> None:
        self.emb = self._emb_b[:n]
        self.embn = self._embn_b[:n]
        self.labels = self._labels_b[:n]
        self.alive = self._alive_b[:n]
        self.f = self._f_b[:n]
        self.knn_idx = self._ki_b[:n]
        self.knn_wgt = self._kw_b[:n]

    def _ensure_capacity(self, n: int) -> None:
        if n <= self._cap:
            return
        cap = max(256, self._cap)
        while cap < n:
            cap *= 2
        old = self.num_nodes
        for name, fill in self._BUFS:
            buf = getattr(self, name)
            grown = np.full((cap,) + buf.shape[1:], fill, buf.dtype)
            grown[:old] = buf[:old]
            setattr(self, name, grown)
        self._cap = cap

    # ------------------------------------------------------------------ #
    @property
    def num_nodes(self) -> int:
        return len(self.labels)

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def num_edges(self) -> int:
        """Undirected edge count."""
        return len(self.src) // 2

    def mean_edge_weight(self) -> float:
        return float(self.wgt.mean()) if len(self.wgt) else 0.0

    def kth_weights(self, rows: np.ndarray) -> np.ndarray:
        """Current k-th (weakest kept) weight per row; -inf while a row has
        spare capacity — such rows accept any candidate."""
        if self.k == 0 or not len(rows):
            return np.full(len(rows), -np.inf, np.float32)
        return self.knn_wgt[rows, self.k - 1]

    # ------------------------------------------------------------------ #
    def state_arrays(self) -> dict[str, np.ndarray]:
        """Host COPIES of the full mutable state (per-vertex buffers sliced
        to ``num_nodes`` + the undirected edge arrays) for persistence.

        Copies are load-bearing: the checkpoint writer runs on a worker
        thread while the stream keeps mutating these arrays in place, so
        handing out views would tear the snapshot
        (``core.persistence``/docs/persistence.md).
        """
        return {name: getattr(self, name).copy() for name in
                ("emb", "embn", "labels", "alive", "f", "knn_idx",
                 "knn_wgt", "src", "dst", "wgt")}

    def load_state_arrays(self, arrays: dict[str, np.ndarray]) -> None:
        """Adopt a ``state_arrays`` snapshot (restore path).  Capacity
        regrows on the same doubling ladder, so a restored graph appends
        with identical amortized economics."""
        n = len(arrays["labels"])
        self._ensure_capacity(n)
        for name, attr in (("emb", "_emb_b"), ("embn", "_embn_b"),
                           ("labels", "_labels_b"), ("alive", "_alive_b"),
                           ("f", "_f_b"), ("knn_idx", "_ki_b"),
                           ("knn_wgt", "_kw_b")):
            getattr(self, attr)[:n] = arrays[name]
        self._reslice(n)
        self.src = np.asarray(arrays["src"], np.int64)
        self.dst = np.asarray(arrays["dst"], np.int64)
        self.wgt = np.asarray(arrays["wgt"], np.float32)

    # ------------------------------------------------------------------ #
    def apply_batch(
        self,
        batch: BatchUpdate,
        tau: float | None = None,
        selector=None,
    ) -> BatchEffect:
        """Apply Δ_t; returns the affected set and G' (Alg. 2 Step 1)."""
        sel_impl = selector if selector is not None else self._host_selector
        affected: list[np.ndarray] = []
        changed_lists: list[np.ndarray] = []

        # --- deletions: kill rows, drop every list entry pointing at them ---
        with telemetry.span("graph.delete"):
            del_ids = np.unique(np.asarray(batch.del_ids, np.int64))
            del_ids = del_ids[(del_ids >= 0) & (del_ids < self.num_nodes)]
            del_ids = del_ids[self.alive[del_ids]]
            if len(del_ids):
                sel_impl.on_delete(self, del_ids)
                out_nbr = self.knn_idx[del_ids]
                affected.append(out_nbr[out_nbr >= 0])  # their undirected edges vanish
                self.alive[del_ids] = False
                self.knn_idx[del_ids] = -1
                self.knn_wgt[del_ids] = -np.inf
                hit = np.isin(self.knn_idx, del_ids)
                hole_rows = np.flatnonzero(hit.any(axis=1))
                if len(hole_rows):
                    hw = self.knn_wgt[hole_rows]
                    hidx = self.knn_idx[hole_rows]
                    hw[hit[hole_rows]] = -np.inf
                    hidx[hit[hole_rows]] = -1
                    ti, tw = topk_pairs(hw, hidx, self.k)  # compact holes to the tail
                    self.knn_idx[hole_rows] = ti
                    self.knn_wgt[hole_rows] = tw
                    affected.append(hole_rows)
                    changed_lists.append(hole_rows)
                    # push the weakened thresholds now: this batch's own
                    # displacement pruning must see the holes, not the
                    # pre-deletion k-th weights
                    live = hole_rows[self.alive[hole_rows]]
                    sel_impl.finalize(self, live, self.kth_weights(live))

        # --- insertions: append rows, select candidates, merge lists ---
        m = len(batch.ins_emb)
        base_id = self.num_nodes
        new_ids = np.arange(base_id, base_id + m, dtype=np.int64)
        if m:
            with telemetry.span("graph.append"):
                ins_emb = np.asarray(batch.ins_emb, np.float32)
                embn_new = normalize_rows(ins_emb)
                ins_labels = np.asarray(batch.ins_labels, np.int8)
                n = base_id + m
                self._ensure_capacity(n)
                self._emb_b[base_id:n] = ins_emb
                self._embn_b[base_id:n] = embn_new
                self._labels_b[base_id:n] = ins_labels
                self._alive_b[base_id:n] = True
                self._f_b[base_id:n] = np.where(
                    ins_labels == 1, 1.0, np.where(ins_labels == 0, 0.0, 0.5)
                ).astype(np.float32)
                self._ki_b[base_id:n] = -1
                self._kw_b[base_id:n] = -np.inf
                self._reslice(n)

            with telemetry.span("ingest.select"):
                sel = sel_impl.select(self, new_ids, embn_new)

            # canonical re-selection for the new rows' lists: on the card
            # where the selector left its candidates there, else here
            with telemetry.span("graph.rerank"):
                if isinstance(sel.cand_idx, np.ndarray):
                    cand = np.asarray(sel.cand_idx, np.int64)
                    cw = np.full(cand.shape, -np.inf, np.float32)
                    qr, qc = np.nonzero(cand >= 0)
                    if len(qr):
                        cw[qr, qc] = pair_weights(
                            embn_new[qr], self.embn[cand[qr, qc]])
                    ti, tw = topk_pairs(cw, cand, self.k)
                else:
                    ti, tw = sel_impl.rerank(self, sel.cand_idx, base_id)
                self.knn_idx[new_ids] = ti
                self.knn_wgt[new_ids] = tw
                affected.append(new_ids)
                affected.append(ti[ti >= 0])  # rows gaining an in-edge from the batch
                changed_lists.append(new_ids)

            # displaced merges: flagged rows race the batch against their list
            with telemetry.span("graph.merge"):
                flagged = np.asarray(sel.flagged, np.int64)
                telemetry.count("graph.flagged_rows", len(flagged))
                for lo in range(0, len(flagged), _MERGE_CHUNK):
                    rows = flagged[lo:lo + _MERGE_CHUNK]
                    bw = pair_weights(self.embn[rows][:, None, :], embn_new[None, :, :])
                    merged_w = np.concatenate([self.knn_wgt[rows], bw], axis=1)
                    merged_i = np.concatenate(
                        [self.knn_idx[rows],
                         np.broadcast_to(new_ids, (len(rows), m))], axis=1)
                    mi, mw = topk_pairs(merged_w, merged_i, self.k)
                    changed = (mi != self.knn_idx[rows]).any(axis=1)
                    if not changed.any():
                        continue
                    crows = rows[changed]
                    old_i = self.knn_idx[crows]
                    mi, mw = mi[changed], mw[changed]
                    # displaced-out ex-neighbors lose an undirected edge
                    still = (old_i[:, :, None] == mi[:, None, :]).any(axis=2)
                    dropped = old_i[(old_i >= 0) & ~still]
                    self.knn_idx[crows] = mi
                    self.knn_wgt[crows] = mw
                    affected.append(crows)
                    affected.append(dropped)
                    changed_lists.append(crows)

        # --- refresh the undirected edge arrays from the lists ---
        with telemetry.span("graph.edges"):
            touched = np.unique(np.concatenate(changed_lists + [del_ids]))
            self._rebuild_edges(touched)

        # --- G': edges among new vertices with w > τ (local ids) ---
        with telemetry.span("graph.gprime"):
            if m:
                tau = self.mean_edge_weight() if tau is None else tau
                ni, nw = self.knn_idx[new_ids], self.knn_wgt[new_ids]
                both_new = (ni >= base_id) & (nw > tau)
                gp_s = np.repeat(np.arange(m, dtype=np.int64), self.k)[both_new.ravel()]
                gp_d = (ni[both_new] - base_id).astype(np.int64)
                gp_w = nw[both_new].astype(np.float32)
            else:
                gp_s = gp_d = np.zeros((0,), np.int64)
                gp_w = np.zeros((0,), np.float32)

        # --- relabels: ground-truth changes on existing vertices ---
        with telemetry.span("graph.relabel"):
            if batch.rel_ids is not None and len(batch.rel_ids):
                rel = np.asarray(batch.rel_ids, np.int64)
                rlab = np.asarray(batch.rel_labels, np.int8)
                ok = (rel >= 0) & (rel < self.num_nodes) & self.alive[rel]
                rel, rlab = rel[ok], rlab[ok]
                if len(rel):
                    self.labels[rel] = rlab
                    self.f[rel] = np.where(
                        rlab == 1, 1.0, np.where(rlab == 0, 0.0, 0.5)
                    ).astype(np.float32)
                    out = self.knn_idx[rel]
                    in_rows = np.flatnonzero(np.isin(self.knn_idx, rel).any(axis=1))
                    affected.append(rel)
                    affected.append(out[out >= 0])
                    affected.append(in_rows)

        with telemetry.span("graph.finalize"):
            aff = (
                np.unique(np.concatenate(affected)) if affected else np.zeros(0, np.int64)
            )
            aff = aff[self.alive[aff]]
            changed = (
                np.unique(np.concatenate(changed_lists))
                if changed_lists else np.zeros(0, np.int64)
            )
            changed = changed[self.alive[changed]]
            if len(changed):
                sel_impl.finalize(self, changed, self.kth_weights(changed))
        return BatchEffect(
            new_ids=new_ids, affected=aff, gprime_src=gp_s, gprime_dst=gp_d,
            gprime_wgt=gp_w,
        )

    # ------------------------------------------------------------------ #
    def _rebuild_edges(self, touched: np.ndarray | None = None) -> None:
        """Refresh the undirected (both-directions) COO edge arrays.

        The invariant: edges are the unique pairs ``{a, b}`` with ``b ∈
        list(a)`` or ``a ∈ list(b)`` (weights agree bit-for-bit because
        both sides store the same canonical ``pair_weights`` value),
        stored in (src asc, dst asc) order — snapshots come out
        bit-identical to the ``build_knn_graph`` oracle, whose symmetrize
        emits ascending columns per row.

        With ``touched`` (rows whose lists or aliveness this batch
        changed) the refresh is incremental: only T-incident edges are
        recomputed and spliced back into the retained sorted run — one
        O(E) pass plus O(|T|·k) work instead of a global per-batch sort.
        An edge {a, b} with both endpoints untouched cannot change (both
        lists are unchanged), and a surviving in-edge into a touched row
        from an untouched row y must already be present in the old edge
        array (y's list is unchanged), so old T-incident edges plus the
        touched rows' fresh out-lists cover every candidate pair.
        """
        if touched is None or not len(self.src) or (
                2 * len(touched) * max(self.k, 1) >= len(self.src)):
            self._rebuild_edges_full()
            return
        if not len(touched):  # lists unchanged -> edges unchanged
            return
        n = self.num_nodes
        t_mask = np.zeros(n, bool)
        t_mask[touched] = True
        inc = t_mask[self.src] | t_mask[self.dst]
        # surviving in-edges into touched rows from untouched rows: the
        # pair {y, t} persists iff t is still in y's (unchanged) list —
        # verified by membership, weight read from y's list entry
        cin = inc & ~t_mask[self.src]
        ys, ts = self.src[cin], self.dst[cin]
        hit = self.knn_idx[ys] == ts[:, None]
        keep = hit.any(axis=1)
        ys, ts = ys[keep], ts[keep]
        ww = self.knn_wgt[ys, hit.argmax(axis=1)[keep]]
        # fresh out-edges of touched alive rows
        talive = touched[self.alive[touched]]
        li, lw = self.knn_idx[talive], self.knn_wgt[talive]
        rows, cols = np.nonzero(li >= 0)
        a = np.concatenate([ys, talive[rows]])
        b = np.concatenate([ts, li[rows, cols]])
        w = np.concatenate([ww, lw[rows, cols]]).astype(np.float32)
        # dedup to unique undirected pairs (reciprocated lists and the
        # in-edge pass nominate the same pair with the same weight)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        _, first = np.unique(lo << np.int64(32) | hi, return_index=True)
        lo, hi, w = lo[first], hi[first], w[first]
        new_src = np.concatenate([lo, hi])
        new_dst = np.concatenate([hi, lo])
        new_wgt = np.concatenate([w, w])
        order = np.argsort(new_src << np.int64(32) | new_dst)
        new_src, new_dst, new_wgt = (
            new_src[order], new_dst[order], new_wgt[order])
        # splice into the retained (still sorted) non-incident run
        ret = ~inc
        r_src, r_dst, r_wgt = self.src[ret], self.dst[ret], self.wgt[ret]
        pos = np.searchsorted(
            r_src << np.int64(32) | r_dst, new_src << np.int64(32) | new_dst)
        tgt = pos + np.arange(len(new_src))
        out_mask = np.ones(len(r_src) + len(new_src), bool)
        out_mask[tgt] = False
        for name, retained, fresh in (("src", r_src, new_src),
                                      ("dst", r_dst, new_dst),
                                      ("wgt", r_wgt, new_wgt)):
            out = np.empty(len(out_mask), retained.dtype)
            out[tgt] = fresh
            out[out_mask] = retained
            setattr(self, name, out)

    def _rebuild_edges_full(self) -> None:
        """From-scratch edge regeneration (first batch, or a batch that
        touched a large fraction of all rows).  No global sort of the
        directed entries is needed for dedup — that is an O(N·k²)
        membership test against the k-wide lists — but the final
        canonical order costs one lexsort."""
        valid = self.knn_idx >= 0
        s, col = np.nonzero(valid)
        s = s.astype(np.int64)
        d = self.knn_idx[s, col]
        w = self.knn_wgt[s, col]
        dup = (self.knn_idx[d] == s[:, None]).any(axis=1)
        keep = ~dup | (s < d)
        s, d, w = s[keep], d[keep], w[keep]
        src = np.concatenate([s, d])
        dst = np.concatenate([d, s])
        wgt = np.concatenate([w, w]).astype(np.float32)
        order = np.lexsort((dst, src))
        self.src, self.dst, self.wgt = src[order], dst[order], wgt[order]

    # ------------------------------------------------------------------ #
    def snapshot_csr(self) -> tuple[CSRGraph, np.ndarray]:
        """CSR over alive vertices (compact ids); returns (csr, global_ids)."""
        alive_ids = np.flatnonzero(self.alive)
        remap = np.full(self.num_nodes, -1, np.int64)
        remap[alive_ids] = np.arange(len(alive_ids))
        keep = self.alive[self.src] & self.alive[self.dst]
        csr = coo_to_csr(
            len(alive_ids), remap[self.src[keep]], remap[self.dst[keep]], self.wgt[keep]
        )
        return csr, alive_ids

    def snapshot_ell(self, max_degree: int | None = None) -> tuple[ELLGraph, np.ndarray]:
        csr, alive_ids = self.snapshot_csr()
        return csr_to_ell_fast(csr, max_degree=max_degree), alive_ids
