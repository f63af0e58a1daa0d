"""Build ``PropagationProblem``s from the host ``DynamicGraph``, and the
read path over committed labels.

Counterpart of ``repro.core.snapshot``: the host build
(``build_host_problem``) is a numpy copy whose arrays must match the
reference's byte for byte; ``build_problem`` moves them to the device.
``LabelView`` is a commit's labels on the host, ``DeviceLabelView`` the
same labels on the device, where a read is one gather
(``publish_device_view``, ``query_bucket``).

Labeled classes are folded into the per-node supernode weights wl0/wl1; the
ELL tensor holds only unlabeled↔unlabeled edges (paper §4 "three kinds of
vertices that can impact the label").  Both axes can be padded up a
geometric bucket ladder (``bucket`` for rows, ``bucket_k`` for the neighbor
axis), so an evolving graph touches only O(log U · log K) distinct shapes.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from repro_torch.core.components import permute_ell_rows
from repro_torch.core.propagate import PropagationProblem
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph
from repro_torch.graph.structures import coo_to_csr, csr_to_ell_fast

logger = logging.getLogger(__name__)

# (max_k, natural-K rung) pairs whose truncation was already WARNed —
# repeats log at DEBUG so a persistent hub doesn't spam every Δ_t.  This
# module-level set is the fallback for bare ``build_host_problem`` calls
# only: engines (DynLP) pass their own per-engine set via ``warned=``.
_MAX_K_WARNED: set[tuple[int, int]] = set()


def reset_max_k_warnings() -> None:
    """Clear the process-wide max_k truncation-warning dedup state."""
    _MAX_K_WARNED.clear()


@dataclasses.dataclass
class Snapshot:
    problem: PropagationProblem
    unl_ids: np.ndarray  # (U,) global ids of the unlabeled alive vertices
    remap: np.ndarray  # (num_nodes,) global -> compact (or -1)


@dataclasses.dataclass(frozen=True)
class LabelView:
    """Immutable query-side view of the labels at one commit point: plain
    numpy copies of ``(f, labels, alive)``, so reads never see a torn
    state while the graph mutates."""

    f: np.ndarray  # (num_nodes,) float32 fractional labels
    labels: np.ndarray  # (num_nodes,) int8 ground truth (UNLABELED = -1)
    alive: np.ndarray  # (num_nodes,) bool
    commit_id: int  # number of committed batches behind this view

    def __post_init__(self):
        for a in (self.f, self.labels, self.alive):
            a.setflags(write=False)

    @classmethod
    def from_graph(cls, g: DynamicGraph, commit_id: int = 0) -> "LabelView":
        return cls(f=g.f.copy(), labels=g.labels.copy(),
                   alive=g.alive.copy(), commit_id=commit_id)

    @property
    def num_nodes(self) -> int:
        return len(self.labels)

    def predictions(self, cutoff: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
        """(global ids, binary predictions) for alive unlabeled vertices."""
        ids = np.flatnonzero(self.alive & (self.labels == UNLABELED))
        return ids, (self.f[ids] >= cutoff).astype(np.int8)

    def query(self, node_ids, cutoff: float = 0.5
              ) -> tuple[np.ndarray, np.ndarray]:
        """Per-node (prediction, confidence) for arbitrary global ids.

        Ground-truth seeds answer with their label at confidence 1.0;
        unlabeled alive vertices with their thresholded fractional label
        at confidence ``max(f, 1-f)``; dead or never-seen ids with
        ``UNLABELED`` at confidence 0.0.
        """
        ids = np.asarray(node_ids, np.int64).reshape(-1)
        pred = np.full(len(ids), UNLABELED, np.int8)
        conf = np.zeros(len(ids), np.float32)
        known = (ids >= 0) & (ids < self.num_nodes)
        live = known.copy()
        live[known] = self.alive[ids[known]]
        kn = ids[live]
        seeded = self.labels[kn] != UNLABELED
        f = self.f[kn]
        pred[live] = np.where(seeded, self.labels[kn],
                              (f >= cutoff).astype(np.int8))
        conf[live] = np.where(seeded, 1.0, np.maximum(f, 1.0 - f))
        return pred, conf


# ---------------------------------------------------------------------- #
# Device-resident read path
# ---------------------------------------------------------------------- #

# Query-axis ladder: read batches pad their id vector up a doubling ladder,
# as in the reference, so the staging buffers come in O(log Q_max) sizes.
QUERY_FLOOR = 256


def query_bucket(q: int, floor: int = QUERY_FLOOR) -> int:
    """Round a query batch size up a doubling ladder."""
    b = floor
    while b < q:
        b *= 2
    return b


def _device_query(f, labels, alive, ids, cutoff):
    """Batched label lookup on the view's device: ``LabelView.query`` as
    one gather.  ``ids`` out of ``[0, len(f))`` (the -1 padding included)
    and dead rows answer UNLABELED at confidence 0; the node-axis padding
    rows publish ``alive=False``, so one clamp handles both.  ``cutoff`` is
    per element, so one gather serves tickets with different thresholds."""
    n = f.shape[0]
    safe = ids.clamp(0, n - 1).long()
    known = (ids >= 0) & (ids < n) & alive[safe]
    lab = labels[safe]
    fv = f[safe]
    seeded = lab != UNLABELED
    pred = torch.where(known, torch.where(seeded, lab, (fv >= cutoff).to(torch.int8)),
                       UNLABELED)
    conf = torch.where(known, torch.where(seeded, torch.ones_like(fv),
                                          torch.maximum(fv, 1.0 - fv)), 0.0)
    return pred.to(torch.int8), conf.to(torch.float32)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host → ``device`` on the current stream: through pinned memory and
    an asynchronous copy on a CUDA device (the caching host allocator keeps
    the pinned block until the copy is done), a private copy on the CPU."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(a))
    pinned = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
    pinned.numpy()[...] = a
    return pinned.to(device, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class DeviceLabelView:
    """Device twin of ``LabelView``: the committed snapshot staged once per
    commit, so a burst of reads is one gather on the device instead of host
    indexing per call.

    Arrays are padded up the ``bucket`` node ladder (f→0, labels→UNLABELED,
    alive→False).  On a CUDA device every operation on the view (its
    publication's copies, each query's copies and gather) runs on one
    stream of its own, ``stream``: reads never queue behind the argkmin
    kernel or the staging copies of the caller's stream, nor behind a solve
    on the engine's side stream, and a view's memory is reused only in that
    stream's order, after every read queued on it.  Immutable: a commit
    publishes a NEW view, so readers holding this one never see a torn
    state, and it lives as long as they hold it."""

    f: torch.Tensor  # (N_pad,) float32
    labels: torch.Tensor  # (N_pad,) int8
    alive: torch.Tensor  # (N_pad,) bool
    num_nodes: int  # live prefix of the padded node axis
    commit_id: int
    host: LabelView  # the host twin this view was published from
    stream: torch.cuda.Stream | None = None  # None on the CPU

    def query(self, node_ids, cutoff=0.5) -> tuple[np.ndarray, np.ndarray]:
        """(pred, conf) for arbitrary global ids with ``LabelView.query``'s
        semantics, one gather.  ``cutoff`` may be a scalar or a per-id
        vector (fused multi-ticket reads)."""
        ids = np.asarray(node_ids, np.int64).reshape(-1)
        q = len(ids)
        qp = query_bucket(max(q, 1))
        ids_pad = np.full(qp, -1, np.int32)
        # ids beyond int32 cannot index the view; they are unknown by
        # construction (num_nodes < 2**31), so they take the -1 lane
        in32 = (ids >= np.iinfo(np.int32).min) & (ids <= np.iinfo(np.int32).max)
        ids_pad[:q][in32] = ids[in32].astype(np.int32)
        cut_pad = np.zeros(qp, np.float32)
        cut_pad[:q] = np.broadcast_to(
            np.asarray(cutoff, np.float32).reshape(-1), (q,)) if q else 0.0
        dev = self.f.device
        with torch.cuda.stream(self.stream):  # a no-op for None (the CPU)
            pred, conf = _device_query(self.f, self.labels, self.alive,
                                       _to_device(ids_pad, dev), _to_device(cut_pad, dev))
            if self.stream is None:
                return pred[:q].numpy(), conf[:q].numpy()
            pred_h = torch.empty(qp, dtype=torch.int8, pin_memory=True)
            conf_h = torch.empty(qp, dtype=torch.float32, pin_memory=True)
            pred_h.copy_(pred, non_blocking=True)
            conf_h.copy_(conf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return pred_h.numpy()[:q].copy(), conf_h.numpy()[:q].copy()


@dataclasses.dataclass(frozen=True)
class ViewSharding:
    """A row-sharded read placement: the committed view's node axis cut
    into ``len(devices)`` contiguous blocks, block b on ``devices[b]``
    (a device may repeat).  ``core.distributed.view_sharding`` builds one
    block per distinct mesh device; with one block it is that device's
    one view."""

    devices: tuple[torch.device, ...]


@dataclasses.dataclass(frozen=True)
class ShardedDeviceLabelView:
    """A committed view published as contiguous node blocks, one
    ``DeviceLabelView`` each (``ViewSharding`` with more than one block).
    A read gathers on every block's device and keeps, for each id, the
    answer of the block that owns it; an id no block owns answers
    UNLABELED at confidence 0, as ``LabelView.query`` does."""

    blocks: tuple[DeviceLabelView, ...]
    starts: tuple[int, ...]  # global id of each block's first node
    num_nodes: int
    commit_id: int
    host: LabelView

    def query(self, node_ids, cutoff=0.5) -> tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(node_ids, np.int64).reshape(-1)
        q = len(ids)
        pred = np.full(q, UNLABELED, np.int8)
        conf = np.zeros(q, np.float32)
        cut = np.broadcast_to(np.asarray(cutoff, np.float32).reshape(-1), (q,)) if q else 0.0
        ends = self.starts[1:] + (self.num_nodes,)
        for blk, lo, hi in zip(self.blocks, self.starts, ends):
            own = (ids >= lo) & (ids < hi)
            p, c = blk.query(np.where(own, ids - lo, -1), cut)
            pred[own], conf[own] = p[own], c[own]
        return pred, conf


def _stage_view(view: LabelView, lo: int, hi: int, dev: torch.device,
                stream) -> DeviceLabelView:
    """Nodes ``[lo, hi)`` of ``view``, padded up the ``bucket`` ladder, as
    one ``DeviceLabelView`` on ``dev``."""
    if dev.type == "cuda" and stream is None:
        raise ValueError("publish_device_view on a CUDA device needs the stream its "
                         "reads will run on")
    n = hi - lo
    n_pad = bucket(max(n, 1))
    f = np.zeros(n_pad, np.float32)
    lab = np.full(n_pad, UNLABELED, np.int8)
    alive = np.zeros(n_pad, bool)
    f[:n] = view.f[lo:hi]
    lab[:n] = view.labels[lo:hi]
    alive[:n] = view.alive[lo:hi]
    with torch.cuda.stream(stream):
        arrays = [_to_device(a, dev) for a in (f, lab, alive)]
    return DeviceLabelView(*arrays, num_nodes=n, commit_id=view.commit_id, host=view,
                           stream=stream)


def publish_device_view(view: LabelView, placement=None, stream=None):
    """Stage a committed ``LabelView`` on ``placement``, called at drain by
    ``StreamEngine``.  ``placement`` is a device (``None`` → ``cuda``) or a
    ``ViewSharding``.

    On a CUDA device the padded arrays go through pinned memory as
    asynchronous copies on the view's read stream (required there): the
    ``stream`` given, or for a ``ViewSharding`` (or when ``stream`` is a
    dict) ``stream[device]`` for each block's device.  Publication returns
    without waiting for the copies, which overlap the next batch's host
    work; reads on the same stream are ordered after them."""
    n = view.num_nodes
    blocks = placement.devices if isinstance(placement, ViewSharding) else (placement,)
    devs = [resolve_device(d) for d in blocks]
    streams = stream if isinstance(stream, dict) else {devs[0]: stream}
    if len(devs) == 1:
        return _stage_view(view, 0, n, devs[0], streams.get(devs[0]))
    step = -(-n // len(devs))
    starts = tuple(min(b * step, n) for b in range(len(devs)))
    ends = starts[1:] + (n,)
    return ShardedDeviceLabelView(
        blocks=tuple(_stage_view(view, lo, hi, d, streams.get(d))
                     for d, lo, hi in zip(devs, starts, ends)),
        starts=starts, num_nodes=n, commit_id=view.commit_id, host=view)


@dataclasses.dataclass
class HostSnapshot:
    """Numpy twin of ``Snapshot`` — not yet moved to the device."""

    nbr: np.ndarray  # (U_pad, K_pad) int32
    wgt: np.ndarray  # (U_pad, K_pad) float32
    wl0: np.ndarray  # (U_pad,) float32
    wl1: np.ndarray  # (U_pad,) float32
    valid: np.ndarray  # (U_pad,) bool
    unl_ids: np.ndarray  # (U,) global ids
    remap: np.ndarray  # (num_nodes,) global -> compact (or -1)

    @property
    def bucket_key(self) -> tuple[int, int]:
        return self.nbr.shape


def apply_halo_layout(host: HostSnapshot, plan) -> HostSnapshot:
    """Reorder a host snapshot's rows into a halo export-prefix layout.

    ``plan`` is a ``graph.partition.HaloPlan`` built from THIS snapshot's
    ``nbr`` (same padded row count): rows permute so every
    cross-shard-referenced row leads its shard, and the plan's ``nbr`` is
    already remapped.  Row order is invisible to the fixpoint (each row's
    K-axis order is untouched and updates read neighbors by id), so the
    permuted snapshot gives the same bits; callers keep ``plan.inv_perm``
    to fold solved rows back.  ``unl_ids``/``remap`` stay in the original
    row order.
    """
    if len(plan.perm) != len(host.valid):
        raise ValueError(
            f"halo plan rows {len(plan.perm)} != snapshot rows "
            f"{len(host.valid)}; build the plan from this snapshot's nbr")
    p = plan.perm
    return HostSnapshot(
        nbr=plan.nbr, wgt=host.wgt[p], wl0=host.wl0[p], wl1=host.wl1[p],
        valid=host.valid[p], unl_ids=host.unl_ids, remap=host.remap)


def reorder_host_snapshot(host: HostSnapshot,
                          order: np.ndarray) -> tuple[HostSnapshot, np.ndarray]:
    """Permute a host snapshot's rows by ``order`` (new → old), remapping
    neighbor ids to the new row space.

    The ``bsr`` backend stages with the Step-1 component order
    (``core.components.component_order``) so the adjacency densifies into
    tiles.  Row order is invisible to the fixpoint; returns the permuted
    snapshot and ``inv`` (old → new) for folding solved rows back.
    """
    if len(order) != len(host.valid):
        raise ValueError(f"order has {len(order)} rows, snapshot has "
                         f"{len(host.valid)}")
    nbr, inv = permute_ell_rows(host.nbr, order)
    return HostSnapshot(
        nbr=nbr, wgt=host.wgt[order], wl0=host.wl0[order],
        wl1=host.wl1[order], valid=host.valid[order],
        unl_ids=host.unl_ids, remap=host.remap), inv


def bucket(n: int, ratio: float = 1.3, floor: int = 256) -> int:
    """Round ``n`` up to a geometric bucket (bounded shape count)."""
    b = floor
    while b < n:
        b = int(np.ceil(b * ratio))
    return b


def bucket_k(k: int, floor: int = 8) -> int:
    """Two-regime ladder for the neighbor axis: multiples of 8 up to 64,
    then doubling so hub-degree creep can't produce an unbounded shape
    count."""
    b = floor
    while b < k:
        b = b + 8 if b < 64 else b * 2
    return b


def ladder_size(max_u: int, max_k: int, ratio: float = 1.3,
                floor: int = 256, k_floor: int = 8) -> int:
    """Number of distinct (U_bucket, K_bucket) shapes any stream whose
    snapshots stay within (max_u, max_k) can produce."""
    n_u = 1
    b = floor
    while b < max_u:
        b = bucket(b + 1, ratio=ratio, floor=floor)
        n_u += 1
    n_k = 1
    b = k_floor
    while b < max_k:
        b = bucket_k(b + 1, floor=k_floor)
        n_k += 1
    return n_u * n_k


def build_host_problem(
    g: DynamicGraph,
    max_degree: int | None = None,
    pad_to: int | None = None,
    k_pad: int | None = None,
    auto_bucket: bool = False,
    row_multiple: int | None = None,
    max_k: int | None = None,
    warned: set | None = None,
    hot: np.ndarray | None = None,
) -> HostSnapshot:
    """Host-side (numpy) snapshot build.

    ``row_multiple`` rounds the (possibly bucketed) row count up to a
    multiple.  ``max_k`` caps the ELL neighbor axis: rows whose natural
    degree exceeds it keep only their ``max_k`` *heaviest* edges;
    truncation is logged once per (cap, natural-K rung) per ``warned`` set.
    ``hot`` restricts the rows to a working set and folds each edge to a
    cold unlabeled neighbor v into the supernode weights with v's frozen
    label (``wl0 += w·(1−f_v)``, ``wl1 += w·f_v``).
    """
    if warned is None:
        warned = _MAX_K_WARNED
    alive_unl = g.alive & (g.labels == UNLABELED)
    row_mask = alive_unl if hot is None else alive_unl & hot
    unl_ids = np.flatnonzero(row_mask)
    u = len(unl_ids)
    remap = np.full(g.num_nodes, -1, np.int64)
    remap[unl_ids] = np.arange(u)

    src, dst, wgt = g.src, g.dst, g.wgt
    live = g.alive[src] & g.alive[dst] if len(src) else np.zeros(0, bool)
    src, dst, wgt = src[live], dst[live], wgt[live]

    s_unl = row_mask[src]
    d_unl = alive_unl[dst]
    d_row = d_unl if hot is None else row_mask[dst]

    # (hot) unlabeled -> (hot) unlabeled edges form the ELL tensor
    uu = s_unl & d_row
    csr = coo_to_csr(u, remap[src[uu]], remap[dst[uu]], wgt[uu])
    if max_k is not None:
        deg = np.diff(csr.rowptr)
        nat_k = int(deg.max()) if u else 0
        if nat_k > max_k:
            n_over = int((deg > max_k).sum())
            warn_key = (max_k, bucket_k(nat_k))
            level = (logging.DEBUG if warn_key in warned
                     else logging.WARNING)
            warned.add(warn_key)
            logger.log(
                level,
                "snapshot: max_k=%d truncating %d/%d rows (natural max "
                "degree %d; heaviest-edge policy)", max_k, n_over, u, nat_k)
            max_degree = max_k if max_degree is None else min(max_degree,
                                                             max_k)
    ell = csr_to_ell_fast(csr, max_degree=max_degree)
    nbr, w = ell.nbr.numpy(), ell.wgt.numpy()
    k = nbr.shape[1]
    if auto_bucket:
        pad_to = bucket(u) if pad_to is None else pad_to
        k_pad = bucket_k(k) if k_pad is None else k_pad
    if row_multiple is not None and row_multiple > 1:
        base = pad_to if pad_to is not None else u
        pad_to = -row_multiple * (-base // row_multiple)
    if k_pad is not None and k < k_pad:
        nbr = np.concatenate(
            [nbr, np.full((nbr.shape[0], k_pad - k), -1, np.int32)], axis=1
        )
        w = np.concatenate(
            [w, np.zeros((w.shape[0], k_pad - k), np.float32)], axis=1
        )

    # unlabeled -> labeled edges fold into wl0 / wl1
    wl0 = np.zeros(u, np.float32)
    wl1 = np.zeros(u, np.float32)
    ul = s_unl & ~d_unl
    lab = g.labels[dst[ul]]
    rows = remap[src[ul]]
    np.add.at(wl0, rows[lab == 0], wgt[ul][lab == 0])
    np.add.at(wl1, rows[lab == 1], wgt[ul][lab == 1])

    if hot is not None:
        # hot -> cold-unlabeled edges fold the frozen fractional label as
        # boundary conditions (exact on the hot subgraph)
        uc = s_unl & d_unl & ~d_row
        fv = g.f[dst[uc]].astype(np.float32)
        rows_c = remap[src[uc]]
        np.add.at(wl0, rows_c, wgt[uc] * (1.0 - fv))
        np.add.at(wl1, rows_c, wgt[uc] * fv)

    valid = np.ones(u, bool)
    if pad_to is not None and u < pad_to:  # bucket padding rows
        kk = nbr.shape[1]
        nbr = np.concatenate([nbr, np.full((pad_to - u, kk), -1, np.int32)])
        w = np.concatenate([w, np.zeros((pad_to - u, kk), np.float32)])
        wl0 = np.concatenate([wl0, np.zeros(pad_to - u, np.float32)])
        wl1 = np.concatenate([wl1, np.zeros(pad_to - u, np.float32)])
        valid = np.concatenate([valid, np.zeros(pad_to - u, bool)])

    return HostSnapshot(
        nbr=nbr, wgt=w, wl0=wl0, wl1=wl1, valid=valid,
        unl_ids=unl_ids, remap=remap,
    )


def build_problem(
    g: DynamicGraph,
    max_degree: int | None = None,
    pad_to: int | None = None,
    auto_bucket: bool = False,
    max_k: int | None = None,
    warned: set | None = None,
    device: str | torch.device | None = None,
) -> Snapshot:
    """``build_host_problem`` moved to ``device`` (``None`` → ``cuda``)."""
    dev = resolve_device(device)
    host = build_host_problem(
        g, max_degree=max_degree, pad_to=pad_to, auto_bucket=auto_bucket,
        max_k=max_k, warned=warned,
    )
    problem = PropagationProblem(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (host.nbr, host.wgt, host.wl0, host.wl1, host.valid)))
    return Snapshot(problem=problem, unl_ids=host.unl_ids, remap=host.remap)
