"""Synthetic dataset / stream generators mirroring the paper's §7.1 setup.

Numpy copy of ``repro.data.synth`` over the port's graph layer: the same
seed gives the same batches in both packages.

Two families:
  * ``gaussian_mixture_stream`` — embedding-space data (mimics the
    IMDB/ImageNet/Yelp pipelines: feature vectors → cosine kNN graph).  Two
    class centroids; class determines the ground-truth binary label.
  * ``erdos_renyi_graph`` — planted-partition sparse random graph with a
    target average degree (the paper's "Random Dataset", degrees {3,5,7});
    used through a synthetic-embedding trick so the same kNN machinery
    applies: we emit embeddings whose kNN graph has the requested degree by
    sampling per-class Gaussians with controlled spread.

The paper's batch protocol: each Δ_t is 90% unlabeled insertions, 1%
ground-truth insertions, 9% deletions of existing vertices.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.graph.dynamic import UNLABELED, BatchUpdate


@dataclasses.dataclass
class StreamSpec:
    total_vertices: int
    batch_size: int
    emb_dim: int = 16
    frac_unlabeled: float = 0.90
    frac_labeled: float = 0.01
    frac_deleted: float = 0.09
    class_sep: float = 4.0  # distance between class centroids
    noise: float = 1.0
    seed: int = 0


def _sample_points(
    rng: np.random.Generator, n: int, spec: StreamSpec
) -> tuple[np.ndarray, np.ndarray]:
    """Two-Gaussian mixture; returns (embeddings, true class)."""
    cls = rng.integers(0, 2, size=n).astype(np.int8)
    centers = np.zeros((2, spec.emb_dim), np.float32)
    centers[0, 0] = -spec.class_sep / 2
    centers[1, 0] = +spec.class_sep / 2
    emb = centers[cls] + rng.normal(0, spec.noise, size=(n, spec.emb_dim)).astype(
        np.float32
    )
    return emb, cls


def gaussian_mixture_stream(
    spec: StreamSpec,
) -> Iterator[tuple[BatchUpdate, np.ndarray]]:
    """Yields (BatchUpdate, true_classes_of_inserted) until ``total_vertices``
    have been inserted.  Deletions sample uniformly from previously inserted
    vertices (the caller's graph ignores already-dead ids)."""
    rng = np.random.default_rng(spec.seed)
    inserted = 0
    next_id = 0
    while inserted < spec.total_vertices:
        b = min(spec.batch_size, spec.total_vertices - inserted)
        n_lab = max(1, int(round(b * spec.frac_labeled))) if inserted == 0 else int(
            round(b * spec.frac_labeled)
        )
        n_del = int(round(b * spec.frac_deleted)) if next_id > 0 else 0
        n_unl = b - n_lab
        emb, cls = _sample_points(rng, b, spec)
        labels = np.full(b, UNLABELED, np.int8)
        lab_idx = rng.choice(b, size=n_lab, replace=False) if n_lab else np.zeros(0, int)
        labels[lab_idx] = cls[lab_idx]
        del_ids = (
            rng.integers(0, next_id, size=n_del).astype(np.int64)
            if n_del
            else np.zeros(0, np.int64)
        )
        yield BatchUpdate(ins_emb=emb, ins_labels=labels, del_ids=del_ids), cls
        inserted += b
        next_id += b
        del n_unl


def cosine_locality_order(emb: np.ndarray) -> np.ndarray:
    """Arrival order matched to the graph's COSINE kNN metric: an angular
    sweep over the normalized embeddings' dominant 2-plane (top-2 right
    singular vectors), so consecutive ids are angular — i.e. cosine —
    neighbors.  A Euclidean space-filling order is the wrong curve here:
    ``graph.knn.knn_edges`` compares directions, not positions, so only
    an angular order makes kNN references id-local.  Exact for 2-d
    embeddings (the sweep IS the metric); an approximation in higher
    dimensions, where neighborhoods spread over axes outside the
    dominant plane."""
    q = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    _, _, vt = np.linalg.svd(q, full_matrices=False)
    xy = q @ vt[:2].T
    return np.argsort(np.arctan2(xy[:, 1], xy[:, 0]), kind="stable")


def locality_stream(
    spec: StreamSpec,
    delete_window: int = 2,
) -> Iterator[tuple[BatchUpdate, np.ndarray]]:
    """Locality-ordered variant of ``gaussian_mixture_stream``: the same
    two-Gaussian population, but vertices arrive in cosine-locality order
    (``cosine_locality_order``), so insertion ids — and therefore the
    snapshot's bucket rows — are kNN-contiguous.  Cross-shard references
    then concentrate at contiguous-shard boundaries and halo export sets
    stay small (<2% of rows for 2-d mixtures): this is the stream shape
    the ``transport="halo"`` arm of ``benchmarks/stream_throughput.py``
    measures (real analogues: time-ordered event streams, CC-clustered /
    partition-ordered ingest).  Use ``emb_dim=2`` when the kNN topology
    itself must be id-local.  Deletions sample only from the trailing
    ``delete_window`` batches so they do not break the locality of old
    shards.  Ground-truth labels are still sprinkled uniformly per batch
    (batch 0 guarantees at least one seed).
    """
    rng = np.random.default_rng(spec.seed)
    emb, cls = _sample_points(rng, spec.total_vertices, spec)
    order = cosine_locality_order(emb)
    emb, cls = emb[order], cls[order]
    next_id = 0
    while next_id < spec.total_vertices:
        b = min(spec.batch_size, spec.total_vertices - next_id)
        e = emb[next_id:next_id + b]
        c = cls[next_id:next_id + b]
        n_lab = int(round(b * spec.frac_labeled))
        if next_id == 0:
            n_lab = max(1, n_lab)
        labels = np.full(b, UNLABELED, np.int8)
        lab_idx = (rng.choice(b, size=n_lab, replace=False) if n_lab
                   else np.zeros(0, int))
        labels[lab_idx] = c[lab_idx]
        n_del = int(round(b * spec.frac_deleted)) if next_id else 0
        lo = max(0, next_id - delete_window * spec.batch_size)
        del_ids = (rng.integers(lo, next_id, size=n_del).astype(np.int64)
                   if n_del else np.zeros(0, np.int64))
        yield BatchUpdate(ins_emb=e, ins_labels=labels, del_ids=del_ids), c
        next_id += b


def hub_stream(
    n_batches: int = 5,
    per_hub: int = 20,
    hubs: int = 2,
    emb_dim: int = 8,
    class_sep: float = 2.0,
    spread: float = 0.02,
    seed: int = 0,
) -> Iterator[tuple[BatchUpdate, np.ndarray]]:
    """Hub-heavy stream: every batch drops ``per_hub`` vertices into a
    tight cloud around each of ``hubs`` fixed centers, so the hub
    vertices' kNN in-degree — and the snapshot's natural ELL K — grows
    with every batch.  The stress case for the ``max_k`` heaviest-edge
    cap (ROADMAP follow-up): without a cap the K-bucket ladder climbs
    batch after batch; with one, truncation must not change the label a
    hub neighborhood converges to.  Hubs alternate classes along axis 0
    (ground truth = nearest hub's class); batch 0 seeds one labeled
    anchor per class at the hub centers.
    """
    rng = np.random.default_rng(seed)
    centers = np.zeros((hubs, emb_dim), np.float32)
    cls = (np.arange(hubs) % 2).astype(np.int8)
    centers[:, 0] = np.where(cls == 1, class_sep / 2, -class_sep / 2)
    centers[:, 1] = np.arange(hubs)  # separate hubs within a class
    for b in range(n_batches):
        emb = np.repeat(centers, per_hub, axis=0) + rng.normal(
            0, spread, (hubs * per_hub, emb_dim)).astype(np.float32)
        truth = np.repeat(cls, per_hub)
        labels = np.full(len(emb), UNLABELED, np.int8)
        if b == 0:  # seed the hub centers themselves, ground-truth labeled
            emb = np.concatenate([centers, emb])
            truth = np.concatenate([cls, truth])
            labels = np.concatenate([cls, labels])
        yield BatchUpdate(ins_emb=emb, ins_labels=labels,
                          del_ids=np.zeros(0, np.int64)), truth


def seeded_graph(
    n: int, spec: StreamSpec, frac_labeled: float = 0.01
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot dataset: (embeddings, labels-with-ground-truth-mask, classes)."""
    rng = np.random.default_rng(spec.seed)
    emb, cls = _sample_points(rng, n, spec)
    labels = np.full(n, UNLABELED, np.int8)
    n_lab = max(2, int(round(n * frac_labeled)))
    idx = rng.choice(n, size=n_lab, replace=False)
    labels[idx] = cls[idx]
    # guarantee both classes are seeded
    if not (labels == 0).any():
        labels[np.flatnonzero(cls == 0)[0]] = 0
    if not (labels == 1).any():
        labels[np.flatnonzero(cls == 1)[0]] = 1
    return emb, labels, cls


def accuracy(pred: np.ndarray, truth: np.ndarray) -> float:
    """Fraction of matching binary labels (paper's accuracy metric)."""
    return float((pred == truth).mean()) if len(pred) else 1.0


def make_documents(rng: np.random.Generator, n: int, seq: int, vocab: int,
                   frac_labeled: float = 0.02):
    """Token documents of two latent domains, for ``data.pipeline``: A =
    ascending mod-vocab walks (learnable), B = i.i.d. noise (pollution the
    curation step should filter out); ``frac_labeled`` of them carry their
    domain as a label.  Returns (tokens (n, seq) int32, labels, domains).
    A copy of ``examples/semi_supervised_lm.py::make_documents``: the same
    generator state gives the same documents."""
    cls = rng.integers(0, 2, size=n).astype(np.int8)
    toks = np.zeros((n, seq), np.int32)
    a = cls == 1
    base = rng.integers(0, vocab, size=(n, 1))
    toks[a] = (base[a] + np.arange(seq)[None, :]) % vocab
    toks[~a] = rng.integers(0, vocab, size=((~a).sum(), seq))
    labels = np.full(n, UNLABELED, np.int8)
    lab = rng.random(n) < frac_labeled
    labels[lab] = cls[lab]
    return toks, labels, cls
