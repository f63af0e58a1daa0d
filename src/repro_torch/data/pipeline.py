"""DynLP-powered data pipeline: semi-supervised pseudo-labeling of a
streaming corpus (the paper's motivating application — dataset annotation
with few ground-truth labels) as a first-class training-data stage.

Counterpart of ``repro.data.pipeline``.  Documents arrive in batches; each
is embedded (pluggable ``embed_fn``; ``default_embed`` is the reference's
numpy function, copied), inserted into the port's dynamic kNN similarity
graph on the host, and labeled incrementally by the port's ``DynLP`` on
``device`` (``None`` → ``cuda``, so every solve runs the sweep kernel).
``select()`` yields confidently-labeled documents of a target class for the
training loop or, as ``examples/torch_serve_lm.py`` does, for serving.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.dynlp import DynLP
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph


def default_embed(tokens: np.ndarray, dim: int = 32) -> np.ndarray:
    """Cheap order-sensitive hash embedding (B, dim): hashed histograms of
    successive-token DIFFS plus token-level hashes.  Diff features make
    sequence structure (walks, loops, periodicity) linearly separable from
    i.i.d. noise while remaining vocabulary-agnostic."""
    b, s = tokens.shape
    out = np.zeros((b, dim), np.float32)
    diffs = (tokens[:, 1:].astype(np.int64) - tokens[:, :-1]) % 65_536
    toks = tokens.astype(np.int64)
    half = dim // 2
    for j in range(half):
        out[:, j] = ((diffs * (j * 2_654_435_761 + 1)) % 997 / 997.0).mean(axis=1)
    for j in range(half, dim):
        out[:, j] = ((toks * (j * 40_503 + 7)) % 991 / 991.0).mean(axis=1)
    return out - out.mean(axis=0, keepdims=True)


@dataclasses.dataclass
class IngestStats:
    num_docs: int
    lp_iterations: int
    lp_ms: float


class PseudoLabelPipeline:
    def __init__(self, embed_fn: Callable | None = None, k: int = 5,
                 delta: float = 1e-4, emb_dim: int = 32,
                 device: str | torch.device | None = None):
        self.embed_fn = embed_fn or (lambda t: default_embed(t, emb_dim))
        self.graph = DynamicGraph(emb_dim=emb_dim, k=k)
        self.lp = DynLP(self.graph, delta=delta, device=device)
        self.docs: dict[int, np.ndarray] = {}

    def ingest(self, tokens: np.ndarray, labels: np.ndarray | None = None,
               drop_ids: np.ndarray | None = None) -> IngestStats:
        """tokens: (B, S) int32; labels: (B,) with 0/1/UNLABELED."""
        b = len(tokens)
        labels = np.full(b, UNLABELED, np.int8) if labels is None else labels
        emb = self.embed_fn(tokens)
        base = self.graph.num_nodes
        st = self.lp.step(BatchUpdate(
            ins_emb=emb, ins_labels=labels.astype(np.int8),
            del_ids=drop_ids if drop_ids is not None else np.zeros(0, np.int64)))
        for i in range(b):
            self.docs[base + i] = tokens[i]
        return IngestStats(num_docs=b, lp_iterations=st.iterations,
                           lp_ms=st.wall_ms)

    def select(self, target_class: int = 1, confidence: float = 0.8,
               limit: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(doc ids, stacked tokens) of confidently pseudo-labeled docs."""
        g = self.graph
        ids = np.flatnonzero(g.alive)
        f = g.f[ids]
        score = f if target_class == 1 else 1.0 - f
        picked = ids[score >= confidence]
        labeled = ids[g.labels[ids] == target_class]
        picked = np.unique(np.concatenate([picked, labeled]))
        picked = np.array([i for i in picked if i in self.docs], np.int64)
        if limit is not None:
            picked = picked[:limit]
        toks = np.stack([self.docs[i] for i in picked]) if len(picked) else \
            np.zeros((0, 0), np.int32)
        return picked, toks

    def label_quality(self, truth: dict[int, int]) -> float:
        g = self.graph
        ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
        if not len(ids):
            return 1.0
        pred = (g.f[ids] >= 0.5).astype(np.int8)
        tr = np.array([truth[i] for i in ids])
        return float((pred == tr).mean())
