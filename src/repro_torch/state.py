"""Carry state from the JAX package into the port.

This system has no weights: its state is the graph, the labels and (with
device ingest) the embedding store.  These functions let both packages
compute the same thing from the same state (the tests hand a stream over
from the reference to the port mid-way).  They take plain numpy arrays, so
the port never imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.propagate import PropagationProblem
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import DynamicGraph
from repro_torch.ingest.embedding_store import EmbeddingStore
from repro_torch.kernels.bsr_spmv import BsrLayout


def graph_from_reference(arrays: dict[str, np.ndarray], emb_dim: int,
                         k: int) -> DynamicGraph:
    """A port ``DynamicGraph`` from the reference's
    ``DynamicGraph.state_arrays()`` (the same keys), via the port's own
    ``load_state_arrays``."""
    g = DynamicGraph(emb_dim=emb_dim, k=k)
    g.load_state_arrays(arrays)
    return g


def problem_from_arrays(nbr, wgt, wl0, wl1, valid,
                        device: str | torch.device | None = None
                        ) -> PropagationProblem:
    """A port ``PropagationProblem`` on ``device`` (``None`` → ``cuda``)
    from numpy problem arrays: a reference ``HostSnapshot``'s, or
    ``np.asarray`` of a reference ``PropagationProblem``'s fields."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731 (a copy)
    return PropagationProblem(nbr=as_t(nbr, np.int32), wgt=as_t(wgt, np.float32),
                              wl0=as_t(wl0, np.float32), wl1=as_t(wl1, np.float32),
                              valid=as_t(valid, np.bool_))


def store_from_reference(arrays: dict[str, np.ndarray], count: int, emb_dim: int,
                         device: str | torch.device | None = None) -> EmbeddingStore:
    """A port ``EmbeddingStore`` on ``device`` (``None`` → ``cuda``) from
    the reference's ``EmbeddingStore.state_arrays()`` as numpy arrays
    (``emb``, ``valid``, ``kth``) and its ``count``; pass it to
    ``DeviceIngestor(store=...)`` to go on with the reference's stream."""
    store = EmbeddingStore(emb_dim, device=device)
    store.load_state_arrays({k: np.asarray(arrays[k]) for k in ("emb", "valid", "kth")},
                            count)
    return store


def bsr_layout_from_reference(slot, num_slots: int, n_blocks: int, nnz: int,
                              block_size: int) -> BsrLayout:
    """A port ``BsrLayout`` from a reference ``BsrLayout``'s fields
    (``slot`` as a numpy array, the rest as ints)."""
    return BsrLayout(slot=np.array(slot, np.int32), num_slots=int(num_slots),
                     n_blocks=int(n_blocks), nnz=int(nnz), block_size=int(block_size))
