"""Graph containers.

Host side we keep a dynamic CSR-like structure (numpy, growable) mirroring the
paper's CPU-resident 2-D vector graph (§6.3).  Device side we use ELL
(padded neighbor lists): kNN similarity graphs have bounded degree, so padding
to ``max_degree`` turns every irregular CSR loop of the paper into dense
``(N, K)`` tensor ops.

The CSR/COO code is a numpy copy of ``repro.graph.structures`` (the bytes
must match the reference's); ``ELLGraph`` holds torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAD = -1  # ELL padding sentinel for absent neighbor slots.


@dataclasses.dataclass
class ELLGraph:
    """Padded-neighbor-list graph.

    Attributes:
      nbr:  (N, K) int32 neighbor ids, ``PAD`` marks empty slots.
      wgt:  (N, K) float32 edge weights, 0 in empty slots.
    """

    nbr: torch.Tensor
    wgt: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]

    @property
    def slot_mask(self) -> torch.Tensor:
        return self.nbr != PAD

    def degrees(self) -> torch.Tensor:
        return self.slot_mask.sum(dim=1)


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR snapshot (numpy)."""

    rowptr: np.ndarray  # (N+1,) int64
    col: np.ndarray  # (E,) int32
    wgt: np.ndarray  # (E,) float32

    @property
    def num_nodes(self) -> int:
        return len(self.rowptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.col)

    def neighbors(self, u: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.rowptr[u], self.rowptr[u + 1]
        return self.col[lo:hi], self.wgt[lo:hi]


def coo_to_csr(
    num_nodes: int, src: np.ndarray, dst: np.ndarray, wgt: np.ndarray
) -> CSRGraph:
    """Build CSR from (possibly unsorted) COO edge list."""
    order = np.argsort(src, kind="stable")
    src, dst, wgt = src[order], dst[order], wgt[order]
    counts = np.bincount(src, minlength=num_nodes)
    rowptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=rowptr[1:])
    return CSRGraph(rowptr=rowptr, col=dst.astype(np.int32), wgt=wgt.astype(np.float32))


def _ell(nbr: np.ndarray, wgt: np.ndarray) -> ELLGraph:
    return ELLGraph(nbr=torch.from_numpy(nbr), wgt=torch.from_numpy(wgt))


def csr_to_ell(csr: CSRGraph, max_degree: int | None = None) -> ELLGraph:
    """Pad CSR rows to a fixed K.  Rows longer than K keep the K *heaviest*
    edges (kNN graphs rarely exceed 2k after symmetrization; truncation is
    logged by the caller if it happens)."""
    n = csr.num_nodes
    deg = np.diff(csr.rowptr)
    k = int(max_degree or (deg.max() if n else 1) or 1)
    nbr = np.full((n, k), PAD, dtype=np.int32)
    wgt = np.zeros((n, k), dtype=np.float32)
    for u in range(n):
        lo, hi = csr.rowptr[u], csr.rowptr[u + 1]
        cols, ws = csr.col[lo:hi], csr.wgt[lo:hi]
        if len(cols) > k:  # keep heaviest
            top = np.argsort(-ws)[:k]
            cols, ws = cols[top], ws[top]
        nbr[u, : len(cols)] = cols
        wgt[u, : len(cols)] = ws
    return _ell(nbr, wgt)


def csr_to_ell_fast(csr: CSRGraph, max_degree: int | None = None) -> ELLGraph:
    """Vectorized csr_to_ell (no per-row Python loop); used for large graphs.

    Rows longer than K are truncated keeping the heaviest edges.
    """
    n = csr.num_nodes
    deg = np.diff(csr.rowptr).astype(np.int64)
    k = int(max_degree or (deg.max() if n else 1) or 1)
    # slot index of each edge within its row
    edge_row = np.repeat(np.arange(n, dtype=np.int64), deg)
    slot = np.arange(csr.num_edges, dtype=np.int64) - np.repeat(csr.rowptr[:-1], deg)
    if deg.max(initial=0) > k:
        # sort edges within each row by descending weight, then take first k
        order = np.lexsort((-csr.wgt, edge_row))
        edge_row = edge_row[order]
        col_s, wgt_s = csr.col[order], csr.wgt[order]
        slot = np.arange(csr.num_edges, dtype=np.int64) - np.repeat(
            csr.rowptr[:-1], deg
        )
        keep = slot < k
        edge_row, slot, col_s, wgt_s = edge_row[keep], slot[keep], col_s[keep], wgt_s[keep]
    else:
        col_s, wgt_s = csr.col, csr.wgt
    nbr = np.full((n, k), PAD, dtype=np.int32)
    wgt = np.zeros((n, k), dtype=np.float32)
    nbr[edge_row, slot] = col_s
    wgt[edge_row, slot] = wgt_s
    return _ell(nbr, wgt)
