from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, BatchEffect, DynamicGraph
from repro_torch.graph.knn import build_knn_graph, knn_edges, symmetrize
from repro_torch.graph.structures import (
    PAD,
    CSRGraph,
    ELLGraph,
    coo_to_csr,
    csr_to_ell,
    csr_to_ell_fast,
)
