"""Device-resident streaming kNN ingestion (single device).

Counterpart of ``repro.ingest``: ``EmbeddingStore`` keeps every vertex's
normalized embedding resident on the card in a bucket-ladder tensor, and
``DeviceIngestor`` plugs into ``graph.dynamic.apply_batch`` as the candidate
selector, running the argkmin kernel (``kernels.argkmin``) instead of the
host BLAS staging path.
"""

from .embedding_store import EmbeddingStore, ShardedEmbeddingStore
from .incremental_knn import DeviceIngestor, ingest_cache_size, ingest_ladder_bound

__all__ = [
    "EmbeddingStore",
    "ShardedEmbeddingStore",
    "DeviceIngestor",
    "ingest_cache_size",
    "ingest_ladder_bound",
]
