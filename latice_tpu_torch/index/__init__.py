"""Search, consensus, the end-to-end pipeline and the dictionary store."""

from latice_tpu_torch.index.consensus import ConsensusOutput, consensus_orientations
from latice_tpu_torch.index.db import (
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
    parse_faiss_flat_blob,
)
from latice_tpu_torch.index.knn import cosine_topk, l2_normalize
from latice_tpu_torch.index.pipeline import DenseIndexResult, IndexPipeline, concat_dense_results

__all__ = [
    "ConsensusOutput",
    "DenseIndexResult",
    "IndexPipeline",
    "LatentVectorDatabaseConfig",
    "TorchLatentVectorDatabase",
    "concat_dense_results",
    "consensus_orientations",
    "cosine_topk",
    "l2_normalize",
    "parse_faiss_flat_blob",
]
