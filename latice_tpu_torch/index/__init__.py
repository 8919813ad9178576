"""Search, consensus, the end-to-end pipeline, the dictionary database, the
indexer around it, pattern-space dictionary indexing, band-based (Hough)
indexing and dictionary-free spherical-harmonic indexing."""

from latice_tpu_torch.index.chroma_db import ChromaLatentVectorDatabase
from latice_tpu_torch.index.consensus import (
    ConsensusOutput,
    consensus_from_euler,
    consensus_orientations,
)
from latice_tpu_torch.index.db import (
    LatentVectorDatabaseBase,
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
    parse_faiss_flat_blob,
)
from latice_tpu_torch.index.diagnostics import AmbiguityResult, candidate_ambiguity
from latice_tpu_torch.index.faiss_db import (
    FaissLatentVectorDatabase,
    FaissLatentVectorDatabaseConfig,
)
from latice_tpu_torch.index.hough_indexing import (
    HoughIndexer,
    HoughIndexResult,
    MultiPhaseHoughIndexer,
    MultiPhaseHoughResult,
    band_plane_normals,
    solve_wahba,
)
from latice_tpu_torch.index.indexer import DiffractionPatternIndexer, IndexerConfig
from latice_tpu_torch.index.knn import (
    cosine_topk,
    cosine_topk_approx,
    cosine_topk_blocked,
    cosine_topk_int8,
    cosine_topk_streamed,
    l2_normalize,
    quantize_dictionary_int8,
)
from latice_tpu_torch.index.pattern_di import (
    PatternDictionaryIndexer,
    StreamedPatternDI,
    build_pattern_dictionary,
    ncc_feature_fn,
)
from latice_tpu_torch.index.pipeline import DenseIndexResult, IndexPipeline, concat_dense_results
from latice_tpu_torch.index.result import OrientationResult
from latice_tpu_torch.index.spherical import (
    MultiPhaseSphericalIndexer,
    MultiPhaseSphericalResult,
    SphericalIndexer,
    SphericalIndexerConfig,
    SphericalResult,
)

__all__ = [
    "AmbiguityResult",
    "ChromaLatentVectorDatabase",
    "ConsensusOutput",
    "DenseIndexResult",
    "DiffractionPatternIndexer",
    "FaissLatentVectorDatabase",
    "FaissLatentVectorDatabaseConfig",
    "HoughIndexResult",
    "HoughIndexer",
    "IndexPipeline",
    "IndexerConfig",
    "LatentVectorDatabaseBase",
    "LatentVectorDatabaseConfig",
    "MultiPhaseHoughIndexer",
    "MultiPhaseHoughResult",
    "OrientationResult",
    "MultiPhaseSphericalIndexer",
    "MultiPhaseSphericalResult",
    "PatternDictionaryIndexer",
    "SphericalIndexer",
    "SphericalIndexerConfig",
    "SphericalResult",
    "StreamedPatternDI",
    "TorchLatentVectorDatabase",
    "band_plane_normals",
    "build_pattern_dictionary",
    "candidate_ambiguity",
    "concat_dense_results",
    "consensus_from_euler",
    "consensus_orientations",
    "cosine_topk",
    "cosine_topk_approx",
    "cosine_topk_blocked",
    "cosine_topk_int8",
    "cosine_topk_streamed",
    "l2_normalize",
    "ncc_feature_fn",
    "parse_faiss_flat_blob",
    "quantize_dictionary_int8",
    "solve_wahba",
]
