"""latice_tpu_torch: the PyTorch + CUDA port of latice_tpu for NVIDIA Hopper.

EBSD pattern indexing with a convolutional VAE's latent dictionary: encode
patterns, search the dictionary by exact cosine top-k, and reach a
crystal-symmetry-aware consensus orientation; and training of that VAE
(`train`, ``python -m latice_tpu_torch.cli.train``). The JAX package
``latice_tpu`` is the reference this port is held against; this package
imports torch, numpy and the standard library, never JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(`resolve_device`). The hand-written Hopper kernels live in `ops`, each
beside its plain torch twin, which runs on CPU tensors.
"""

from latice_tpu_torch.device import resolve_device
from latice_tpu_torch.index import (
    DenseIndexResult,
    IndexPipeline,
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
)
from latice_tpu_torch.models import (
    VariationalAutoEncoderRawData,
    flax_params_to_state_dict,
    load_checkpoint,
)
from latice_tpu_torch.serve import IndexService, make_server

__all__ = [
    "DenseIndexResult",
    "IndexPipeline",
    "IndexService",
    "LatentVectorDatabaseConfig",
    "TorchLatentVectorDatabase",
    "VariationalAutoEncoderRawData",
    "flax_params_to_state_dict",
    "load_checkpoint",
    "make_server",
    "resolve_device",
]
