"""Parallelism: device meshes, data-parallel placement, sharded k-NN.

A mesh is an ordered list of torch devices driven by one process
(`make_mesh`), the counterpart of the JAX package's single-controller
``jax.sharding.Mesh``."""

from latice_tpu_torch.parallel.mesh import (
    Mesh,
    data_parallel_sharding,
    dp_dispatch_plan,
    make_mesh,
    replicate,
    replicate_state,
    shard_batch,
)
from latice_tpu_torch.parallel.sharded_knn import (
    shard_dictionary,
    sharded_cosine_topk,
    sharded_cosine_topk_inner,
)

__all__ = [
    "data_parallel_sharding",
    "dp_dispatch_plan",
    "make_mesh",
    "replicate",
    "replicate_state",
    "shard_batch",
    "shard_dictionary",
    "sharded_cosine_topk",
    "sharded_cosine_topk_inner",
]
