"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin.

Every wrapper launches its kernel on a CUDA tensor (counting the launch in
its ``launches`` attribute) and runs the plain version on a CPU tensor.
"""

from latice_tpu_torch.ops.fused_norm import (
    InstanceNormLeakyReLUFunction,
    instance_norm_leaky_relu,
    instance_norm_leaky_relu_backward,
    instance_norm_leaky_relu_backward_plain,
    instance_norm_leaky_relu_plain,
)
from latice_tpu_torch.ops.topk_fused import cosine_topk_fused, cosine_topk_fused_plain

__all__ = [
    "InstanceNormLeakyReLUFunction",
    "cosine_topk_fused",
    "cosine_topk_fused_plain",
    "instance_norm_leaky_relu",
    "instance_norm_leaky_relu_backward",
    "instance_norm_leaky_relu_backward_plain",
    "instance_norm_leaky_relu_plain",
]
