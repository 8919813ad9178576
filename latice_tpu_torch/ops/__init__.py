"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin.

Every wrapper launches its kernel on a CUDA tensor (counting the launch in
its ``launches`` attribute) and runs the plain version on a CPU tensor.
"""

from latice_tpu_torch.ops.consensus_fused import (
    ConsensusResult,
    candidate_consensus_fused,
    candidate_consensus_fused_plain,
)
from latice_tpu_torch.ops.fused_norm import (
    InstanceNormLeakyReLUFunction,
    instance_norm_leaky_relu,
    instance_norm_leaky_relu_backward,
    instance_norm_leaky_relu_backward_plain,
    instance_norm_leaky_relu_plain,
)
from latice_tpu_torch.ops.stage0_fused import (
    fused_stage0_apply,
    stage0_fused,
    stage0_fused_reference,
)
from latice_tpu_torch.ops.topk_fused import cosine_topk_fused, cosine_topk_fused_plain
from latice_tpu_torch.ops.topk_wide import cosine_topk_wide, cosine_topk_wide_plain

__all__ = [
    "ConsensusResult",
    "InstanceNormLeakyReLUFunction",
    "candidate_consensus_fused",
    "candidate_consensus_fused_plain",
    "cosine_topk_fused",
    "cosine_topk_fused_plain",
    "cosine_topk_wide",
    "cosine_topk_wide_plain",
    "fused_stage0_apply",
    "instance_norm_leaky_relu",
    "instance_norm_leaky_relu_backward",
    "instance_norm_leaky_relu_backward_plain",
    "instance_norm_leaky_relu_plain",
    "stage0_fused",
    "stage0_fused_reference",
]
