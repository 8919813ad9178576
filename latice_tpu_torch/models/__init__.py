"""The VAE and the carriers of its weights."""

from latice_tpu_torch.models.convert import flax_params_to_state_dict, load_checkpoint
from latice_tpu_torch.models.vae import (
    ConvBlock,
    ConvTransposeBlock,
    Decoder,
    Encoder,
    InstanceNormLeakyReLU,
    VAEOutput,
    VariationalAutoEncoderRawData,
)

__all__ = [
    "ConvBlock",
    "ConvTransposeBlock",
    "Decoder",
    "Encoder",
    "InstanceNormLeakyReLU",
    "VAEOutput",
    "VariationalAutoEncoderRawData",
    "flax_params_to_state_dict",
    "load_checkpoint",
]
