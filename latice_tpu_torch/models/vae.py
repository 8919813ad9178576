"""Convolutional VAE for EBSD patterns, in the reference's torch layout.

The architecture is ``latice_tpu.models.vae.VariationalAutoEncoderRawData``
(reference latice/model.py:83-150) written as ``nn.Module``s over NCHW
tensors, with module indices that give the reference state-dict keys
(``encoder.{i}.0.weight``, ``mu.0.weight``, ``decoder.{i}.0.weight``, ...),
so a reference ``vae-best.pt`` loads straight in:

* encoder: ``n_stages`` stages of [2x (Conv3x3 -> InstanceNorm ->
  LeakyReLU(0.02)) -> MaxPool2], widths P, 2P, then 4P; block b of stage s
  sits at index ``3s+b`` and its pool at ``3s+2``;
* heads: Linear over the CHW-flattened bottleneck to ``latent_dim`` for mu
  and logvar;
* decoder: Linear to the bottleneck, then per stage nearest-2x upsample
  (index ``3s``) and two ConvTranspose3x3 blocks (``3s+1``, ``3s+2``); the
  last stage is the upsample, one block and the logit conv, no sigmoid.
  With ``fuse_upsample`` (the default, as in the JAX decoder; the
  environment's ``LATICE_TPU_FUSED_UPSAMPLE=0`` turns it off) each
  upsample folds into the next block's convolution, one stride-2
  transposed convolution over a composed 4x4 kernel, and slot ``3s`` holds
  a module without parameters, so the state-dict keys do not change.

Each InstanceNorm + LeakyReLU is `ops.InstanceNormLeakyReLUFunction`: the
fused CUDA kernels forward and backward on the card, their plain torch
twins on the CPU.

An encoder block's convolution feeds a norm without affine, which
subtracts each (n, c) plane's mean, so the convolution's per-channel bias
cancels: ``norm(conv(x) + b) == norm(conv(x))``. On the card, in bfloat16
and with autograd off (`ConvBlock`), the block therefore runs its
convolution without the bias, which saves ATen's broadcast add over the
whole output after cuDNN and a rounding of it to bfloat16. Everything else
keeps the add, bit for bit: the CPU, where the port is held to the JAX
package's outputs byte for byte; float32, the parity mode, which keeps the
reference's order of operations; and training, where the bias still gets
its gradient, which Adam normalizes into a real update however small. The
parameters and state-dict keys do not change. The decoder's blocks and the
logit convolution keep their bias.

Under the same gate the encoder runs in ``torch.channels_last``: cuDNN's
Hopper convolutions take NHWC only, and fed NCHW they wrap every call in
two layout transforms. A block given a channels_last input of several
channels hands cuDNN its weight as a bfloat16 channels_last copy, made
once per version of the parameter (`ConvBlock.weight_for`), so no call
re-lays out a weight, and cuDNN returns NHWC. The first block's input,
the one-channel patterns, is both layouts at once: its convolution keeps
NCHW, cuDNN's implicit GEMM for one input channel (in NHWC cuDNN pads the
channel to eight through a layout transform), and its norm reads that
NCHW output and writes NHWC. Every block's norm writes channels_last
through K2f's NHWC kernel, and max-pool runs ATen's channels_last kernel.
The flatten before ``mu`` and ``logvar`` copies the bottleneck into its
CHW order. Everything else stays NCHW: the CPU, float32, training, the
decoder, and blocks fed an NCHW tensor of several channels (K3's stage-0
path).

``remat`` trades recomputation for the activations the backward keeps, as
the JAX model's does: ``"block"`` checkpoints each conv block, ``"stage"``
each conv-conv-pool stage of the encoder and each upsample-conv-conv stage
of the decoder but its last (`torch.utils.checkpoint`, non-reentrant, which
replays the forward under the autocast state it ran in). The backward then
runs each checkpointed InstanceNorm forward a second time. State-dict names
do not change.

Precision follows ``latice_tpu.train.module.VAEModule.with_precision``:
``"32"`` computes in float32, its convolutions in full float32 (TF32 off
inside the model's forward, `device.no_tf32`); ``"16-mixed"`` runs the
encoder and decoder under bfloat16 autocast with float32 parameters, and
``mu`` and ``logvar`` come out in float32, as the JAX model casts them.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from latice_tpu_torch.device import no_onednn, no_tf32
from latice_tpu_torch.ops.fused_norm import InstanceNormLeakyReLUFunction
from latice_tpu_torch.utils.profiling import count

__all__ = [
    "InstanceNormLeakyReLU",
    "ConvBlock",
    "ConvTransposeBlock",
    "Encoder",
    "Decoder",
    "VariationalAutoEncoderRawData",
    "VAEOutput",
    "compute_dtype",
]


def compute_dtype(precision: str | int) -> torch.dtype:
    """The compute dtype of a precision name, as ``VAEModule.with_precision``
    reads it: ``"16-mixed"``, ``"bf16-mixed"`` and ``"bf16"`` are bfloat16;
    ``"32"``, ``"32-true"``, ``"fp32"`` and ``32`` are float32."""
    if precision in ("16-mixed", "bf16-mixed", "bf16"):
        return torch.bfloat16
    if precision in ("32", "32-true", "fp32", 32):
        return torch.float32
    raise ValueError(f"Unknown precision {precision!r}")


class InstanceNormLeakyReLU(nn.Module):
    """InstanceNorm2d(affine=False, eps=1e-5) then LeakyReLU(0.02), through
    the fused op and its fused backward, in the layout it is given: NCHW,
    or channels_last (module docstring); other strides become NCHW. The
    output is in ``memory_format``, by default the input's."""

    def forward(self, x: torch.Tensor,
                memory_format: torch.memory_format | None = None) -> torch.Tensor:
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        return InstanceNormLeakyReLUFunction.apply(x, 1e-5, 0.02, memory_format)


def _bias_cancels(x: torch.Tensor) -> bool:
    """Whether a block may leave out the bias that its norm cancels: ``x``
    is on the card, autocast computes in bfloat16 (the model's 16-mixed)
    and autograd is off."""
    return (x.is_cuda and not torch.is_grad_enabled() and torch.is_autocast_enabled("cuda")
            and torch.get_autocast_dtype("cuda") == torch.bfloat16)


class ConvBlock(nn.Sequential):
    """Conv3x3(stride 1, pad 1) -> InstanceNorm -> LeakyReLU(0.02); where
    `_bias_cancels`, through `bias_free`, counted as
    ``encoder.bias_free_convs``."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__(nn.Conv2d(in_channels, out_channels, 3, 1, 1), InstanceNormLeakyReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _bias_cancels(x):
            count("encoder.bias_free_convs")
            return self.bias_free(x)
        return super().forward(x)

    def bias_free(self, x: torch.Tensor) -> torch.Tensor:
        """The block with its convolution's bias left out, which the norm
        cancels; its output in channels_last where ``x`` is (one channel
        always is), else NCHW (module docstring)."""
        conv, norm = self[0], self[1]
        h = conv._conv_forward(x, self.weight_for(x), None)
        if x.is_contiguous(memory_format=torch.channels_last):
            return norm(h, torch.channels_last)
        return norm(h)

    def weight_for(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution's weight as cuDNN should take it with ``x``: for
        a channels_last ``x`` of several channels under autocast, the
        weight in the autocast dtype and in channels_last, kept until the
        parameter changes (its storage or its version), so that no call
        re-lays it out; else the parameter, which autocast casts."""
        weight = self[0].weight
        device = x.device.type
        if not (x.shape[1] > 1 and x.is_contiguous(memory_format=torch.channels_last)
                and torch.is_autocast_enabled(device)):
            return weight
        dtype = torch.get_autocast_dtype(device)
        key = (weight.device, weight.data_ptr(), weight._version, dtype)
        kept = getattr(self, "_nhwc_weight", None)
        if kept is None or kept[0] != key:
            kept = (key, weight.detach().to(dtype, memory_format=torch.channels_last))
            self._nhwc_weight = kept
        return kept[1]


class _FusedUpsampleConvTranspose2d(nn.ConvTranspose2d):
    """Nearest-2x upsample + ConvTranspose3x3(stride 1, pad 1) as one
    stride-2 transposed convolution (the JAX ``_FusedUpsampleConvTranspose``).

    Nearest duplication is zero insertion followed by a 2x2 window of ones,
    so the 3x3 kernel correlated with that window is one 4x4 kernel,
    ``K4[e, f] = sum_{s,t in {0,1}} K[e-s, f-t]``, applied at stride 2: the
    4x-size upsampled input is never made and the convolution does 2.25x
    fewer multiplies. The kernel is composed in the parameter's dtype,
    before autocast casts it. Parameters are the plain layer's. On the CPU
    it runs ATen's kernel (`device.no_onednn`), which computes each row of
    the batch alone.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wp = F.pad(self.weight, (0, 1, 0, 1))
        w4 = wp + wp.roll(1, 2) + wp.roll(1, 3) + wp.roll(1, 2).roll(1, 3)
        with no_onednn() if x.device.type == "cpu" else contextlib.nullcontext():
            return F.conv_transpose2d(x, w4, self.bias, stride=2, padding=1)


class _FoldedUpsample(nn.Identity):
    """The slot of a nearest-2x upsample that the next block's convolution
    has folded in; it keeps the decoder's module indices."""


class ConvTransposeBlock(nn.Sequential):
    """ConvTranspose3x3(stride 1, pad 1) -> InstanceNorm -> LeakyReLU(0.02);
    with ``pre_upsample``, a nearest-2x upsample folded into the
    convolution first."""

    def __init__(self, in_channels: int, out_channels: int, pre_upsample: bool = False) -> None:
        conv = _FusedUpsampleConvTranspose2d if pre_upsample else nn.ConvTranspose2d
        super().__init__(conv(in_channels, out_channels, 3, 1, 1), InstanceNormLeakyReLU())


REMAT_MODES = ("none", "block", "stage")


def _check_remat(remat: str) -> str:
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    return remat


def _run_layers(layers: list[nn.Module], x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = layer(x)
    return x


def _remat_forward(layers: list[nn.Module], x: torch.Tensor, remat: str, n_staged: int):
    """Run ``layers`` (stages of three) with ``remat``: ``"block"``
    checkpoints every conv block, ``"stage"`` each of the first
    ``n_staged`` stages, ``"none"`` nothing."""
    if remat == "stage":
        for i in range(0, len(layers), 3):
            stage = layers[i : i + 3]
            if i // 3 < n_staged:
                x = checkpoint(_run_layers, stage, x, use_reentrant=False)
            else:
                x = _run_layers(stage, x)
        return x
    for layer in layers:
        if remat == "block" and isinstance(layer, (ConvBlock, ConvTransposeBlock)):
            x = checkpoint(layer, x, use_reentrant=False)
        else:
            x = layer(x)
    return x


def _encoder_widths(inplanes: int, n_stages: int) -> list[int]:
    return [inplanes, 2 * inplanes] + [4 * inplanes] * (n_stages - 2)


class _Stack(nn.Sequential):
    """A Sequential whose slices are plain ``nn.Sequential``s: Sequential's
    own slicing calls ``type(self)(OrderedDict)``, which a subclass with its
    own constructor arguments cannot take."""

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return nn.Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class Encoder(_Stack):
    """``n_stages`` conv-conv-pool stages, 1 channel in, 4P channels out;
    ``remat`` as in the module docstring."""

    def __init__(self, inplanes: int = 32, n_stages: int = 5, remat: str = "none") -> None:
        layers: list[nn.Module] = []
        c_in = 1
        for width in _encoder_widths(inplanes, n_stages):
            layers += [ConvBlock(c_in, width), ConvBlock(width, width), nn.MaxPool2d(2, 2)]
            c_in = width
        super().__init__(*layers)
        self.remat = _check_remat(remat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self._modules.values())
        return _remat_forward(layers, x, self.remat, n_staged=len(layers) // 3)


class Decoder(nn.Sequential):
    """Upsampling decoder, 4P channels in, one logit channel out; ``remat``
    as in the module docstring (the last stage, one block and the logit
    conv, is never checkpointed whole, as in the JAX decoder).

    ``fuse_upsample`` folds each upsample into the next block's convolution
    (`_FusedUpsampleConvTranspose2d`); ``LATICE_TPU_FUSED_UPSAMPLE``, when
    set, overrides it (``1`` fuses, anything else materializes), read when
    the decoder is built. With ``remat="block"`` the checkpointed fused
    block holds its upsample, as JAX's ``nn.remat(ConvTransposeBlock)``
    with ``pre_upsample`` does.
    """

    def __init__(
        self, inplanes: int = 32, n_stages: int = 5, remat: str = "none",
        fuse_upsample: bool = True,
    ) -> None:
        env = os.environ.get("LATICE_TPU_FUSED_UPSAMPLE")
        fuse = fuse_upsample if env is None else env == "1"
        p = inplanes
        stages = [(4 * p, 4 * p)] * (n_stages - 3) + [(4 * p, 2 * p), (2 * p, p)]

        def upsample() -> nn.Module:
            return _FoldedUpsample() if fuse else nn.Upsample(scale_factor=2, mode="nearest")

        layers: list[nn.Module] = []
        c_in = 4 * p
        for c1, c2 in stages:
            layers += [
                upsample(),
                ConvTransposeBlock(c_in, c1, pre_upsample=fuse),
                ConvTransposeBlock(c1, c2),
            ]
            c_in = c2
        layers += [
            upsample(),
            ConvTransposeBlock(c_in, p, pre_upsample=fuse),
            nn.Conv2d(p, 1, 3, 1, 1),
        ]
        super().__init__(*layers)
        self.remat = _check_remat(remat)
        self.n_stages = n_stages
        self.fuse_upsample = fuse

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _remat_forward(list(self._modules.values()), x, self.remat, self.n_stages - 1)


class VAEOutput(NamedTuple):
    """``(z, x_hat, mu, std)``, the reference forward contract."""

    z: torch.Tensor
    x_hat: torch.Tensor
    mu: torch.Tensor
    std: torch.Tensor


class VariationalAutoEncoderRawData(nn.Module):
    """Convolutional VAE over raw EBSD patterns (NCHW, one channel).

    ``bottleneck_hw`` is the spatial size after the encoder, the image size
    over ``2 ** n_stages`` (4 for 128x128 patterns and 5 stages). ``remat``
    (``"none"``, ``"block"`` or ``"stage"``) checkpoints the encoder and
    decoder for the backward, as the JAX model's ``remat`` does.
    """

    def __init__(
        self,
        inplanes: int = 32,
        latent_dim: int = 16,
        n_stages: int = 5,
        bottleneck_hw: int = 4,
        remat: str = "none",
    ) -> None:
        super().__init__()
        if n_stages < 3:
            raise ValueError(f"n_stages must be at least 3, got {n_stages}")
        self.inplanes = inplanes
        self.latent_dim = latent_dim
        self.n_stages = n_stages
        self.bottleneck_hw = bottleneck_hw
        self.compute_dtype = torch.float32  # see set_precision
        flat = 4 * inplanes * bottleneck_hw * bottleneck_hw
        self.remat = _check_remat(remat)
        self.encoder = Encoder(inplanes, n_stages, remat)
        self.mu = nn.Sequential(nn.Linear(flat, latent_dim))
        self.logvar = nn.Sequential(nn.Linear(flat, latent_dim))
        self.linear2 = nn.Sequential(nn.Linear(latent_dim, flat))
        self.decoder = Decoder(inplanes, n_stages, remat)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VariationalAutoEncoderRawData":
        """Redraw every weight and bias from ``generator``, uniform in
        ``±1/sqrt(fan_in)`` (torch's default bounds for these layers)."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(module.weight)
                bound = fan_in**-0.5
                for param in (module.weight, module.bias):
                    rand = torch.rand(param.shape, generator=generator, dtype=param.dtype)
                    param.copy_(rand * (2 * bound) - bound)
        return self

    def set_precision(self, precision: str | int) -> "VariationalAutoEncoderRawData":
        """Compute in ``precision`` from now on (see `compute_dtype`); the
        parameters stay float32."""
        self.compute_dtype = compute_dtype(precision)
        return self

    def _autocast(self, x: torch.Tensor):
        if self.compute_dtype == torch.float32:
            return no_tf32()
        return torch.autocast(x.device.type, dtype=self.compute_dtype)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(mu, logvar)`` of ``(B, 1, H, W)`` patterns, each ``(B,
        latent_dim)`` float32."""
        with self._autocast(x):
            h = self.encoder(x).flatten(1)
            mu, logvar = self.mu(h), self.logvar(h)
        return mu.float(), logvar.float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Reconstruction logits ``(B, 1, H, W)`` of ``(B, latent_dim)``
        codes, in the compute dtype."""
        hw = self.bottleneck_hw
        with self._autocast(z):
            h = self.linear2(z).view(z.shape[0], 4 * self.inplanes, hw, hw)
            return self.decoder(h)

    @staticmethod
    def reparameterize(
        mu: torch.Tensor,
        logvar: torch.Tensor,
        generator: torch.Generator | None = None,
        eps: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``z = mu + std * eps`` with ``eps`` drawn from ``generator``
        unless the caller gives it (the seam that feeds another framework's
        noise in, for parity)."""
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
        return mu + torch.exp(logvar / 2.0) * eps

    def forward(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        eps: torch.Tensor | None = None,
    ) -> VAEOutput:
        mu, logvar = self.encode(x)
        std = torch.exp(logvar / 2.0)
        z = self.reparameterize(mu, logvar, generator, eps)
        return VAEOutput(z, self.decode(z), mu, std)
