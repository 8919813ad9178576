"""The convolutional VAE of poyentung/ebsd-vae in plain PyTorch, float32.

Written from the architecture (latice/model.py:83-150 upstream), not from
the port:

* encoder: ``n_stages`` stages of two [Conv3x3 -> InstanceNorm(eps 1e-5,
  no affine) -> LeakyReLU(0.02)] blocks and a 2x2 max-pool, widths P, 2P,
  then 4P;
* heads: Linear from the CHW-flattened bottleneck to ``latent_dim`` for mu
  and logvar;
* decoder: Linear back to the bottleneck, then per stage a nearest 2x
  upsample and two ConvTranspose3x3 blocks; the last stage is the upsample,
  one block and a Conv3x3 to one logit channel;
* loss: per-sample mean BCE-with-logits plus ``kl_lambda`` times the
  single-sample Monte-Carlo KL, averaged (not summed) over the latent axis;
  the batch mean of the sum;
* AMSGrad as optax computes it (b1 0.9, b2 0.999, eps 1e-8; the running
  maximum of the bias-corrected second moment).

Parameters are named as in the upstream state dict (``encoder.{3s+b}.0``,
``mu.0``, ``logvar.0``, ``linear2.0``, ``decoder.{i}.0``). Every
convolution and product runs with TF32 off (`full_f32`). ``cast`` rounds
each operand and each result of every convolution and product (the
lower-precision control, `fp8`, as the port's bf16 autocast rounds its
operands and results); it is the identity otherwise.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = [
    "amsgrad",
    "decode",
    "encode",
    "forward_loss",
    "fp8",
    "full_f32",
    "param_layout",
]

EPS = 1e-5
SLOPE = 0.02


def _widths(p: int, n_stages: int) -> list[int]:
    return [p, 2 * p] + [4 * p] * (n_stages - 2)


def _decoder_stages(p: int, n_stages: int) -> list[tuple[int, int]]:
    return [(4 * p, 4 * p)] * (n_stages - 3) + [(4 * p, 2 * p), (2 * p, p)]


def param_layout(cfg: dict) -> list[tuple[str, tuple[int, ...], int]]:
    """``(name, shape, fan_in)`` of every parameter, in draw order."""
    p, latent, n, hw = cfg["inplanes"], cfg["latent_dim"], cfg["n_stages"], cfg["bottleneck_hw"]
    out: list[tuple[str, tuple[int, ...], int]] = []
    c = 1
    for s, width in enumerate(_widths(p, n)):
        for b in range(2):
            out.append((f"encoder.{3 * s + b}.0.weight", (width, c, 3, 3), c * 9))
            out.append((f"encoder.{3 * s + b}.0.bias", (width,), c * 9))
            c = width
    flat = 4 * p * hw * hw
    for head in ("mu", "logvar"):
        out.append((f"{head}.0.weight", (latent, flat), flat))
        out.append((f"{head}.0.bias", (latent,), flat))
    out.append(("linear2.0.weight", (flat, latent), latent))
    out.append(("linear2.0.bias", (flat,), latent))
    c = 4 * p
    i = 0
    for c1, c2 in _decoder_stages(p, n):
        for slot, (ci, co) in ((1, (c, c1)), (2, (c1, c2))):
            out.append((f"decoder.{i + slot}.0.weight", (ci, co, 3, 3), ci * 9))
            out.append((f"decoder.{i + slot}.0.bias", (co,), ci * 9))
        c = c2
        i += 3
    out.append((f"decoder.{i + 1}.0.weight", (c, p, 3, 3), c * 9))
    out.append((f"decoder.{i + 1}.0.bias", (p,), c * 9))
    out.append((f"decoder.{i + 2}.weight", (1, p, 3, 3), p * 9))
    out.append((f"decoder.{i + 2}.bias", (1,), p * 9))
    return out


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (saturated at ±448) and back to f32."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def full_f32():
    """cuDNN and cuBLAS in full float32 inside the block (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _norm_act(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return F.leaky_relu((x - mean) / torch.sqrt(var + EPS), SLOPE)


def encode(params: dict, cfg: dict, x: torch.Tensor, cast=_same):
    """``(mu, logvar)`` of ``(B, 1, H, W)`` float32 patterns in [0, 1]."""
    h = x
    for s in range(cfg["n_stages"]):
        for b in range(2):
            k = f"encoder.{3 * s + b}.0"
            h = _norm_act(cast(F.conv2d(cast(h), cast(params[k + ".weight"]), params[k + ".bias"],
                                        padding=1)))
        h = F.max_pool2d(h, 2)
    h = cast(h.flatten(1))
    mu = cast(F.linear(h, cast(params["mu.0.weight"]), params["mu.0.bias"]))
    logvar = cast(F.linear(h, cast(params["logvar.0.weight"]), params["logvar.0.bias"]))
    return mu, logvar


def decode(params: dict, cfg: dict, z: torch.Tensor, cast=_same) -> torch.Tensor:
    p, hw = cfg["inplanes"], cfg["bottleneck_hw"]
    h = cast(F.linear(cast(z), cast(params["linear2.0.weight"]), params["linear2.0.bias"]))
    h = h.view(z.shape[0], 4 * p, hw, hw)
    i = 0
    for _ in _decoder_stages(p, cfg["n_stages"]):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        for slot in (1, 2):
            k = f"decoder.{i + slot}.0"
            h = _norm_act(cast(F.conv_transpose2d(cast(h), cast(params[k + ".weight"]),
                                                  params[k + ".bias"], padding=1)))
        i += 3
    h = F.interpolate(h, scale_factor=2, mode="nearest")
    k = f"decoder.{i + 1}.0"
    h = _norm_act(cast(F.conv_transpose2d(cast(h), cast(params[k + ".weight"]), params[k + ".bias"],
                                          padding=1)))
    k = f"decoder.{i + 2}"
    return cast(F.conv2d(cast(h), cast(params[k + ".weight"]), params[k + ".bias"], padding=1))


def forward_loss(params: dict, cfg: dict, x: torch.Tensor, eps: torch.Tensor, cast=_same):
    """The batch's ELBO loss (``kl_lambda`` from ``cfg``) of ``(B, 1, H, W)``
    patterns with reparameterization noise ``eps``."""
    mu, logvar = encode(params, cfg, x, cast)
    std = torch.exp(logvar / 2.0)
    z = mu + std * eps
    logits = decode(params, cfg, z, cast)
    bce = (logits.clamp(min=0) - logits * x + torch.log1p(torch.exp(-logits.abs()))).mean((1, 2, 3))
    log_2pi = math.log(2.0 * math.pi)
    log_q = -((z - mu) ** 2) / (2.0 * std * std) - torch.log(std) - 0.5 * log_2pi
    log_p = -(z**2) / 2.0 - 0.5 * log_2pi
    kl = (log_q - log_p).mean(-1)
    return (bce + cfg["kl_lambda"] * kl).mean()


def amsgrad(params: dict, grads: dict, state: dict, lr: float) -> None:
    """One AMSGrad step, optax's rule, in place on ``params`` and ``state``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = state.setdefault("count", 0) + 1
    state["count"] = t
    for name, g in grads.items():
        s = state.setdefault(name, {})
        mu = s.get("mu", torch.zeros_like(g)) * b1 + (1 - b1) * g
        nu = s.get("nu", torch.zeros_like(g)) * b2 + (1 - b2) * g * g
        nu_max = torch.maximum(s.get("nu_max", torch.zeros_like(g)), nu / (1 - b2**t))
        s.update(mu=mu, nu=nu, nu_max=nu_max)
        params[name] = params[name] - lr * (mu / (1 - b1**t)) / (torch.sqrt(nu_max) + eps)
