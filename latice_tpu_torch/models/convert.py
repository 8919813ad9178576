"""Carry VAE weights into the port: from a JAX ``params`` tree or a ``.pt``.

`flax_params_to_state_dict` is the inverse of
``latice_tpu.models.torch_import.torch_state_dict_to_flax``, generalized to
any ``n_stages`` and ``bottleneck_hw``. It takes the tree as plain numpy
arrays (convert a JAX tree with ``jax.tree.map(np.asarray, params)``), so
this module needs no JAX:

* conv kernels: flax HWIO -> torch OIHW;
* transposed-conv kernels: flax HWIO -> torch ``(in, out, kh, kw)`` with the
  spatial flip undone (flax correlates where torch convolves);
* dense kernels: flax ``(in, out)`` -> torch ``(out, in)``;
* the bottleneck flatten: flax flattens H, W, C and torch C, H, W, so the
  ``mu``/``logvar`` input rows and the ``linear2`` output columns and bias
  are permuted back.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from latice_tpu_torch.device import resolve_device
from latice_tpu_torch.models.vae import VariationalAutoEncoderRawData

__all__ = ["flax_params_to_state_dict", "load_checkpoint"]


def _conv(p: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    """flax Conv {kernel: HWIO, bias} -> torch Conv2d (OIHW, bias)."""
    return np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)), np.asarray(p["bias"])


def _conv_transpose(p: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    """flax ConvTranspose HWIO -> torch ConvTranspose2d (in, out, kh, kw)."""
    k = np.asarray(p["kernel"])[::-1, ::-1, :, :]
    return np.transpose(k, (2, 3, 0, 1)), np.asarray(p["bias"])


def _dense(p: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    """flax Dense {kernel: (in, out), bias} -> torch Linear (out, in)."""
    return np.transpose(np.asarray(p["kernel"])), np.asarray(p["bias"])


def _bottleneck_perm(channels: int, hw: int) -> np.ndarray:
    """perm[flax HWC-flatten position] = torch CHW-flatten index."""
    idx = np.arange(channels * hw * hw).reshape(channels, hw, hw)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


def flax_params_to_state_dict(
    params: Mapping[str, Any],
    inplanes: int = 32,
    latent_dim: int = 16,
    n_stages: int = 5,
    bottleneck_hw: int = 4,
) -> dict[str, torch.Tensor]:
    """The port's reference-layout state dict of a JAX VAE ``params`` tree.

    ``latent_dim`` is checked against the heads' width.
    """
    out: dict[str, np.ndarray] = {}

    def put(prefix: str, wb: tuple[np.ndarray, np.ndarray]) -> None:
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = wb

    enc = params["encoder"]
    for s in range(n_stages):
        for b in range(2):
            put(f"encoder.{3 * s + b}.0", _conv(enc[f"stage{s}_block{b}"]["conv"]))

    dec = params["decoder"]
    for s in range(n_stages - 1):
        for b in range(2):
            put(f"decoder.{3 * s + 1 + b}.0", _conv_transpose(dec[f"stage{s}_block{b}"]["conv"]))
    last = 3 * (n_stages - 1)
    put(f"decoder.{last + 1}.0", _conv_transpose(dec[f"stage{n_stages - 1}_block0"]["conv"]))
    put(f"decoder.{last + 2}", _conv(dec["logit_conv"]))

    perm = _bottleneck_perm(4 * inplanes, bottleneck_hw)
    for head in ("mu", "logvar"):
        w, b = _dense(params[head])
        if w.shape[0] != latent_dim:
            raise ValueError(f"{head} has width {w.shape[0]}, expected latent_dim={latent_dim}")
        w_t = np.empty_like(w)
        w_t[:, perm] = w
        put(f"{head}.0", (w_t, b))
    w, b = _dense(params["linear2"])
    w_t, b_t = np.empty_like(w), np.empty_like(b)
    w_t[perm, :] = w
    b_t[perm] = b
    put("linear2.0", (w_t, b_t))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def load_checkpoint(
    path: str,
    inplanes: int = 32,
    latent_dim: int = 16,
    n_stages: int = 5,
    bottleneck_hw: int = 4,
    device: str | torch.device | None = None,
) -> VariationalAutoEncoderRawData:
    """The port's VAE with the weights of a reference-layout ``.pt``, on
    ``device``: ``cuda`` unless the caller asks for another.

    Accepts a bare state dict (the trainer's ``last.pt`` and
    ``epoch_<N>.pt``) or a Lightning checkpoint (``state_dict`` key,
    ``model.`` prefixes stripped).
    """
    device = resolve_device(device)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    if sd and all(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()}
    model = VariationalAutoEncoderRawData(inplanes, latent_dim, n_stages, bottleneck_hw)
    model.load_state_dict(sd)
    return model.to(device).eval()
