"""VAE loss: the port of ``latice_tpu.train.loss`` on torch tensors.

The reference semantics (latice/lightning_module.py:38-156), as the JAX
module keeps them:

* reconstruction = per-sample mean of element-wise BCE-with-logits;
* KL = single-sample Monte-Carlo estimate ``E[log q(z|x) - log p(z)]`` with
  a **mean** (not sum) over the latent dimension;
* total ELBO = ``kl * kl_lambda + recon`` per sample, reported as batch
  means under the reference's metric names.

The reconstruction and the target are taken to float32 first, as the JAX
module does, so a bfloat16 reconstruction from a mixed-precision forward
is scored in f32 (``z``, ``mu`` and ``std`` are float32 already).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "binary_cross_entropy_with_logits",
    "monte_carlo_kl",
    "gaussian_likelihood",
    "VAELoss",
]

_LOG_2PI = math.log(2.0 * math.pi)


def binary_cross_entropy_with_logits(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-sample BCE-with-logits, mean over all non-batch axes.

    The stable form ``max(l, 0) - l*x + log1p(exp(-|l|))`` of
    ``BCEWithLogitsLoss(reduction="none")`` then ``.mean(dim=(1, 2, 3))``.
    """
    l = x_hat.float()
    x = x.float()
    per_elem = torch.clamp(l, min=0.0) - l * x + torch.log1p(torch.exp(-torch.abs(l)))
    return per_elem.mean(dim=tuple(range(1, per_elem.dim())))


def _normal_log_prob(value: torch.Tensor, mu: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """log N(value; mu, std), elementwise (torch.distributions.Normal.log_prob)."""
    var = std * std
    return -((value - mu) ** 2) / (2.0 * var) - torch.log(std) - 0.5 * _LOG_2PI


def monte_carlo_kl(z: torch.Tensor, mu: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Single-sample MC estimate of KL(q(z|x) || N(0, I)), per sample.

    ``(log q(z|x) - log p(z)).mean(-1)``: a mean, not a sum, over the
    latent dimension, the reference's quirk (lightning_module.py:119).
    """
    log_qzx = _normal_log_prob(z, mu, std)
    log_pz = _normal_log_prob(z, torch.zeros_like(mu), torch.ones_like(std))
    return (log_qzx - log_pz).mean(dim=-1)


def gaussian_likelihood(
    x_hat: torch.Tensor, log_scale: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Per-sample Gaussian log-likelihood with the reference's normalization
    (lightning_module.py:53-77), including the added ``log(sqrt(2*pi) *
    scale)`` term. The training loss does not use it, as upstream."""
    scale = torch.exp(log_scale)
    log_pxz = _normal_log_prob(x, x_hat, scale)
    log_pxz = log_pxz + torch.log(math.sqrt(2.0 * math.pi) * scale)
    return log_pxz.mean(dim=tuple(range(1, log_pxz.dim())))


@dataclasses.dataclass(frozen=True)
class VAELoss:
    """ELBO loss with weighted MC-KL (reference default kl_lambda=5e-6,
    conf/lightning_module/default.yaml)."""

    kl_lambda: float = 0.1

    def compute_loss(
        self,
        z: torch.Tensor,
        x_hat: torch.Tensor,
        mu: torch.Tensor,
        std: torch.Tensor,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
    ) -> dict[str, torch.Tensor]:
        """All VAE losses, keyed ``loss``, ``kl_loss``, ``recon_loss`` and
        ``elbo`` (per sample).

        ``mask`` is an optional ``(B,)`` 0/1 weight per sample: rows padded
        to the static batch carry weight 0, so the reported means and the
        gradients through ``loss`` are those of the unpadded batch. With
        ``mask=None`` the plain batch means apply.
        """
        recon_loss = binary_cross_entropy_with_logits(x_hat, x)
        kl = monte_carlo_kl(z, mu, std) * self.kl_lambda
        elbo = kl + recon_loss
        if mask is None:
            mean = torch.mean
        else:
            w = mask.float()
            denom = torch.clamp(w.sum(), min=1.0)

            def mean(v):
                return (v * w).sum() / denom

        return {
            "loss": mean(elbo),
            "kl_loss": mean(kl),
            "recon_loss": mean(recon_loss),
            "elbo": elbo,
        }

    def __call__(self, z, x_hat, mu, std, x, mask=None) -> dict[str, torch.Tensor]:
        return self.compute_loss(z, x_hat, mu, std, x, mask)
