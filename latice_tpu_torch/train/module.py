"""The VAE training module: the port of ``latice_tpu.train.module``.

Bundles the model, the loss and the optimizer and scheduler factories
behind the reference's constructor shape (latice/lightning_module.py:
159-198: ``model``, ``kl_lambda``, ``optimizer_partial``,
``lr_scheduler_partial``). The trainer asks it for a fresh optimizer over
the model's parameters at the start of every ``fit``.
"""

from __future__ import annotations

from typing import Callable

import torch

from latice_tpu_torch.train.loss import VAELoss
from latice_tpu_torch.train.schedule import ReduceLROnPlateau
from latice_tpu_torch.train.state import make_optimizer

__all__ = ["VAEModule", "default_optimizer_partial", "default_scheduler_partial"]


def default_optimizer_partial(params) -> torch.optim.Optimizer:
    """Adam(lr=1e-4, amsgrad) over ``params`` (lightning_module.py:26-28)."""
    return make_optimizer(params, learning_rate=1e-4, amsgrad=True)


def default_scheduler_partial() -> ReduceLROnPlateau:
    """ReduceLROnPlateau(factor=0.1, patience=10) (lightning_module.py:31-35)."""
    return ReduceLROnPlateau(factor=0.1, patience=10)


class VAEModule:
    """Training bundle for a VAE model.

    Args:
        model: the port's ``VariationalAutoEncoderRawData``.
        kl_lambda: KL weight (reference default config: 5e-6).
        optimizer_partial: a factory ``params -> Optimizer``, such as the
            config's ``functools.partial(make_optimizer, learning_rate=...,
            amsgrad=...)``; None for the default.
        lr_scheduler_partial: a zero-argument factory returning a
            ReduceLROnPlateau, an instance, or None to disable
            (lightning_module.py:361-369).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        kl_lambda: float = 0.1,
        optimizer_partial: Callable | None = None,
        lr_scheduler_partial: Callable | ReduceLROnPlateau | None = default_scheduler_partial,
    ) -> None:
        self.model = model
        self.loss_fn = VAELoss(kl_lambda=kl_lambda)
        self.optimizer_partial = optimizer_partial or default_optimizer_partial
        if lr_scheduler_partial is None:
            self.scheduler = None
        elif isinstance(lr_scheduler_partial, ReduceLROnPlateau):
            self.scheduler = lr_scheduler_partial
        else:
            self.scheduler = lr_scheduler_partial()

    def with_precision(self, precision: str | int) -> "VAEModule":
        """Set the model's compute precision and return this module.

        ``"16-mixed"`` / ``"bf16-mixed"`` select bfloat16 autocast with
        float32 parameters, the reference trainer's 16-mixed setting
        (conf/train.yaml); ``"32"`` is full float32. Unlike the JAX
        module, which returns a clone, the torch model is changed in place:
        its parameters are the ones training updates.
        """
        self.model.set_precision(precision)
        return self

    def configure_optimizer(self) -> torch.optim.Optimizer:
        """A fresh optimizer over the model's parameters."""
        return self.optimizer_partial(self.model.parameters())
