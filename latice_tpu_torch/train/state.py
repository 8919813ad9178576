"""The optimizer: Adam and AMSGrad with optax's update rule.

The JAX package trains with ``optax.amsgrad`` (``optax.adam`` when
``amsgrad=False``) behind ``optax.inject_hyperparams``, so the plateau
schedule can change the learning rate between steps. `OptaxAdam` is a
``torch.optim.Optimizer`` that computes the same update, per parameter:

    mu = b1 * mu + (1 - b1) * g,   nu = b2 * nu + (1 - b2) * g²,
    mu_hat = mu / (1 - b1^t),      nu_hat = nu / (1 - b2^t),
    AMSGrad: nu_max = max(nu_max, nu_hat), Adam: nu_max = nu_hat,
    p -= lr * mu_hat / (sqrt(nu_max) + eps),

with optax's defaults b1 0.9, b2 0.999, eps 1e-8 (and eps_root 0).

It is not ``torch.optim.Adam(amsgrad=True)``: torch keeps the running
maximum of the raw second moment and divides by its bias correction
afterwards, which differs from optax whenever the second moment shrinks.
Every scalar of the update (``1 - b1``, ``1 - b2``, the bias corrections)
is computed in float32 from float32 hyperparameters, as optax computes them
when ``inject_hyperparams`` holds the hyperparameters as float32 arrays.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

__all__ = ["OptaxAdam", "make_optimizer", "get_learning_rate", "set_learning_rate"]

_B1 = np.float32(0.9)
_B2 = np.float32(0.999)
_EPS = 1e-8


class OptaxAdam(torch.optim.Optimizer):
    """optax's ``adam``/``amsgrad`` as a torch optimizer.

    State per parameter: ``count`` (steps taken), ``mu``, ``nu`` and, with
    AMSGrad, ``nu_max``; ``state_dict()`` carries them all, so a run
    resumes with its moments intact.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        lr: float = 1e-4,
        amsgrad: bool = True,
    ) -> None:
        super().__init__(params, dict(lr=lr, amsgrad=amsgrad))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    if group["amsgrad"]:
                        state["nu_max"] = torch.zeros_like(
                            p, memory_format=torch.preserve_format
                        )
                state["count"] += 1
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            count = self.state[params[0]]["count"]
            torch._foreach_mul_(mus, float(_B1))
            torch._foreach_add_(mus, torch._foreach_mul(grads, _f32(np.float32(1) - _B1)))
            torch._foreach_mul_(nus, float(_B2))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_add_(nus, torch._foreach_mul(g2, _f32(np.float32(1) - _B2)))
            mu_hat = torch._foreach_div(mus, _f32(np.float32(1) - _B1 ** np.float32(count)))
            nu_hat = torch._foreach_div(nus, _f32(np.float32(1) - _B2 ** np.float32(count)))
            if group["amsgrad"]:
                nu_max = [self.state[p]["nu_max"] for p in params]
                torch._foreach_maximum_(nu_max, nu_hat)
                nu_hat = nu_max
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, _EPS)
            updates = torch._foreach_div(mu_hat, denom)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)
        return loss


def _f32(v: np.float32) -> float:
    """A float32 scalar as the Python float of exactly its value, which
    torch's float32 ops take without rounding again."""
    return float(np.float32(v))


def make_optimizer(
    params: Iterable[torch.Tensor], learning_rate: float = 1e-4, amsgrad: bool = True
) -> OptaxAdam:
    """Adam with optional AMSGrad over ``params``; defaults mirror the
    reference's ``get_default_optimiser`` (lightning_module.py:26-28):
    lr 1e-4, no weight decay, AMSGrad. The config's ``optimizer_partial``
    binds the keyword arguments; the training module passes ``params``."""
    return OptaxAdam(params, lr=learning_rate, amsgrad=amsgrad)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The optimizer's learning rate (its first group's)."""
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, learning_rate: float) -> torch.optim.Optimizer:
    """Set every group's learning rate in place; returns the optimizer."""
    for group in optimizer.param_groups:
        group["lr"] = float(learning_rate)
    return optimizer
