"""Train and eval steps: the port of ``latice_tpu.train.steps``.

The JAX package compiles each step into one XLA program. Here a step is an
eager PyTorch function: forward (the fused InstanceNorm + LeakyReLU kernels
on the card), loss, ``backward()`` (the fused backward kernel) and the
optimizer update.

Noise is keyed, not streamed: the reparameterization noise of train step
``s`` comes from a ``torch.Generator`` on the batch's device seeded from
``(seed, s)``, the counterpart of ``fold_in(rng, step)`` in the JAX step.
A resumed run therefore replays the noise of an uninterrupted one. Eval
noise is keyed by an integer the caller derives per (epoch, batch). The
augmentation's draws (`data.augment`) come from a stream of their own keyed
by ``(seed, s)`` too, as the JAX step splits an augmentation key off the
step's key.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from latice_tpu_torch.device import no_tf32
from latice_tpu_torch.train.loss import VAELoss

__all__ = ["make_train_step", "make_eval_step", "keyed_generator"]

Metrics = dict[str, torch.Tensor]

_TRAIN_STREAM = 1
_EVAL_STREAM = 2
_AUGMENT_STREAM = 3


def keyed_generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer tuple ``key``,
    through numpy's ``SeedSequence``: the same key gives the same stream on
    every run and machine, and distinct keys give independent streams."""
    words = np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
    seed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=device).manual_seed(seed)


def _metrics(losses: dict[str, torch.Tensor]) -> Metrics:
    return {k: losses[k].detach() for k in ("loss", "kl_loss", "recon_loss")}


def make_train_step(
    loss_fn: VAELoss,
    skip_nonfinite_updates: bool = False,
    augment: Callable | None = None,
    denoising: bool = False,
    seed: int = 0,
) -> Callable[..., Metrics]:
    """Build the training step.

    The returned function maps ``(model, optimizer, batch, mask=None,
    step=0, eps=None) -> metrics``: ``batch`` is ``(B, 1, H, W)`` patterns
    on the model's device and ``mask`` an optional ``(B,)`` 0/1 row weight,
    so rows padded to the static batch add zero loss and zero gradient. It
    updates the model's parameters and the optimizer's state in place.
    ``eps`` replaces the keyed noise ``(B, latent_dim)`` when given.

    Metric keys are ``loss``, ``kl_loss`` and ``recon_loss`` (0-d tensors).
    With ``skip_nonfinite_updates``, a step whose loss or gradients are not
    finite leaves the parameters and the optimizer state untouched and
    reports ``skipped`` = 1.

    ``augment`` is an optional ``(generator, batch) -> batch`` perturbation
    over NHWC batches (`data.augment.make_augment_fn`), applied to each
    step's batch with draws keyed from ``(seed, step)``, so augmented runs
    replay exactly. With ``denoising`` the model reconstructs the original
    batch from the augmented input (the denoising-VAE objective); without
    it, the augmented input. ``denoising`` without ``augment`` changes
    nothing, as in the JAX step.
    """

    def train_step(
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        batch: torch.Tensor,
        mask: torch.Tensor | None = None,
        step: int = 0,
        eps: torch.Tensor | None = None,
    ) -> Metrics:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        gen = None if eps is not None else keyed_generator(batch.device, seed, _TRAIN_STREAM, step)
        model_in, target = batch, batch
        if augment is not None:
            with record_function("train:augment"):
                aug_gen = keyed_generator(batch.device, seed, _AUGMENT_STREAM, step)
                # The augmentation works on NHWC, as in the JAX package; with
                # one channel the permuted view holds the same bytes.
                model_in = augment(aug_gen, batch.permute(0, 2, 3, 1))
                model_in = model_in.permute(0, 3, 1, 2).contiguous()
            if not denoising:
                target = model_in
        # The labels name the parts of a step in a torch.profiler trace;
        # backward's work is under the autograd engine's own events.
        with record_function("train:forward"):
            out = model(model_in, generator=gen, eps=eps)
        with record_function("train:loss"):
            losses = loss_fn(*out, target, mask)
        # An f32 model's forward keeps TF32 off (its _autocast); the conv
        # backward reads the flag again, so the f32 step keeps it off here too.
        f32 = getattr(model, "compute_dtype", None) == torch.float32
        with no_tf32() if f32 else contextlib.nullcontext():
            losses["loss"].backward()
        metrics = _metrics(losses)
        with record_function("train:optimizer"):
            if skip_nonfinite_updates:
                grads = [p.grad for p in model.parameters() if p.grad is not None]
                finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
                ok = bool(finite & torch.isfinite(losses["loss"]))
                if ok:
                    optimizer.step()
                metrics["skipped"] = torch.tensor(0.0 if ok else 1.0)
            else:
                optimizer.step()
        return metrics

    return train_step


def make_eval_step(
    loss_fn: VAELoss, return_recon: bool = False, seed: int = 0
) -> Callable[..., Metrics | tuple[Metrics, torch.Tensor]]:
    """Build the validation step.

    Maps ``(model, batch, mask=None, key=0, eps=None) -> metrics``, plus
    ``x_hat`` when ``return_recon`` (the reconstruction-figure input).
    ``key`` seeds the noise with ``seed``; the trainer passes one per
    (epoch, batch). Runs without autograd.
    """

    @torch.no_grad()
    def eval_step(
        model: torch.nn.Module,
        batch: torch.Tensor,
        mask: torch.Tensor | None = None,
        key: int = 0,
        eps: torch.Tensor | None = None,
    ):
        model.eval()
        gen = None if eps is not None else keyed_generator(batch.device, seed, _EVAL_STREAM, key)
        z, x_hat, mu, std = model(batch, generator=gen, eps=eps)
        metrics = _metrics(loss_fn(z, x_hat, mu, std, batch, mask))
        if return_recon:
            return metrics, x_hat
        return metrics

    return eval_step
