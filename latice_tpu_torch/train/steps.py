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

With ``mesh=`` (`parallel.make_mesh`) a step is data-parallel, the
counterpart of the JAX step on a batch sharded over a mesh: the noise (and
any augmentation) is drawn once for the global batch on the mesh's first
device, exactly as one device draws it, and sliced; each replica of the
model (`model_replicas`: the model itself on the first device, a copy on
every other) runs forward and backward on its rows with the loss
normalised by the global count of real rows; the gradients are summed into
the model's on the first device and one optimizer update is made. The
result is the one-device step on the same global batch, to float
roundoff. InstanceNorm is per sample, so no statistics cross devices.
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Callable

import numpy as np
import torch

from latice_tpu_torch.device import no_tf32
from latice_tpu_torch.train.loss import VAELoss
from latice_tpu_torch.utils.profiling import span

__all__ = ["make_train_step", "make_eval_step", "keyed_generator", "model_replicas"]

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


_METRIC_KEYS = ("loss", "kl_loss", "recon_loss")
# Per model, per mesh: its replicas (`model_replicas`).
_REPLICAS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _metrics(losses: dict[str, torch.Tensor]) -> Metrics:
    return {k: losses[k].detach() for k in _METRIC_KEYS}


def model_replicas(model: torch.nn.Module, mesh) -> list[torch.nn.Module]:
    """``model`` and one copy of it on every other device of ``mesh``
    (repeats included), with the copies' parameters and buffers set to the
    model's now. The model must lie on the mesh's first device. The copies
    are made once per (model, mesh) and refreshed on every call, so a step
    always starts from the model's current weights."""
    first = mesh.devices[0]
    if next(model.parameters()).device != first:
        raise ValueError(f"the model must lie on the mesh's first device {first}")
    per_mesh = _REPLICAS.setdefault(model, {})
    reps = per_mesh.get(mesh)
    if reps is None:
        reps = [model] + [copy.deepcopy(model).to(d) for d in mesh.devices[1:]]
        per_mesh[mesh] = reps
        return reps
    src = list(model.parameters()) + list(model.buffers())
    with torch.no_grad():
        for rep in reps[1:]:
            for dst, val in zip(list(rep.parameters()) + list(rep.buffers()), src):
                dst.copy_(val, non_blocking=True)
    return reps


def _global_draws(model, batch, mask, eps, gen_key, augment, aug_key, denoising, first):
    """The step's inputs for the global batch on ``first``, drawn as one
    device draws them: the model input and target (augmented from the
    ``aug_key`` stream), the noise (from ``gen_key`` unless given) and the
    row weights (ones without a mask)."""
    batch = batch.to(first)
    model_in, target = batch, batch
    if augment is not None:
        with span("train:augment"):
            aug_gen = keyed_generator(first, *aug_key)
            model_in = augment(aug_gen, batch.permute(0, 2, 3, 1))
            model_in = model_in.permute(0, 3, 1, 2).contiguous()
        if not denoising:
            target = model_in
    if eps is None:
        # The draw `reparameterize` makes for the whole batch on one device.
        eps = torch.randn(
            (batch.shape[0], model.latent_dim), generator=keyed_generator(first, *gen_key),
            dtype=torch.float32, device=first,
        )
    w = torch.ones(batch.shape[0], device=first) if mask is None else mask.to(first).float()
    return model_in, target, eps.to(first), w


def _replica_losses(loss_fn, reps, mesh, model_in, target, eps, w, want_recon=False):
    """Each replica's forward on its rows, its losses scaled to its share of
    the global masked mean (local mean x local real rows / global real
    rows), summed on the first device; with ``want_recon`` also the
    gathered reconstruction."""
    first = mesh.devices[0]
    n = mesh.size
    if model_in.shape[0] % n:
        raise ValueError(f"Batch size {model_in.shape[0]} not divisible by mesh size {n}")
    rows = model_in.shape[0] // n
    denom = torch.clamp(w.sum(), min=1.0)
    totals = dict.fromkeys(_METRIC_KEYS)
    recon = []
    for i, (rep, dev) in enumerate(zip(reps, mesh.devices)):
        sl = slice(i * rows, (i + 1) * rows)
        w_i = w[sl].to(dev)
        with span("train:forward"):
            z, x_hat, mu, std = rep(model_in[sl].to(dev), eps=eps[sl].to(dev))
        with span("train:loss"):
            losses = loss_fn(z, x_hat, mu, std, target[sl].to(dev), w_i)
            share = w_i.sum() / denom.to(dev)
        for k in _METRIC_KEYS:
            part = (losses[k] * share).to(first)
            totals[k] = part if totals[k] is None else totals[k] + part
        if want_recon:
            recon.append(x_hat.to(first))
    return totals, (torch.cat(recon) if want_recon else None)


def make_train_step(
    loss_fn: VAELoss,
    skip_nonfinite_updates: bool = False,
    augment: Callable | None = None,
    denoising: bool = False,
    seed: int = 0,
    mesh=None,
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

    With ``mesh`` the step is data-parallel over the mesh (module
    docstring): ``model`` lies on the mesh's first device, ``batch`` (its
    size divisible by the mesh size) may lie anywhere, and the metrics are
    those of the global batch.
    """
    if mesh is not None:
        return _make_dp_train_step(loss_fn, mesh, skip_nonfinite_updates, augment, denoising, seed)

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
            with span("train:augment"):
                aug_gen = keyed_generator(batch.device, seed, _AUGMENT_STREAM, step)
                # The augmentation works on NHWC, as in the JAX package; with
                # one channel the permuted view holds the same bytes.
                model_in = augment(aug_gen, batch.permute(0, 2, 3, 1))
                model_in = model_in.permute(0, 3, 1, 2).contiguous()
            if not denoising:
                target = model_in
        # The labels name the parts of a step in a torch.profiler trace;
        # backward's work is under the autograd engine's own events.
        with span("train:forward"):
            out = model(model_in, generator=gen, eps=eps)
        with span("train:loss"):
            losses = loss_fn(*out, target, mask)
        # An f32 model's forward keeps TF32 off (its _autocast); the conv
        # backward reads the flag again, so the f32 step keeps it off here too.
        f32 = getattr(model, "compute_dtype", None) == torch.float32
        with no_tf32() if f32 else contextlib.nullcontext():
            losses["loss"].backward()
        metrics = _metrics(losses)
        _update(model, optimizer, metrics, skip_nonfinite_updates)
        return metrics

    return train_step


def _update(model, optimizer, metrics: Metrics, skip_nonfinite_updates: bool) -> None:
    """The optimizer step; with ``skip_nonfinite_updates`` only where the
    loss and every gradient are finite (``metrics["skipped"]`` says)."""
    with span("train:optimizer"):
        if skip_nonfinite_updates:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            ok = bool(finite & torch.isfinite(metrics["loss"]))
            if ok:
                optimizer.step()
            metrics["skipped"] = torch.tensor(0.0 if ok else 1.0)
        else:
            optimizer.step()


def _make_dp_train_step(loss_fn, mesh, skip_nonfinite_updates, augment, denoising, seed):
    """`make_train_step` over a mesh (module docstring)."""

    def train_step(
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        batch: torch.Tensor,
        mask: torch.Tensor | None = None,
        step: int = 0,
        eps: torch.Tensor | None = None,
    ) -> Metrics:
        first = mesh.devices[0]
        reps = model_replicas(model, mesh)
        for rep in reps:
            rep.train()
            rep.zero_grad(set_to_none=True)
        optimizer.zero_grad(set_to_none=True)
        model_in, target, eps, w = _global_draws(
            model, batch, mask, eps, (seed, _TRAIN_STREAM, step), augment,
            (seed, _AUGMENT_STREAM, step), denoising, first,
        )
        totals, _ = _replica_losses(loss_fn, reps, mesh, model_in, target, eps, w)
        f32 = getattr(model, "compute_dtype", None) == torch.float32
        with no_tf32() if f32 else contextlib.nullcontext():
            # One backward over every replica's graph: the engine runs each
            # device's part on that device's own thread.
            totals["loss"].backward()
        with span("train:allreduce"), torch.no_grad():
            for params in zip(*(rep.parameters() for rep in reps)):
                grads = [p.grad for p in params[1:] if p.grad is not None]
                if not grads:
                    continue
                total = params[0].grad
                for g in grads:
                    g = g.to(first, non_blocking=True)
                    total = g.clone() if total is None else total.add_(g)
                params[0].grad = total
        metrics = {k: v.detach() for k, v in totals.items()}
        _update(model, optimizer, metrics, skip_nonfinite_updates)
        return metrics

    return train_step


def make_eval_step(
    loss_fn: VAELoss, return_recon: bool = False, seed: int = 0, mesh=None
) -> Callable[..., Metrics | tuple[Metrics, torch.Tensor]]:
    """Build the validation step.

    Maps ``(model, batch, mask=None, key=0, eps=None) -> metrics``, plus
    ``x_hat`` when ``return_recon`` (the reconstruction-figure input).
    ``key`` seeds the noise with ``seed``; the trainer passes one per
    (epoch, batch). Runs without autograd. With ``mesh`` the batch splits
    over the model's replicas as in the train step, the noise drawn once
    on the first device.
    """
    if mesh is not None:

        @torch.no_grad()
        def dp_eval_step(model, batch, mask=None, key=0, eps=None):
            first = mesh.devices[0]
            reps = model_replicas(model, mesh)
            for rep in reps:
                rep.eval()
            model_in, target, eps, w = _global_draws(
                model, batch, mask, eps, (seed, _EVAL_STREAM, key), None, None, False, first
            )
            totals, x_hat = _replica_losses(
                loss_fn, reps, mesh, model_in, target, eps, w, want_recon=return_recon
            )
            metrics = {k: v.detach() for k, v in totals.items()}
            return (metrics, x_hat) if return_recon else metrics

        return dp_eval_step

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
