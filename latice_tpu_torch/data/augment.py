"""Training augmentation on the device: photometric and translation jitter
applied inside the train step.

The port of ``latice_tpu.data.augment``. The reference trains on patterns
exactly as loaded, so its encoder inherits every detector artifact of the
training set. `make_augment_fn` turns an `AugmentConfig` into a
``(generator, batch) -> batch`` function that `train.make_train_step`
applies to each batch (per-step draws keyed from the step counter),
optionally in *denoising* mode, where the model reconstructs the clean
batch from the augmented input.

Deliberately absent, as in the JAX package: flips and rotations. A
diffraction pattern's orientation is its label, so a flipped or rotated
pattern belongs to another crystal orientation. Small translations are kept
(beam and detector alignment drift, a few pixels on real rigs).

The draws (`draw_augment`) are kept apart from their application
(`apply_augment`), so the application can be fed another generator's
draws: the tests feed it ``jax.random``'s and hold it to the JAX function.
Batches are NHWC, the JAX package's layout. The integer shift with edge
padding is an exact clamped-index gather (the JAX package computes the same
values as one-hot products, a form chosen for the TPU's matrix unit).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

__all__ = ["AugmentConfig", "AugmentDraws", "apply_augment", "draw_augment", "make_augment_fn"]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Declarative augmentation recipe for `make_augment_fn`.

    All stages are optional and applied in order: translation → intensity
    scale → offset → gamma → noise. Ranges are per-sample uniform draws.

    Attributes:
        noise_std: additive Gaussian noise, in input-intensity units.
        intensity_range: multiplicative scale ``(lo, hi)``, e.g. (0.9, 1.1)
            — detector gain / exposure jitter.
        offset_range: additive offset ``(lo, hi)`` — dark-level drift.
        gamma_range: per-sample ``x ** gamma`` with gamma in ``(lo, hi)``
            (inputs clipped at 0) — phosphor/camera response jitter.
        shift_px: maximum |translation| per axis in pixels, edge-padded —
            beam/detector alignment drift. Integer shifts, no resampling.
    """

    noise_std: float | None = None
    intensity_range: tuple[float, float] | None = None
    offset_range: tuple[float, float] | None = None
    gamma_range: tuple[float, float] | None = None
    shift_px: int | None = None


class AugmentDraws(NamedTuple):
    """One batch's random draws; a field is None when its stage is off.

    ``shift``: ``(B, 2)`` integer offsets in ``[0, 2 * shift_px]`` (row,
    column) into the edge-padded image; ``scale``, ``offset``, ``gamma``:
    ``(B,)``; ``noise``: standard normal of the batch's shape."""

    shift: torch.Tensor | None = None
    scale: torch.Tensor | None = None
    offset: torch.Tensor | None = None
    gamma: torch.Tensor | None = None
    noise: torch.Tensor | None = None


def _validate(cfg: AugmentConfig) -> None:
    for name in ("intensity_range", "offset_range", "gamma_range"):
        rng_ = getattr(cfg, name)
        if rng_ is not None and not (len(rng_) == 2 and rng_[0] <= rng_[1]):
            raise ValueError(f"{name} must be (lo, hi) with lo <= hi, got {rng_}")
    if cfg.gamma_range is not None and cfg.gamma_range[0] <= 0:
        # gamma <= 0 degenerates: 0**0 == 1 maps whole patterns to constant
        # and negative exponents blow up at the zeros maximum() creates.
        raise ValueError(f"gamma_range must be positive, got {cfg.gamma_range}")
    if cfg.shift_px is not None and cfg.shift_px < 0:
        raise ValueError("shift_px must be >= 0")


def draw_augment(cfg: AugmentConfig, generator: torch.Generator, x: torch.Tensor) -> AugmentDraws:
    """The draws of every enabled stage for batch ``x``, from ``generator``
    (on ``x``'s device), in stage order."""
    b = x.shape[0]
    kw = dict(generator=generator, device=x.device)

    def uniform(rng_):
        lo, hi = rng_
        return torch.rand(b, dtype=torch.float32, **kw) * (hi - lo) + lo

    return AugmentDraws(
        shift=(torch.randint(0, 2 * cfg.shift_px + 1, (b, 2), **kw) if cfg.shift_px else None),
        scale=uniform(cfg.intensity_range) if cfg.intensity_range is not None else None,
        offset=uniform(cfg.offset_range) if cfg.offset_range is not None else None,
        gamma=uniform(cfg.gamma_range) if cfg.gamma_range is not None else None,
        noise=torch.randn(x.shape, dtype=x.dtype, **kw) if cfg.noise_std else None,
    )


def apply_augment(cfg: AugmentConfig, x: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """Apply ``draws`` to the NHWC batch ``x`` in the JAX package's order:
    shift, scale, offset, gamma on ``max(x, 0)``, noise."""
    b = x.shape[0]

    def per(v):
        return v.to(x.dtype).reshape((b,) + (1,) * (x.ndim - 1))

    if cfg.shift_px:
        # Edge padding by s then a crop at the drawn offset: output pixel
        # (i, j) reads input (clamp(i + o_r - s), clamp(j + o_c - s)).
        s = cfg.shift_px
        h, w = x.shape[1], x.shape[2]
        off = draws.shift.to(x.device)
        rows = (torch.arange(h, device=x.device)[None, :] + off[:, :1] - s).clamp(0, h - 1)
        cols = (torch.arange(w, device=x.device)[None, :] + off[:, 1:] - s).clamp(0, w - 1)
        bi = torch.arange(b, device=x.device)[:, None, None]
        x = x[bi, rows[:, :, None], cols[:, None, :]]
    if cfg.intensity_range is not None:
        x = x * per(draws.scale)
    if cfg.offset_range is not None:
        x = x + per(draws.offset)
    if cfg.gamma_range is not None:
        x = torch.clamp(x, min=0.0) ** per(draws.gamma)
    if cfg.noise_std:
        x = x + cfg.noise_std * draws.noise.to(x.dtype)
    return x


def make_augment_fn(
    config: AugmentConfig,
) -> Callable[[torch.Generator, torch.Tensor], torch.Tensor]:
    """Compose an `AugmentConfig` into one ``(generator, batch) -> batch``
    function over NHWC batches, for ``make_train_step(augment=...)`` and
    ``Trainer(augment=...)``. Invalid ranges raise here, with the JAX
    package's messages."""
    cfg = config
    _validate(cfg)

    def augment(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        return apply_augment(cfg, x, draw_augment(cfg, generator, x))

    return augment
