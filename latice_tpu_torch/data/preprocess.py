"""Pattern preprocessing on the device: hot pixels, background, contrast.

The port of ``latice_tpu.data.preprocess``. Every op is a function of a
whole ``(..., H, W)`` or ``(..., H, W, C)`` float stack (a trailing axis of
at most 4 is channels, as in the JAX package), so a `PreprocessConfig`
composes into one function that `index.IndexPipeline(preprocess=...)` runs
between the uint8 ``/255`` and the encoder.

* The Gaussian blurs are two band-matrix products in f32 (PyTorch keeps f32
  matmuls out of TF32 unless ``torch.backends.cuda.matmul.allow_tf32`` is
  set; a cuDNN convolution would use TF32 by default).
* Medians over a pattern average the two middle values of an even count,
  as ``jnp.median`` does (``torch.median`` returns the lower one, and
  ``torch.quantile`` refuses more than 2**24 elements), from one sort.
* Histogram equalization is the rank/CDF transform: one stable argsort, a
  reverse ``cummin`` over the tie-run ends, and a scatter back, so equal
  intensities map to equal values.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

__all__ = [
    "PreprocessConfig",
    "bin_patterns",
    "equalize_histogram",
    "estimate_static_background",
    "fix_hot_pixels",
    "gaussian_blur",
    "make_preprocess_fn",
    "normalize_patterns",
    "parse_preprocess_spec",
    "remove_dynamic_background",
    "remove_static_background",
]

_EPS = 1e-8


def _with_channel(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``x`` as ``(..., H, W, C)``, and whether a channel axis was added.

    A trailing axis of at most 4 is channels; a wider one is a pattern
    axis, which tells ``(N, H, W)`` stacks from ``(H, W, C)`` images.
    """
    if x.ndim >= 3 and x.shape[-1] <= 4:
        return x, False
    return x[..., None], True


def _flat_patterns(x: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, C)`` as ``(..., H*W*C)``."""
    return x.reshape(x.shape[:-3] + (-1,))


def _per_pattern_median(x: torch.Tensor) -> torch.Tensor:
    """Median over each pattern's (H, W, C) values, kept as ``(..., 1, 1, 1)``;
    an even count averages its two middle values."""
    s = torch.sort(_flat_patterns(x), dim=-1).values
    p = s.shape[-1]
    med = s[..., p // 2] if p % 2 else (s[..., p // 2 - 1] + s[..., p // 2]) * 0.5
    return med.reshape(med.shape + (1, 1, 1))


def _gaussian_kernel(sigma: float, truncate: float) -> np.ndarray:
    """1-D Gaussian taps with scipy.ndimage's radius ``int(truncate *
    sigma + 0.5)``, normalized to sum 1."""
    radius = max(1, int(truncate * float(sigma) + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _band_matrix(n: int, taps: np.ndarray) -> np.ndarray:
    """``(n + 2r, n)`` matrix whose column j holds the taps from row j, so
    ``x_padded @ M`` is a valid 1-D correlation along that axis."""
    r = (len(taps) - 1) // 2
    m = np.zeros((n + 2 * r, n), dtype=np.float32)
    for t in range(len(taps)):
        m[np.arange(n) + t, np.arange(n)] = taps[t]
    return m


def _symmetric_index(n: int, r: int) -> np.ndarray:
    """Source rows of an axis of ``n`` padded by ``r`` on each side in
    numpy's "symmetric" mode (the edge repeated, as scipy's "reflect")."""
    i = np.arange(-r, n + r) % (2 * n)
    return np.where(i >= n, 2 * n - 1 - i, i)


@functools.lru_cache(maxsize=64)
def _blur_operators(h: int, w: int, sigma: float, truncate: float, device: torch.device):
    """The padding indices and band matrices of a blur, made once per shape
    and device: a copy to the card inside every call would hold the host
    until the device had caught up."""
    taps = _gaussian_kernel(sigma, truncate)
    r = (len(taps) - 1) // 2
    return tuple(
        torch.as_tensor(a, device=device)
        for a in (_symmetric_index(h, r), _symmetric_index(w, r),
                  _band_matrix(h, taps), _band_matrix(w, taps))
    )


def gaussian_blur(patterns: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur over the (H, W) axes, equal to
    ``scipy.ndimage.gaussian_filter(..., mode="reflect")`` to f32 roundoff;
    the two passes are f32 band-matrix products."""
    x, squeeze = _with_channel(patterns)
    x = x.float()
    rows, cols, mh, mw = _blur_operators(
        x.shape[-3], x.shape[-2], float(sigma), float(truncate), x.device
    )
    xp = x.index_select(-3, rows).index_select(-2, cols)
    y = torch.einsum("...hwc,hg->...gwc", xp, mh)
    y = torch.einsum("...hwc,wv->...hvc", y, mw)
    return y[..., 0] if squeeze else y


def remove_static_background(
    patterns: torch.Tensor, background, mode: str = "divide"
) -> torch.Tensor:
    """Correct the fixed detector response with an ``(H, W[, C])`` frame:
    ``divide`` scales by ``mean(bg) / bg``, ``subtract`` removes
    ``bg - mean(bg)``; either keeps the input's intensity scale."""
    if mode not in ("divide", "subtract"):
        raise ValueError(f"mode must be 'divide' or 'subtract', got {mode!r}")
    x, squeeze = _with_channel(patterns)
    if not isinstance(background, torch.Tensor):
        background = torch.from_numpy(np.asarray(background, np.float32))
    bg, _ = _with_channel(background.to(x.device).float())
    mean = bg.mean()
    y = x * (mean / (bg + _EPS)) if mode == "divide" else x - (bg - mean)
    return y[..., 0] if squeeze else y


def remove_dynamic_background(
    patterns: torch.Tensor, sigma: float | None = None, mode: str = "divide",
    truncate: float = 4.0,
) -> torch.Tensor:
    """Remove each pattern's smooth background, estimated as its own
    Gaussian blur (``sigma`` defaults to H / 8), by ratio or difference."""
    if mode not in ("divide", "subtract"):
        raise ValueError(f"mode must be 'divide' or 'subtract', got {mode!r}")
    x, squeeze = _with_channel(patterns)
    if sigma is None:
        sigma = x.shape[-3] / 8.0
    bg = gaussian_blur(x, sigma, truncate=truncate)
    y = x / (bg + _EPS) if mode == "divide" else x - bg
    return y[..., 0] if squeeze else y


def fix_hot_pixels(patterns: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """Replace pixels further than ``threshold`` robust noise scales (1.4826
    times the pattern's median |residual|) from their 8-neighbour median
    with that median; edges use replicated neighbours."""
    x, squeeze = _with_channel(patterns)
    x = x.float()
    h, w = x.shape[-3], x.shape[-2]
    rows = torch.clamp(torch.arange(-1, h + 1, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 1, device=x.device), 0, w - 1)
    xp = x.index_select(-3, rows).index_select(-2, cols)
    views = [
        xp[..., i : i + h, j : j + w, :]
        for i in range(3)
        for j in range(3)
        if not (i == 1 and j == 1)
    ]
    s = torch.sort(torch.stack(views, dim=-1), dim=-1).values
    med = 0.5 * (s[..., 3] + s[..., 4])
    resid = x - med
    scale = 1.4826 * _per_pattern_median(resid.abs()) + _EPS
    y = torch.where(resid.abs() > threshold * scale, med, x)
    return y[..., 0] if squeeze else y


def normalize_patterns(
    patterns: torch.Tensor, method: str = "minmax", clip_sigma: float | None = None
) -> torch.Tensor:
    """Per-pattern normalization: ``minmax`` to [0, 1] (the VAE's input
    contract) or ``zscore`` to mean 0 and std 1; ``clip_sigma`` first clips
    to ``median ± k * IQR / 1.349`` (one sort per pattern)."""
    if method not in ("minmax", "zscore"):
        raise ValueError(f"method must be 'minmax' or 'zscore', got {method!r}")
    x, squeeze = _with_channel(patterns)
    x = x.float()
    if clip_sigma is not None:
        s = torch.sort(_flat_patterns(x), dim=-1).values
        p = s.shape[-1]
        med = s[..., p // 2]
        sd = (s[..., (3 * p) // 4] - s[..., p // 4]) / 1.349 + _EPS
        shape = med.shape + (1, 1, 1)
        med, sd = med.reshape(shape), sd.reshape(shape)
        x = torch.clamp(x, med - clip_sigma * sd, med + clip_sigma * sd)
    dims = (-3, -2, -1)  # each pattern's (H, W, C)
    if method == "zscore":
        mu = x.mean(dim=dims, keepdim=True)
        sd = x.var(dim=dims, keepdim=True, unbiased=False).sqrt()
        y = (x - mu) / (sd + _EPS)
    else:
        lo = x.amin(dim=dims, keepdim=True)
        hi = x.amax(dim=dims, keepdim=True)
        y = (x - lo) / (hi - lo + _EPS)
    return y[..., 0] if squeeze else y


def equalize_histogram(patterns: torch.Tensor) -> torch.Tensor:
    """Exact per-pattern histogram equalization: each pixel becomes its
    pattern's empirical CDF ``P(X <= x)``, so equal values map equally and
    the output fills (0, 1]."""
    x, squeeze = _with_channel(patterns)
    x = x.float()
    shape = x.shape
    flat = x.reshape(-1, math.prod(shape[-3:]))
    p = flat.shape[-1]
    order = torch.argsort(flat, dim=-1, stable=True)
    s = flat.gather(-1, order)
    run_end = torch.ones_like(s, dtype=torch.bool)
    run_end[:, :-1] = s[:, 1:] != s[:, :-1]
    idx = torch.arange(p, device=x.device).expand_as(order)
    # The last index of each tie run: a reverse cummin over the run ends.
    cand = torch.where(run_end, idx, torch.full_like(idx, p - 1))
    last = torch.cummin(cand.flip(-1), dim=-1).values.flip(-1)
    eq_sorted = (last + 1).float() / p
    y = torch.empty_like(eq_sorted).scatter_(-1, order, eq_sorted).reshape(shape)
    return y[..., 0] if squeeze else y


def bin_patterns(patterns: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool the (H, W) axes by ``factor`` (detector binning); H and
    W must divide by it."""
    x, squeeze = _with_channel(patterns)
    h, w, c = x.shape[-3], x.shape[-2], x.shape[-1]
    if h % factor or w % factor:
        raise ValueError(f"pattern {h}x{w} not divisible by bin factor {factor}")
    lead = x.shape[:-3]
    y = x.reshape(lead + (h // factor, factor, w // factor, factor, c))
    y = y.float().mean(dim=(-4, -2))
    return y[..., 0] if squeeze else y


def estimate_static_background(chunks) -> np.ndarray:
    """Mean pattern over a scan, the static background estimate: one
    ``(N, H, W[, C])`` stack or an iterable of such chunks, summed on the
    host in f64 so the scan never has to be whole in memory."""
    if isinstance(chunks, np.ndarray) or hasattr(chunks, "shape"):
        chunks = [chunks]
    total = None
    count = 0
    for chunk in chunks:
        arr = np.asarray(chunk, dtype=np.float64)
        if arr.ndim == 2:
            arr = arr[None]
        total = arr.sum(axis=0) if total is None else total + arr.sum(axis=0)
        count += len(arr)
    if not count:
        raise ValueError("no patterns to estimate a background from")
    return (total / count).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """A preprocessing recipe for `make_preprocess_fn`.

    Stages run in this order, each optional (the default is the identity):
    hot-pixel repair, static background, dynamic background, robust clip
    (``clip_sigma``, then minmax), histogram equalization, normalization,
    binning. ``normalize`` defaults to "minmax" when a background stage
    runs and neither equalization nor the clip already maps to [0, 1].
    ``static_background`` is an ``(H, W)`` frame, or "auto" for the query
    CLI to replace with the scan's mean; ``dynamic_sigma`` "auto" is H / 8.
    """

    hot_pixel_threshold: float | None = None
    static_background: np.ndarray | str | None = None
    static_mode: str = "divide"
    dynamic_sigma: float | str | None = None
    dynamic_mode: str = "divide"
    equalize: bool = False
    normalize: str | None = None
    clip_sigma: float | None = None
    bin_factor: int | None = None


def parse_preprocess_spec(spec: str) -> PreprocessConfig:
    """The CLI's ``key[=value],...`` spec as a `PreprocessConfig`, e.g.
    ``"hotpixels=5,static=bg.npy,dynamic=auto,clip=4,bin=2"``.

    Keys: ``hotpixels=<threshold>``, ``static=<frame.npy>|auto``,
    ``static-mode=divide|subtract``, ``dynamic=auto|<sigma>``,
    ``dynamic-mode=divide|subtract``, ``equalize``,
    ``normalize=minmax|zscore``, ``clip=<sigma>``, ``bin=<factor>``.
    """
    kw: dict[str, object] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        key, _, val = entry.partition("=")
        key = key.strip().lower()
        val = val.strip()
        try:
            if key == "hotpixels":
                kw["hot_pixel_threshold"] = float(val)
            elif key == "static":
                kw["static_background"] = "auto" if val == "auto" else np.load(val)
            elif key == "static-mode":
                kw["static_mode"] = val
            elif key == "dynamic":
                kw["dynamic_sigma"] = "auto" if val == "auto" else float(val)
            elif key == "dynamic-mode":
                kw["dynamic_mode"] = val
            elif key == "equalize":
                kw["equalize"] = True
            elif key == "normalize":
                kw["normalize"] = val
            elif key == "clip":
                kw["clip_sigma"] = float(val)
            elif key == "bin":
                kw["bin_factor"] = int(val)
            else:
                raise ValueError(f"unknown preprocess key {key!r} in {spec!r}")
        except (TypeError, ValueError) as e:
            if "unknown preprocess key" in str(e):
                raise
            raise ValueError(f"bad value for preprocess key {key!r}: {val!r}") from e
    cfg = PreprocessConfig(**kw)
    _validate_config(cfg)
    return cfg


def _validate_config(cfg: PreprocessConfig) -> None:
    if cfg.static_mode not in ("divide", "subtract"):
        raise ValueError(f"bad static_mode {cfg.static_mode!r}")
    if cfg.dynamic_mode not in ("divide", "subtract"):
        raise ValueError(f"bad dynamic_mode {cfg.dynamic_mode!r}")
    if cfg.normalize not in (None, "minmax", "zscore"):
        raise ValueError(f"bad normalize {cfg.normalize!r}")


def make_preprocess_fn(config: PreprocessConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """A `PreprocessConfig` as one function of a pattern stack, for
    ``IndexPipeline(preprocess=...)`` or use on its own. A "auto" static
    background must be resolved first (`estimate_static_background`)."""
    cfg = config
    _validate_config(cfg)
    if isinstance(cfg.static_background, str):
        raise ValueError(
            "static_background='auto' is a placeholder: resolve it with "
            "data.estimate_static_background(scan) first (the query CLI does; "
            "a server has no scan to estimate from)"
        )
    static_bg = (
        None
        if cfg.static_background is None
        else torch.as_tensor(np.asarray(cfg.static_background, np.float32))
    )
    normalize = cfg.normalize
    corrected = static_bg is not None or cfg.dynamic_sigma is not None
    already_unit = cfg.equalize or cfg.clip_sigma is not None
    if normalize is None and corrected and not already_unit:
        normalize = "minmax"

    static_on = {}  # the frame on each device it has met, copied there once

    def preprocess(x: torch.Tensor) -> torch.Tensor:
        if cfg.hot_pixel_threshold is not None:
            x = fix_hot_pixels(x, cfg.hot_pixel_threshold)
        if static_bg is not None:
            if x.device not in static_on:
                static_on[x.device] = static_bg.to(x.device)
            x = remove_static_background(x, static_on[x.device], cfg.static_mode)
        if cfg.dynamic_sigma is not None:
            sigma = (
                _with_channel(x)[0].shape[-3] / 8.0
                if isinstance(cfg.dynamic_sigma, str)
                else float(cfg.dynamic_sigma)
            )
            x = remove_dynamic_background(x, sigma, cfg.dynamic_mode)
        if cfg.clip_sigma is not None:
            # Its own stage, before equalization, so outliers cannot skew it.
            x = normalize_patterns(x, "minmax", clip_sigma=cfg.clip_sigma)
        if cfg.equalize:
            x = equalize_histogram(x)
        if normalize is not None:
            x = normalize_patterns(x, normalize)
        if cfg.bin_factor is not None and cfg.bin_factor > 1:
            x = bin_patterns(x, cfg.bin_factor)
        return x

    return preprocess
