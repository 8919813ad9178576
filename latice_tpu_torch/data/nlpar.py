"""NLPAR-style neighbourhood pattern averaging for noisy EBSD scans.

The port of ``latice_tpu.data.nlpar``: the non-local pattern averaging of
Brewick, Wright & Rowenhorst (Ultramicroscopy 200, 2019). Each scan point's
pattern becomes a similarity-weighted average of the patterns in its
``(2r+1) x (2r+1)`` spatial neighbourhood. Inside a grain the weights are
near-uniform, a ~(2r+1)² noise reduction; across a boundary the pattern
distance exceeds the noise floor and the weight falls to ~0. The weighting:

    d2[i,j]    = || p_i - p_j ||^2                    (sum over n pixels)
    sigma2[i]  = min_{j in N4(i)} d2[i,j] / (2 n)     (noise variance)
    s2[i,j]    = (sigma2[i] + sigma2[j]) / 2
    lam[i,j]   = max(d2[i,j] - 2 n s2, 0) / (s2 * sqrt(8 n))
    w[i,j]     = exp(-lam / h^2),  w[i,i] = 1

so ``h`` is in units of noise standard deviations.

The scan goes to the device in row slabs of about 256 MB with r + 1 halo
rows, so the whole float scan never has to fit there: each slab crosses
once and serves both passes (the noise estimate of its rows and of the r
halo rows, then the average of its rows). Each neighbour distance is a
multiply-reduce between two shifted views of the slab. Neighbours outside the scan are masked, not
padded, so border noise estimates never see self-copies; an isolated point
(a 1x1 scan) gets sigma² = 0 and keeps its own pattern. The last slab runs
at its own height (the JAX package zero-pads it to one static shape); the
rows it returns are the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from latice_tpu_torch.device import resolve_device

__all__ = ["estimate_noise_sigma", "nlpar_denoise"]

_SLAB_BYTES = 256e6


def _offsets(radius: int) -> list[tuple[int, int]]:
    return [(di, dj) for di in range(-radius, radius + 1) for dj in range(-radius, radius + 1)]


def _shift(xp: torch.Tensor, di: int, dj: int, r: int, rows: int, cols: int) -> torch.Tensor:
    """View of the r-haloed array aligned at offset (di, dj)."""
    return xp[r + di : r + di + rows, r + dj : r + dj + cols]


def _sq_dist(center: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    return (center - nb).pow_(2).sum(dim=-1)


def _sigma2_slab(xp: torch.Tensor, maskp: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """Per-point noise variance ``(rows, cols)`` of a 1-haloed slab
    ``xp (rows+2, cols+2, n)`` with validity ``maskp (rows+2, cols+2)``."""
    rows, cols = xp.shape[0] - 2, xp.shape[1] - 2
    center = _shift(xp, 0, 0, 1, rows, cols)
    best = torch.full((rows, cols), math.inf, device=xp.device)
    for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        d2 = _sq_dist(center, _shift(xp, di, dj, 1, rows, cols))
        valid = _shift(maskp, di, dj, 1, rows, cols) > 0
        best = torch.minimum(best, torch.where(valid, d2, math.inf))
    best = torch.where(torch.isfinite(best), best, 0.0)
    return best / (2.0 * n_pixels)


def _nlpar_slab(xp, s2p, maskp, hh: float, radius: int, n_pixels: int) -> torch.Tensor:
    """The weighted average ``(rows, cols, n)`` of an r-haloed slab; ``s2p``
    and ``maskp`` are the matching sigma² and validity, ``hh`` is h²."""
    r = radius
    rows, cols = xp.shape[0] - 2 * r, xp.shape[1] - 2 * r
    center = _shift(xp, 0, 0, r, rows, cols)
    s2_c = _shift(s2p, 0, 0, r, rows, cols)
    inv_var_norm = 1.0 / math.sqrt(8.0 * n_pixels)
    acc = center.clone()  # w[i,i] = 1 by construction (d2 = 0)
    wsum = torch.ones((rows, cols), device=xp.device)
    for di, dj in _offsets(r):
        if di == 0 and dj == 0:
            continue
        nb = _shift(xp, di, dj, r, rows, cols)
        d2 = _sq_dist(center, nb)
        s2 = 0.5 * (s2_c + _shift(s2p, di, dj, r, rows, cols))
        lam = torch.clamp(d2 - 2.0 * n_pixels * s2, min=0.0) * (
            inv_var_norm / torch.clamp(s2, min=1e-30)
        )
        w = torch.exp(-lam / hh)
        w = torch.where(_shift(maskp, di, dj, r, rows, cols) > 0, w, 0.0)
        acc += w[..., None] * nb
        wsum += w
    return acc / wsum[..., None]


class _Slabs:
    """Row slabs of a ``(R, C, n)`` host scan on the device, zero outside
    the scan, with their validity masks; patterns are hot-pixel repaired
    (`data.preprocess.fix_hot_pixels`) as they arrive, when asked. On a
    CUDA device every copy, up and back, goes through one pinned buffer of
    ``max_rows`` scan rows, so it runs at the link's rate."""

    def __init__(self, flat: np.ndarray, shape_hw, hot_pixel_threshold, device, max_rows: int):
        self.flat, self.hw, self.device = flat, shape_hw, device
        self.threshold = hot_pixel_threshold
        self.stage = None
        if device.type == "cuda":
            rows = min(max_rows, flat.shape[0])
            self.stage = torch.empty((rows, *flat.shape[1:]), pin_memory=True)

    def get(self, row0: int, rows: int, halo: int) -> tuple[torch.Tensor, torch.Tensor]:
        r_, c_, n = self.flat.shape
        lo, hi = max(row0 - halo, 0), min(row0 + rows + halo, r_)
        top = lo - (row0 - halo)
        part = torch.from_numpy(self.flat[lo:hi])
        if self.stage is not None:
            part = self.stage[: hi - lo].copy_(part)
        part = part.to(self.device)
        if self.threshold is not None:
            from latice_tpu_torch.data.preprocess import fix_hot_pixels

            part = fix_hot_pixels(part.reshape(-1, *self.hw), self.threshold)
            part = part.reshape(hi - lo, c_, n)
        xp = torch.zeros((rows + 2 * halo, c_ + 2 * halo, n), device=self.device)
        xp[top : top + hi - lo, halo : halo + c_] = part
        maskp = torch.zeros(xp.shape[:2], device=self.device)
        maskp[top : top + hi - lo, halo : halo + c_] = 1.0
        return xp, maskp

    def put(self, out: np.ndarray, row0: int, rows: torch.Tensor) -> None:
        """Copy the device rows ``rows`` to ``out[row0:]`` on the host."""
        if self.stage is not None:
            rows = self.stage[: len(rows)].copy_(rows)
        out[row0 : row0 + len(rows)] = rows.numpy()


def _default_chunk_rows(cols: int, n: int) -> int:
    return max(1, int(_SLAB_BYTES / max(cols * n * 4, 1)))


def _sigma2(slabs: _Slabs, rows_total: int, step: int, n: int) -> torch.Tensor:
    """The ``(R, C)`` sigma² field, streamed with 1-row halos."""
    parts = []
    for row0 in range(0, rows_total, step):
        rows = min(step, rows_total - row0)
        parts.append(_sigma2_slab(*slabs.get(row0, rows, 1), n))
    return torch.cat(parts)


def estimate_noise_sigma(
    patterns: np.ndarray, device: str | torch.device | None = None
) -> np.ndarray:
    """Per-point noise standard deviation ``(R, C)`` of a ``(R, C, H, W)``
    scan: the square root of the minimum over the 4-connected neighbours of
    ``||p_i - p_j||² / (2 n)``. ``device`` is ``cuda`` unless given."""
    x = np.asarray(patterns, np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (R, C, H, W) scan, got {x.shape}")
    dev = resolve_device(device)
    r_, c_, h_, w_ = x.shape
    n = h_ * w_
    step = max(1, min(_default_chunk_rows(c_, n), r_))
    slabs = _Slabs(x.reshape(r_, c_, n), (h_, w_), None, dev, step + 2)
    with torch.no_grad():
        s2 = _sigma2(slabs, r_, step, n)
    return np.sqrt(s2.cpu().numpy())


def nlpar_denoise(
    patterns: np.ndarray,
    search_radius: int = 1,
    h: float = 1.0,
    chunk_rows: int | None = None,
    hot_pixel_threshold: float | None = None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Denoise a ``(R, C, H, W)`` scan by neighbourhood pattern averaging.

    Args:
        patterns: the scan, any float or integer dtype (computed in float32,
            returned as float32; integers are not rescaled).
        search_radius: neighbourhood half-width r (window ``(2r+1)²``).
        h: smoothing strength in noise standard deviations.
        chunk_rows: scan rows per slab (default: a slab is ~256 MB).
        hot_pixel_threshold: optionally repair hot pixels
            (`data.preprocess.fix_hot_pixels`) in every slab before the
            noise estimate and the averaging: unrepaired spikes inflate
            every distance and get smeared across the window.
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        The denoised ``(R, C, H, W)`` float32 scan, on the host.
    """
    x = np.asarray(patterns, np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (R, C, H, W) scan, got {x.shape}")
    if search_radius < 1:
        raise ValueError("search_radius must be >= 1")
    if h <= 0:
        raise ValueError("h must be positive")
    dev = resolve_device(device)
    r_, c_, h_, w_ = x.shape
    n = h_ * w_
    rad = search_radius
    step = max(1, min(chunk_rows or _default_chunk_rows(c_, n), r_))
    slabs = _Slabs(x.reshape(r_, c_, n), (h_, w_), hot_pixel_threshold, dev, step + 2 * rad + 2)
    hh = float(np.float32(h) * np.float32(h))
    out = np.empty((r_, c_, n), np.float32)
    with torch.no_grad():
        for row0 in range(0, r_, step):
            rows = min(step, r_ - row0)
            # sigma² of the r-haloed slab needs one more row and column each
            # side; it is zero outside the scan, as the JAX package pads it.
            xp, maskp = slabs.get(row0, rows, rad + 1)
            inner = maskp[1:-1, 1:-1]
            s2p = _sigma2_slab(xp, maskp, n) * inner
            res = _nlpar_slab(xp[1:-1, 1:-1], s2p, inner, hh, rad, n)
            slabs.put(out, row0, res)
    return out.reshape(r_, c_, h_, w_)
