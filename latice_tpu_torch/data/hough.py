"""Hough/Radon band detection and the detector-side Image Quality.

The port of ``latice_tpu.data.hough``. Vendor software (OIM, Esprit, AZtec)
finds Kikuchi bands with a Radon ("Hough") transform and maps the mean peak
response as the Image Quality. The transform is a matrix: the line-integral
weights are precomputed once into a dense ``(n_theta * n_rho, H*W)`` matrix,
so a batch transforms as one ``(B, H*W) @ (H*W, n_lines)`` product; band
enhancement is a small butterfly filter along rho, and peak picking is a
3x3 maximum filter and a top-k.

Conventions: pixel (row, col) maps to centered coordinates
``x = col - (W-1)/2`` (right), ``y = (H-1)/2 - row`` (up). A line is
``rho = x cos(theta) + y sin(theta)`` with theta in [0, 180) degrees, the
band NORMAL's direction, and rho the signed distance from the pattern center
in pixels. Only pixels inside the inscribed circle contribute.

On the device the product runs as the JAX package's does: both operands
rounded to bf16, every product exact and accumulated in f32. On the card
that is one bf16 tensor-core GEMM with an f32 output over the bf16 matrix
(283 MB at 128x128); on the CPU the bf16 operands are widened and multiplied
in full f32, which gives the same exact products.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.device import full_f32_matmul, resolve_device

__all__ = [
    "BandDetection",
    "BandDetector",
    "butterfly_kernel",
    "radon_matrix",
]


def radon_matrix(
    h: int,
    w: int,
    n_theta: int = 90,
    n_rho: int = 96,
) -> tuple[np.ndarray, np.ndarray]:
    """Precompute the dense Radon line-integral matrix.

    Each (theta, rho) row holds per-pixel weights that *average* the
    image along that line (linear interpolation between the two nearest
    rho bins, normalized by total support), so the sinogram of a
    constant image is constant — band peaks then measure real contrast,
    not line length.

    Returns:
        ``(A, mask)`` — ``A`` is ``(n_theta * n_rho, h * w)`` float32,
        ``mask`` the ``(h, w)`` bool inscribed-circle support.
    """
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows, cols = np.mgrid[0:h, 0:w]
    x = (cols - cx).astype(np.float64)
    y = (cy - rows).astype(np.float64)
    radius = min(h, w) / 2.0
    mask = (x**2 + y**2) <= radius**2
    pix = np.nonzero(mask.ravel())[0]
    xm, ym = x.ravel()[pix], y.ravel()[pix]

    thetas = np.pi * np.arange(n_theta) / n_theta
    a = np.zeros((n_theta, n_rho, h * w), np.float32)
    for t, th in enumerate(thetas):
        rho = xm * np.cos(th) + ym * np.sin(th)
        pos = (rho + radius) / (2.0 * radius) * (n_rho - 1)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, n_rho - 2)
        frac = (pos - lo).astype(np.float32)
        np.add.at(a[t], (lo, pix), 1.0 - frac)
        np.add.at(a[t], (lo + 1, pix), frac)
    support = a.sum(axis=2, keepdims=True)  # (n_theta, n_rho, 1)
    # Mean along the line; starved bins (rho beyond the circle) stay 0.
    min_support = 0.05 * float(support.max())
    a = np.where(support > min_support, a / np.maximum(support, 1e-9), 0.0)
    return a.reshape(n_theta * n_rho, h * w).astype(np.float32), mask


def butterfly_kernel(width: int = 5) -> np.ndarray:
    """1-D band-enhancement kernel along rho (the "butterfly" filter).

    A bright Kikuchi band is a plateau of width ~band width flanked by
    the background: +1 over the plateau, -1 over equal-length flanks,
    zero-sum — so flat background cancels and a band of matching width
    scores its (mean band − mean flank) contrast.
    """
    if width < 1:
        raise ValueError(f"butterfly width must be >= 1, got {width}")
    width |= 1  # odd plateau -> odd total length, so "same" conv centers
    flank = max(width // 2, 1)
    k = np.concatenate(
        [
            -np.ones(flank) / (2 * flank),
            np.ones(width) / width,
            -np.ones(flank) / (2 * flank),
        ]
    )
    return k.astype(np.float32)


def _banded(kern: np.ndarray, n: int) -> np.ndarray:
    """``(n, n)`` matrix ``M`` with ``(s @ M)[i] = sum_j kern[j] s[i + j - len//2]``
    over in-range ``i + j - len//2``: the zero-padded cross-correlation
    along rho as one product."""
    half = len(kern) // 2
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for j, kv in enumerate(kern):
            src = i + j - half
            if 0 <= src < n:
                m[src, i] = kv
    return m


class BandDetection(NamedTuple):
    """Per-pattern detected bands + quality metrics (host numpy)."""

    theta_deg: np.ndarray  # (B, k) band-normal angle, [0, 180)
    rho_px: np.ndarray  # (B, k) signed center distance, pixels
    strength: np.ndarray  # (B, k) butterfly response, best-first
    iq: np.ndarray  # (B,) mean strength of the detected bands (OIM IQ role)
    band_count: np.ndarray  # (B,) peaks above half the strongest


class BandDetector:
    """Radon -> butterfly -> NMS -> top-k band finder on one device.

    Args:
        height / width: detector frame shape.
        n_theta: angular bins over [0, 180) (2° default resolution).
        n_rho: radial bins over the inscribed-circle diameter.
        k: bands returned per pattern (strongest first).
        band_width_px: expected band width in PIXELS (sets the butterfly
            plateau; ~6-10 px for 128² detectors at typical kV).
        batch_size: rows per device batch (inputs padded up to it).
        device: ``cuda`` unless given; a missing CUDA device raises.

    Call with ``(B, H, W[, 1])`` patterns (uint8 or float: the per-pattern
    standardization makes gain and offset irrelevant, and uint8 reaches the
    device as uint8 and is widened there without a division); returns a
    `BandDetection`.
    """

    def __init__(
        self,
        height: int = 128,
        width: int = 128,
        n_theta: int = 90,
        n_rho: int = 96,
        k: int = 10,
        band_width_px: float = 8.0,
        batch_size: int = 256,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.n_theta, self.n_rho, self.k = n_theta, n_rho, k
        self.batch_size = batch_size
        self.shape = (height, width)
        a, mask = radon_matrix(height, width, n_theta, n_rho)
        self.radius = min(height, width) / 2.0
        self.rho_scale = 2.0 * self.radius / (n_rho - 1)
        # Band width in rho bins sets the butterfly plateau.
        width_bins = max(int(round(band_width_px / self.rho_scale)), 1)
        kern = butterfly_kernel(width_bins)
        # (n_pix, n_lines) in bf16, the operand the JAX package multiplies.
        self._a = torch.from_numpy(a).to(self.device, torch.bfloat16).T.contiguous()
        self._mask = torch.from_numpy(mask.ravel().astype(np.float32)).to(self.device)
        self._butterfly = torch.from_numpy(_banded(kern, n_rho)).to(self.device)
        self._n_support = float(mask.sum())

    def _sinogram(self, v: torch.Tensor) -> torch.Tensor:
        """``(B, n_lines)`` f32 products of the bf16-rounded patterns with
        the bf16 matrix, accumulated in f32."""
        v = v.to(torch.bfloat16)
        if v.is_cuda:
            return torch.mm(v, self._a, out_dtype=torch.float32)
        return v.float() @ self._a.float()

    def _run(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """One padded device batch → ``(theta, rho, strength, iq, count)``."""
        if not torch.is_floating_point(x):
            x = x.float()  # uint8 counts as they are: no /255
        b = x.shape[0]
        mask = self._mask
        v = x.reshape(b, -1) * mask
        # Standardize per pattern over the support (zero mean, unit std):
        # band responses then measure contrast relative to the pattern's
        # own spread, so added noise LOWERS the IQ.
        mean = v.sum(dim=1, keepdim=True) / self._n_support
        v = (v - mean) * mask
        var = (v * v).sum(dim=1, keepdim=True) / self._n_support
        v = v / torch.sqrt(var + 1e-12)
        with full_f32_matmul():
            sino = self._sinogram(v).reshape(b * self.n_theta, self.n_rho)
            # Butterfly along rho (theta is the feature-free axis).
            resp = (sino @ self._butterfly).reshape(b, self.n_theta, self.n_rho)
        # The theta axis wraps with rho negated: one halo row each side, so
        # peaks at theta ~ 0/180 suppress their wrapped twins.
        halo = resp[:, -1:, :].flip(2)
        halo0 = resp[:, :1, :].flip(2)
        padded = torch.cat([halo, resp, halo0], dim=1)
        # 3x3 maximum, -inf padding along rho, valid along the haloed theta.
        neigh = torch.nn.functional.max_pool2d(
            padded[:, None], kernel_size=3, stride=1, padding=(0, 1)
        )[:, 0]
        is_peak = resp >= neigh  # plateaus stay peaks
        flat = torch.where(is_peak, resp, float("-inf")).reshape(b, -1)
        from latice_tpu_torch.index.knn import topk_lower_index_first

        strength, idx = topk_lower_index_first(flat, self.k)
        t_idx = torch.div(idx, self.n_rho, rounding_mode="floor")
        r_idx = idx % self.n_rho
        theta = t_idx.float() * (180.0 / self.n_theta)
        rho = r_idx.float() * self.rho_scale - self.radius
        # IQ: mean response of the k detected bands (the OIM Hough-IQ
        # definition); band_count: peaks within 2x of the strongest.
        finite = torch.isfinite(strength)
        s = torch.where(finite, strength, 0.0)
        iq = s.sum(dim=1) / finite.sum(dim=1).clamp(min=1)
        count = ((s >= 0.5 * s[:, :1]) & finite & (s > 0)).sum(dim=1)
        return theta, rho, s, iq, count

    @torch.inference_mode()
    def __call__(self, patterns: np.ndarray) -> BandDetection:
        from latice_tpu_torch.index.pipeline import device_batches

        x = np.asarray(patterns)
        if x.ndim == 4:
            x = x[..., 0]
        if x.shape[1:] != self.shape:
            raise ValueError(f"expected {self.shape} frames, got {x.shape[1:]}")
        # Every batch is enqueued before the first result is read back.
        pending = [(n, self._run(chunk)) for n, chunk in device_batches(x, self.batch_size, self.device)]
        theta, rho, s, iq, count = (
            torch.cat([res[i][:n] for n, res in pending]).cpu().numpy() for i in range(5)
        )
        return BandDetection(
            theta_deg=theta.astype(np.float64),
            rho_px=rho.astype(np.float64),
            strength=s.astype(np.float64),
            iq=iq.astype(np.float64),
            band_count=count.astype(np.int64),
        )
