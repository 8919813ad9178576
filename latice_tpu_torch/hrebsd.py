"""HR-EBSD: cross-correlation elastic strain and lattice rotation mapping.

The port of ``latice_tpu.hrebsd``. High-angular-resolution EBSD
(Wilkinson–Meaden–Dingley 2006) measures the *relative* deformation
between a reference pattern and each map pattern from sub-pixel shifts of
many small regions of interest (ROIs): an elastic strain or a small
lattice rotation moves every Kikuchi feature by a predictable screen
shift, so ~20 ROI shifts over-determine the 8 observable components of the
displacement-gradient tensor to ~1e-4 strain sensitivity.

Device and host split as in the JAX package:

- On the device, in float32, per chunk of patterns: the ROI stack (one
  gather with a precomputed index), the Hann-windowed, band-passed FFT
  cross-correlation against the reference ROIs (whose spectrum is taken
  once per call and broadcast), the Guizar-Sicairos matrix-DFT upsampling
  around the coarse peak (two small complex products per ROI) and the
  parabolic peak (`_xcorr_shifts`); the remap warp, a four-tap bilinear
  gather chained into the same device pass (`_remap_core`); the batched
  8x8 weighted normal equations (`_solve_core`); the stiffness rotation
  and the traction-free closure (`_traction_free`).
- On the host, in float64: the ROI layout and design matrix, the PC
  correction, and `hrebsd_map`'s outer loop (the per-pattern acceptance
  ``rms2 < rms`` of the remap pass and the gauge reset).

Every product runs at full float32 (`device.full_f32_matmul`), as JAX runs
them at ``Precision.HIGHEST``: under TF32 the 10-bit mantissa is of the
size of the 1/upsample-px shift signal the fine grid resolves. uint8 frames
cross the bus raw and widen on the device. Entry points run on ``cuda``
unless ``device="cpu"`` is passed. With ``mesh=`` each chunk's patterns
shard over the mesh's devices (every stage is per pattern and ROI), the
tables copied to each device; the solve runs on the first device.

Geometry (detector frame of `sim.geometry`: x right, y up, z from the
sample into the detector, widths as units). A screen point sits at
``r = (x, y, D)`` with ``D = geometry.dd``. Under a small
displacement-gradient tensor ``A`` the gnomonic re-projection shifts the
feature by, to first order, ``q = A r − ((A r)·ẑ / D) r``, which is
invariant under ``A → A + λI``: the solve fixes the gauge ``a33 = 0`` and,
with elastic constants, restores ``λ`` from the traction-free surface
condition ``σ_nn = 0``. Beyond ~1 degree of rotation the iterative
remapping pass (Britton & Wilkinson 2012) re-projects each pattern through
the recovered deformation, re-correlates and composes
``F_new = F_est (I + A_res)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from latice_tpu_torch.crystal.quaternion import quat_to_matrix
from latice_tpu_torch.device import full_f32_matmul, resolve_device
from latice_tpu_torch.parallel.mesh import chunk_device, map_blocks, replicate
from latice_tpu_torch.sim.geometry import DetectorGeometry

__all__ = [
    "HrebsdResult",
    "default_roi_centers",
    "hrebsd_map",
    "measure_roi_shifts",
    "remap_patterns",
    "roi_position_vectors",
    "solve_deformation",
    "von_mises_strain",
]


class HrebsdResult(NamedTuple):
    """Per-pattern HR-EBSD output (``B`` patterns, ``R`` ROIs).

    Attributes:
        a: ``(B, 3, 3)`` displacement-gradient tensor, detector frame.
            Gauge: traction-free when stiffness was supplied, else
            ``a[2, 2] = 0``.
        strain: ``(B, 3, 3)`` elastic strain ``sym(A)``.
        rotation: ``(B, 3)`` lattice-rotation vector (radians,
            right-handed about detector x/y/z) from ``skew(A)``.
        rotation_deg: ``(B,)`` rotation magnitude, degrees: values near
            or past ~1 degree leave the first-order validity range.
        stress: ``(B, 3, 3)`` stress (stiffness units, typically GPa) via
            Hooke's law, or None when no stiffness was supplied.
        shifts_px: ``(B, R, 2)`` measured ROI shifts, pixels, as
            ``(d_row, d_col)`` (row grows downward).
        quality: ``(B, R)`` normalized cross-correlation peak heights in
            [0, 1]: the per-ROI confidence used as solve weights.
        residual_px: ``(B,)`` RMS of (measured − modeled) ROI shifts in
            pixels: the fit's self-consistency diagnostic.
    """

    a: np.ndarray
    strain: np.ndarray
    rotation: np.ndarray
    rotation_deg: np.ndarray
    stress: np.ndarray | None
    shifts_px: np.ndarray
    quality: np.ndarray
    residual_px: np.ndarray


def default_roi_centers(
    geometry: DetectorGeometry,
    roi_size: int = 64,
    n_rings: int = 2,
    per_ring: Sequence[int] = (8, 12),
    margin: int = 2,
) -> np.ndarray:
    """Standard HR-EBSD ROI layout: one ROI on the pattern center plus
    concentric rings out to the detector edge.

    Wide ROI spread is what conditions the solve: shifts from a
    deformation scale with the ROI's position vector, so rings near the
    edge separate the ``a3*`` (projective) terms from the in-plane ones.

    Returns ``(R, 2)`` float64 ``(row, col)`` pixel centers, clipped so
    every ROI window stays ``margin`` px inside the detector.
    """
    h, w = geometry.shape
    half = roi_size / 2
    # Pattern-center pixel (invert the pixel_directions convention).
    pc_col = geometry.pcx * w - 0.5
    pc_row = h - geometry.pcy * w - 0.5
    lo_r, hi_r = half + margin, h - half - margin
    lo_c, hi_c = half + margin, w - half - margin
    if lo_r > hi_r or lo_c > hi_c:
        raise ValueError(f"roi_size {roi_size} does not fit a {h}x{w} detector")
    centers = [(np.clip(pc_row, lo_r, hi_r), np.clip(pc_col, lo_c, hi_c))]
    max_radius = min(
        pc_row - lo_r, hi_r - pc_row, pc_col - lo_c, hi_c - pc_col,
        (min(h, w) - roi_size) / 2 - margin,
    )
    if max_radius <= 0:
        raise ValueError(f"no room for ROI rings: roi_size {roi_size} on {h}x{w}")
    for ring in range(n_rings):
        radius = max_radius * (ring + 1) / n_rings
        n = per_ring[min(ring, len(per_ring) - 1)]
        # Stagger successive rings so ROIs interleave azimuthally.
        phase = math.pi / n * (ring % 2)
        for k in range(n):
            ang = 2 * math.pi * k / n + phase
            centers.append(
                (
                    np.clip(pc_row - radius * math.sin(ang), lo_r, hi_r),
                    np.clip(pc_col + radius * math.cos(ang), lo_c, hi_c),
                )
            )
    return np.asarray(centers, np.float64)


def roi_position_vectors(geometry: DetectorGeometry, centers: np.ndarray) -> np.ndarray:
    """``(R, 3)`` unnormalized screen vectors ``(x, y, D)`` of ROI centers,
    detector-plane frame, width units (the ``r`` of the shift model)."""
    h, w = geometry.shape
    c = np.asarray(centers, np.float64)
    x = (c[:, 1] + 0.5) / w - geometry.pcx
    y = (h - (c[:, 0] + 0.5)) / w - geometry.pcy
    return np.stack([x, y, np.full(len(c), geometry.dd)], axis=-1)


def _hann2(s: int) -> np.ndarray:
    wr = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(s) + 0.5) / s)
    return (wr[:, None] * wr[None, :]).astype(np.float32)


def _annular_mask(s: int, f_min: float, f_max: float | None) -> np.ndarray:
    """Fourier-domain band-pass (cycles per ROI window): kills DC and
    background gradients below ``f_min`` and, when ``f_max`` is set, the
    noise-dominated band above it."""
    f = np.fft.fftfreq(s) * s  # cycles per window
    rad = np.hypot(f[:, None], f[None, :])
    mask = rad >= f_min
    if f_max is not None:
        mask &= rad <= f_max
    return mask.astype(np.float32)


def _roi_index(centers_px: np.ndarray, roi_size: int, width: int) -> np.ndarray:
    """``(R·S·S,)`` int64 flat pixel indices of the ``(R, S, S)`` ROI windows
    around integer ``(row, col)`` centers: one gather takes the whole stack
    (the JAX package's static slices, one per ROI)."""
    half = roi_size // 2
    off = np.arange(roi_size) - half
    rows = centers_px[:, 0, None, None] + off[None, :, None]
    cols = centers_px[:, 1, None, None] + off[None, None, :]
    return (rows * width + cols).reshape(-1).astype(np.int64)


def _pixel_screen_vectors(geometry: DetectorGeometry) -> np.ndarray:
    """``(H·W, 3)`` unnormalized screen vectors ``(x, y, D)`` of every
    pixel center, detector-plane frame, width units: the full-detector
    analogue of `roi_position_vectors` (host, once per geometry)."""
    h, w = geometry.shape
    x = (np.arange(w, dtype=np.float64) + 0.5) / w - geometry.pcx
    y = (h - (np.arange(h, dtype=np.float64) + 0.5)) / w - geometry.pcy
    grid = np.stack(
        [
            np.broadcast_to(x[None, :], (h, w)),
            np.broadcast_to(y[:, None], (h, w)),
            np.full((h, w), geometry.dd),
        ],
        axis=-1,
    )
    return grid.reshape(-1, 3).astype(np.float32)


def _remap_core(
    x: torch.Tensor, f: torch.Tensor, rvec: torch.Tensor, pc: torch.Tensor
) -> torch.Tensor:
    """Warp patterns by per-pattern deformation gradients F = I + A.

    The remapped pattern evaluates the target at the screen position the
    deformation maps each pixel to, ``remap(proj(r)) = target(proj(F r))``,
    so it coincides with the REFERENCE when F matches the true deformation.
    Bilinear sampling with edge clamping: four ``torch.gather`` taps on the
    flattened image.

    Args:
        x: ``(B, H, W)`` patterns on the device (any real dtype; uint8
            widens here).
        f: ``(B, 3, 3)`` float32 deformation gradients, detector frame.
        rvec: ``(H·W, 3)`` float32 pixel screen vectors in the REFERENCE
            geometry (`_pixel_screen_vectors`).
        pc: ``(B, 3)`` float32 TARGET pattern centers ``(pcx, pcy, dd)``,
            which project the deformed direction back to its pixel (so a
            scan-varying calibration's PC shift is undone too).

    Returns ``(B, H, W)`` float32 warped patterns.
    """
    b, h, w = x.shape
    x = x.float()
    # The JAX package's einsum "bij,pj->bpi": (P, 3) @ (B, 3, 3)ᵀ, at full
    # f32 (the caller holds `full_f32_matmul`).
    s = torch.matmul(rvec, f.transpose(1, 2))
    z = s[..., 2].clamp_min(1e-6)
    u = s[..., 0] * (pc[:, 2, None] / z)
    v = s[..., 1] * (pc[:, 2, None] / z)
    col = ((u + pc[:, 0, None]) * w - 0.5).clamp(0.0, w - 1.0)
    row = (h - (v + pc[:, 1, None]) * w - 0.5).clamp(0.0, h - 1.0)
    r0 = row.floor().long()
    c0 = col.floor().long()
    r1 = (r0 + 1).clamp_max(h - 1)
    c1 = (c0 + 1).clamp_max(w - 1)
    fr = row - r0
    fc = col - c0
    flat = x.reshape(b, h * w)

    def tap(rr, cc):
        return torch.gather(flat, 1, rr * w + cc)

    out = (
        tap(r0, c0) * (1 - fr) * (1 - fc)
        + tap(r0, c1) * (1 - fr) * fc
        + tap(r1, c0) * fr * (1 - fc)
        + tap(r1, c1) * fr * fc
    )
    return out.reshape(b, h, w)


def _as_pc_array(geometry: DetectorGeometry, n: int, pc: np.ndarray | None) -> np.ndarray:
    """``(B, 3)`` float32 per-pattern ``(pcx, pcy, dd)``: the geometry's
    fixed PC broadcast, or the caller's per-pattern field validated."""
    if pc is None:
        return np.broadcast_to(
            np.asarray([geometry.pcx, geometry.pcy, geometry.dd], np.float32), (n, 3)
        ).copy()
    out = np.asarray(pc, np.float32)
    if out.shape == (3,):
        return np.broadcast_to(out, (n, 3)).copy()
    if out.shape != (n, 3):
        raise ValueError(f"pc must be ({n}, 3) or (3,), got {out.shape}")
    return out


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host chunk on ``device``: pinned and queued on a card, so the host
    goes on to enqueue the chunk's work instead of waiting for the stream."""
    t = torch.from_numpy(np.array(host))  # a writable copy (memmap slabs are read-only)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _run_chunk(fn, arrays, tables, device: torch.device, mesh):
    """``fn(*chunk arrays, *tables)`` on ``device``, or per mesh device
    (`parallel.mesh.map_blocks`; ``tables`` holds one tuple per device)."""
    if mesh is None:
        return fn(*(_upload(a, device) for a in arrays), *tables[0])
    return map_blocks(fn, arrays, tables, mesh)


def _pad_last(a: np.ndarray, size: int) -> np.ndarray:
    """``a`` padded to ``size`` rows by repeating its last row (the last
    chunk keeps the shape, and the FFT plans, of the others)."""
    n = len(a)
    if n >= size:
        return a
    return np.concatenate([a, np.repeat(a[-1:], size - n, axis=0)])


def remap_patterns(
    patterns: np.ndarray,
    deformation: np.ndarray,
    geometry: DetectorGeometry,
    chunk: int = 128,
    mesh=None,
    pc: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Re-project patterns through deformation gradients ``I + A``.

    The CrossCourt-style remapping step: a pattern deformed by ``A`` remaps
    onto its reference when passed back through ``F = I + A`` (exact for
    the projective model, not just to first order). `hrebsd_map`'s
    iterative passes chain this warp into `measure_roi_shifts`; exposed
    for standalone use.

    Args:
        patterns: ``(B, H, W)`` patterns (uint8 ships raw).
        deformation: ``(B, 3, 3)`` or ``(3, 3)`` displacement gradients
            ``A`` (any gauge: the warp is projective).
        geometry: the detector the patterns were captured on.
        chunk: patterns per device pass.
        mesh: optional `parallel.Mesh`: each chunk shards over its
            devices; ``chunk`` must divide by the mesh size.
        pc: optional ``(B, 3)`` per-pattern ``(pcx, pcy, dd)``: each
            TARGET's own PC; output pixels stay in ``geometry``'s frame.
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.

    Returns ``(B, H, W)`` float32 warped patterns (host numpy).
    """
    device = chunk_device(mesh, device, chunk)
    x = np.asarray(patterns)
    if x.dtype != np.uint8:  # uint8 ships raw; the device widens it
        x = x.astype(np.float32, copy=False)
    if x.ndim != 3:
        raise ValueError(f"expected (B, H, W) patterns, got {x.shape}")
    a = np.asarray(deformation, np.float64)
    if a.shape == (3, 3):
        a = np.broadcast_to(a[None], (len(x), 3, 3))
    if a.shape != (len(x), 3, 3):
        raise ValueError(f"deformation must be ({len(x)}, 3, 3) or (3, 3), got {a.shape}")
    f = (np.eye(3) + a).astype(np.float32)
    pc_arr = _as_pc_array(geometry, len(x), pc)
    base = torch.from_numpy(_pixel_screen_vectors(geometry)).to(device)
    tables = [(base,)] if mesh is None else replicate((base,), mesh)

    def warp(xc, fc, pcc, base):
        return _remap_core(xc, fc, base, pcc)

    outs = []
    with torch.no_grad(), full_f32_matmul():
        for start in range(0, len(x), chunk):
            n = len(x[start : start + chunk])
            arrays = [_pad_last(arr[start : start + chunk], chunk) for arr in (x, f, pc_arr)]
            outs.append(_run_chunk(warp, arrays, tables, device, mesh)[:n])
        return torch.cat(outs).cpu().numpy()


def _xcorr_shifts(
    ref: torch.Tensor,
    x: torch.Tensor,
    hann: torch.Tensor,
    fmask: torch.Tensor,
    roi_index: torch.Tensor,
    roi_size: int,
    upsample: int,
    window_px: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched sub-pixel shift measurement of one chunk: ROI extraction,
    windowed band-passed FFT cross-correlation and matrix-DFT sub-pixel
    localization, all on the device.

    Args:
        ref: ``(H, W)`` reference pattern on the device.
        x: ``(B, H, W)`` target patterns on the device (uint8 widens here).
        hann / fmask: ``(S, S)`` window and Fourier band-pass.
        roi_index: ``(R·S·S,)`` flat pixel indices (`_roi_index`).
        upsample: sub-pixel factor kappa (peak located to ~1/kappa px).
        window_px: half-width of the fine search window around the coarse
            peak, pixels.

    Returns ``(shifts (B, R, 2) f32 (d_row, d_col) px, quality (B, R))``.
    Call inside `device.full_f32_matmul`.
    """
    b = x.shape[0]
    s = roi_size
    n_roi = roi_index.numel() // (s * s)
    # uint8 frames ship raw and widen here (the XCF is affine-invariant, so
    # no /255 is needed).
    ref_rois = ref.reshape(-1)[roi_index].float().reshape(n_roi, s, s)
    tgt_rois = x.reshape(b, -1)[:, roi_index].float().reshape(b, n_roi, s, s)
    # The reference spectrum is batch-invariant: taken once on the (R, S,
    # S) stack and broadcast by the cross-spectrum product.
    refz = ref_rois - ref_rois.mean(dim=(-2, -1), keepdim=True)
    tgtz = tgt_rois - tgt_rois.mean(dim=(-2, -1), keepdim=True)
    fr = torch.fft.fft2(refz * hann) * fmask  # (R, S, S)
    ft = torch.fft.fft2(tgtz * hann) * fmask  # (B, R, S, S)
    cross = ft * fr.conj()[None]  # corr(s) = sum_p ref(p)·tgt(p+s)
    corr = torch.fft.ifft2(cross).real  # (B, R, S, S), index = shift mod S
    # NCC-style quality: peak / (||ref||·||tgt||) of the filtered, windowed
    # panels (Parseval on the masked spectra).
    norm = torch.sqrt(
        (fr.abs() ** 2).sum(dim=(-2, -1))[None] * (ft.abs() ** 2).sum(dim=(-2, -1))
    ).reshape(b * n_roi) / (s * s)
    cross = cross.reshape(b * n_roi, s, s)
    flat = corr.reshape(b * n_roi, s * s)
    coarse = flat.argmax(dim=-1)
    quality = flat.gather(1, coarse[:, None])[:, 0]
    quality = (quality / norm.clamp_min(1e-12)).clamp(0.0, 1.0)
    row0 = torch.div(coarse, s, rounding_mode="floor").float()
    col0 = (coarse % s).float()
    # Unwrap circular indices to signed shifts.
    row0 = torch.where(row0 > s / 2, row0 - s, row0)
    col0 = torch.where(col0 > s / 2, col0 - s, col0)

    # Matrix-DFT upsampling (Guizar-Sicairos 2008): the inverse DFT of the
    # cross spectrum on a (U, U) fine grid centered at the coarse peak, two
    # small complex products per ROI and no zoomed image.
    u = 2 * int(round(window_px * upsample)) + 1
    k = torch.fft.fftfreq(s, device=x.device) * s  # signed integer frequencies
    offs = (torch.arange(u, dtype=torch.float32, device=x.device) - (u - 1) / 2) / upsample
    sr = row0[:, None] + offs[None, :]  # (N, U)
    sc = col0[:, None] + offs[None, :]
    er = torch.exp((2j * math.pi / s) * sr[..., None] * k[None, None, :])
    ec = torch.exp((2j * math.pi / s) * sc[..., None] * k[None, None, :])
    # corr_up[a, b] = sum_{uv} er[a, u] cross[u, v] ec[b, v]: the JAX
    # package's einsum "nau,nuv,nbv->nab" as two batched complex64 `matmul`s
    # (cuBLAS's batched CGEMM on a card), at full f32.
    corr_up = torch.matmul(torch.matmul(er, cross), ec.transpose(1, 2)).real
    up = corr_up.reshape(corr_up.shape[0], u * u)
    fine = up.argmax(dim=-1)
    # Parabolic interpolation between fine-grid samples removes the
    # 1/upsample quantization floor (the projective a3* terms move the ROI
    # ring by only ~0.1 px). The three row and column taps are gathered.
    ia = torch.div(fine, u, rounding_mode="floor").clamp(1, u - 2)
    ib = (fine % u).clamp(1, u - 2)
    taps = torch.arange(-1, 2, device=x.device)
    c_r = up.gather(1, (ia[:, None] + taps) * u + ib[:, None])
    c_c = up.gather(1, ia[:, None] * u + ib[:, None] + taps)

    def parab(cm, c0_, cp):
        denom = cm - 2.0 * c0_ + cp
        return torch.where(denom.abs() > 1e-30, 0.5 * (cm - cp) / denom, 0.0)

    da = parab(c_r[:, 0], c_r[:, 1], c_r[:, 2]).clamp(-0.5, 0.5)
    db = parab(c_c[:, 0], c_c[:, 1], c_c[:, 2]).clamp(-0.5, 0.5)
    fr_off = (ia.float() + da - (u - 1) / 2) / upsample
    fc_off = (ib.float() + db - (u - 1) / 2) / upsample
    shifts = torch.stack([row0 + fr_off, col0 + fc_off], dim=-1)
    return shifts.reshape(b, n_roi, 2), quality.reshape(b, n_roi)


def measure_roi_shifts(
    reference: np.ndarray,
    patterns: np.ndarray,
    centers: np.ndarray,
    roi_size: int = 64,
    upsample: int = 20,
    window_px: float = 1.0,
    f_min: float = 1.5,
    f_max: float | None = None,
    chunk: int = 128,
    mesh=None,
    deformation: np.ndarray | None = None,
    geometry: DetectorGeometry | None = None,
    pc: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Measure sub-pixel ROI shifts of every pattern against a reference.

    Args:
        reference: ``(H, W)`` reference pattern (same grain, low strain).
        patterns: ``(B, H, W)`` target patterns.
        centers: ``(R, 2)`` ROI ``(row, col)`` pixel centers
            (`default_roi_centers`).
        roi_size: ROI window edge, px (a power of two keeps FFTs fast).
        upsample: sub-pixel factor: shifts resolve to ~1/upsample px.
        window_px: fine-search half-width around the coarse peak, px.
        f_min / f_max: annular Fourier band-pass, cycles per window.
        chunk: patterns per device pass; the last chunk is padded by
            repeating its last pattern.
        mesh: optional `parallel.Mesh`: each chunk shards over its
            devices, the windows and the reference copied to each;
            ``chunk`` must divide by the mesh size.
        deformation: optional ``(B, 3, 3)`` displacement gradients: each
            pattern is first remapped through ``I + A`` on the device
            (`_remap_core`, in the same pass, no host round trip), so the
            shifts are the RESIDUAL after that estimate. Needs
            ``geometry``.
        geometry: the `DetectorGeometry` (only needed with
            ``deformation``).
        pc: optional ``(B, 3)`` per-pattern ``(pcx, pcy, dd)`` for the
            remap warp; default: the geometry's fixed PC.
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.

    Returns:
        ``(shifts (B, R, 2) float64 (d_row, d_col) px, quality (B, R))``.
    """
    device = chunk_device(mesh, device, chunk)
    x = np.asarray(patterns)
    if x.dtype != np.uint8:  # uint8 ships raw; the device widens it
        x = x.astype(np.float32, copy=False)
    if x.ndim != 3:
        raise ValueError(f"expected (B, H, W) patterns, got {x.shape}")
    ref = np.asarray(reference)
    if ref.dtype != np.uint8:
        ref = ref.astype(np.float32, copy=False)
    if ref.shape != x.shape[1:]:
        raise ValueError(f"reference {ref.shape} does not match patterns {x.shape[1:]}")
    centers = np.asarray(centers, np.float64)
    half = roi_size // 2
    rint = np.rint(centers).astype(int)
    if (
        rint.min(initial=roi_size) < half
        or (rint[:, 0] + roi_size - half > x.shape[1]).any()
        or (rint[:, 1] + roi_size - half > x.shape[2]).any()
    ):
        raise ValueError("an ROI window falls outside the detector")

    f_mats = None
    if deformation is not None:
        if geometry is None:
            raise ValueError("deformation remapping requires geometry")
        a = np.asarray(deformation, np.float64)
        if a.shape != (len(x), 3, 3):
            raise ValueError(f"deformation must be ({len(x)}, 3, 3), got {a.shape}")
        f_mats = (np.eye(3) + a).astype(np.float32)
        pc_arr = _as_pc_array(geometry, len(x), pc)
        base = torch.from_numpy(_pixel_screen_vectors(geometry)).to(device)
    else:
        base = None

    hann = torch.from_numpy(_hann2(roi_size)).to(device)
    fmask = torch.from_numpy(_annular_mask(roi_size, f_min, f_max)).to(device)
    roi_index = torch.from_numpy(_roi_index(rint, roi_size, x.shape[2])).to(device)
    ref_dev = torch.from_numpy(np.array(ref)).to(device)
    tables = (ref_dev, hann, fmask, roi_index, base)
    tables = [tables] if mesh is None else replicate(tables, mesh)

    def shifts_of(xc, *rest):
        if f_mats is not None:
            fc, pcc, ref_t, hann_t, fmask_t, roi_t, base_t = rest
            # Chained on the device: the warped chunk never visits host.
            xc = _remap_core(xc, fc, base_t, pcc)
        else:
            ref_t, hann_t, fmask_t, roi_t, _ = rest
        return _xcorr_shifts(ref_t, xc, hann_t, fmask_t, roi_t, roi_size, upsample, window_px)

    out_s, out_q = [], []
    with torch.no_grad(), full_f32_matmul():
        for start in range(0, len(x), chunk):
            n = len(x[start : start + chunk])
            sources = (x,) if f_mats is None else (x, f_mats, pc_arr)
            arrays = [_pad_last(arr[start : start + chunk], chunk) for arr in sources]
            s_dev, q_dev = _run_chunk(shifts_of, arrays, tables, device, mesh)
            out_s.append(s_dev[:n])
            out_q.append(q_dev[:n])
        shifts = torch.cat(out_s).cpu().numpy().astype(np.float64)
        quality = torch.cat(out_q).cpu().numpy().astype(np.float64)
    return shifts, quality


def _design_matrix(r_vecs: np.ndarray, dd) -> np.ndarray:
    """``(..., R, 2, 8)`` shift model in the gauge ``a33 = 0``: unknowns
    ``p = (a11, a12, a13, a21, a22, a23, a31, a32)``,
    ``q_x = a11 x + a12 y + a13 D − (x/D)(a31 x + a32 y)`` and the y row
    alike (the first-order gnomonic re-projection). ``dd`` broadcasts
    against ``r_vecs[..., 0]``."""
    x, y = r_vecs[..., 0], r_vecs[..., 1]
    dd = np.broadcast_to(np.asarray(dd, np.float64), x.shape)
    m = np.zeros(x.shape + (2, 8))
    m[..., 0, 0] = x
    m[..., 0, 1] = y
    m[..., 0, 2] = dd
    m[..., 0, 6] = -x * x / dd
    m[..., 0, 7] = -x * y / dd
    m[..., 1, 3] = x
    m[..., 1, 4] = y
    m[..., 1, 5] = dd
    m[..., 1, 6] = -y * x / dd
    m[..., 1, 7] = -y * y / dd
    return m


def _solve_core(
    m: torch.Tensor, q_obs: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted batched normal equations: m (R, 2, 8), q_obs (B, R, 2),
    w (B, R) → (p (B, 8), rms residual (B,)), all float32 on one device.
    Call inside `device.full_f32_matmul`."""
    mw = m.reshape(-1, 8)  # (2R, 8)
    qf = q_obs.reshape(q_obs.shape[0], -1)  # (B, 2R)
    wf = w.repeat_interleave(2, dim=-1)  # (B, 2R)
    # (B, 8, 8) = Mᵀ W M, the einsum "ri,br,rj->bij" as one batched
    # `matmul`; the ridge keeps a degenerate solve (few live ROIs) solvable.
    ata = torch.matmul(mw.T[None] * wf[:, None, :], mw)
    ata = ata + 1e-12 * torch.eye(8, device=m.device)
    atb = torch.matmul(wf * qf, mw)  # "ri,br,br->bi"
    # solve_ex: the checked solve would wait for the device to read its info.
    p = torch.linalg.solve_ex(ata, atb[..., None])[0][..., 0]
    pred = torch.matmul(p, mw.T)  # "ri,bi->br"
    wsum = wf.sum(dim=-1).clamp_min(1e-12)
    rms = torch.sqrt((wf * (pred - qf) ** 2).sum(dim=-1) / wsum)
    return p, rms


def solve_deformation(
    shifts_px: np.ndarray,
    quality: np.ndarray,
    geometry: DetectorGeometry,
    centers: np.ndarray,
    min_quality: float = 0.0,
    pc: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Least-squares displacement-gradient tensors from ROI shifts.

    Args:
        shifts_px: ``(B, R, 2)`` measured ``(d_row, d_col)`` pixel shifts.
        quality: ``(B, R)`` per-ROI weights (XCF peak heights).
        geometry / centers: the layout the shifts were measured on.
        min_quality: ROIs below this weight are dropped from the solve.
        pc: optional ``(B, 3)`` per-pattern ``(pcx, pcy, dd)``: each
            TARGET's own pattern center, with ``geometry`` holding the
            REFERENCE's. The apparent shift ``q_pc = (δpcx + u·δdd/D,
            δpcy + v·δdd/D)`` at ROI plane position ``(u, v)`` is
            subtracted before the solve (left in, a scan's PC gradient
            aliases into a phantom strain gradient).
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        ``(a (B, 3, 3) float64 in the a33 = 0 gauge, rms residual (B,)
        in width units)``.
    """
    device = resolve_device(device)
    s = np.asarray(shifts_px, np.float64)
    w = np.asarray(quality, np.float64)
    w = np.where(w >= min_quality, w, 0.0)
    # Pixel (row, col) shifts → detector-frame (x, y) in width units: x
    # follows columns, y is the NEGATED row direction (rows grow down).
    width = geometry.shape[1]
    q_xy = np.stack([s[..., 1], -s[..., 0]], axis=-1) / width
    r_vecs = roi_position_vectors(geometry, centers)
    if pc is not None:
        pc_arr = _as_pc_array(geometry, len(s), pc).astype(np.float64)
        delta = pc_arr - np.asarray([geometry.pcx, geometry.pcy, geometry.dd], np.float64)
        u, v = r_vecs[:, 0], r_vecs[:, 1]
        scale = delta[:, 2, None] / geometry.dd  # δdd dilation per unit
        q_pc = np.stack(
            [delta[:, 0, None] + u[None, :] * scale, delta[:, 1, None] + v[None, :] * scale],
            axis=-1,
        )
        q_xy = q_xy - q_pc
    m = _design_matrix(r_vecs, geometry.dd)
    with torch.no_grad(), full_f32_matmul():
        p, rms = _solve_core(
            *(torch.from_numpy(np.asarray(arr, np.float32)).to(device) for arr in (m, q_xy, w))
        )
        p = p.cpu().numpy().astype(np.float64)
        rms = rms.cpu().numpy().astype(np.float64)
    a = np.zeros((len(p), 3, 3))
    a[:, 0, :] = p[:, 0:3]
    a[:, 1, :] = p[:, 3:6]
    a[:, 2, 0:2] = p[:, 6:8]
    return a, rms


def _stiffness_tensor(voigt: np.ndarray) -> np.ndarray:
    """(6, 6) Voigt stiffness → full (3, 3, 3, 3) tensor."""
    pairs = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]
    c = np.zeros((3, 3, 3, 3))
    for a_v, (i, j) in enumerate(pairs):
        for b_v, (k, l) in enumerate(pairs):
            v = voigt[a_v, b_v]
            for ii, jj in ((i, j), (j, i)):
                for kk, ll in ((k, l), (l, k)):
                    c[ii, jj, kk, ll] = v
    return c


def _rotate_stiffness(g: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """``(B, 3, 3, 3, 3)`` stiffness in the detector frame: the JAX
    package's 5-operand einsum "bia,bjc,bkd,ble,acde->bijkl", one index at a
    time (four batched products, each at full f32 inside
    `device.full_f32_matmul`)."""
    t = torch.einsum("acde,ble->bacdl", c0, g)
    t = torch.einsum("bacdl,bkd->backl", t, g)
    t = torch.einsum("backl,bjc->bajkl", t, g)
    return torch.einsum("bajkl,bia->bijkl", t, g)


def _traction_free(
    a_gauge: torch.Tensor, c4_det: torch.Tensor, normal: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Restore the hydrostatic gauge: find λ with σ_nn(sym(A) + λI) = 0.

    a_gauge: (B, 3, 3); c4_det: (B, 3, 3, 3, 3) stiffness, detector frame;
    normal: (3,) unit sample normal; float32 on one device. Returns
    (a (B, 3, 3), strain, stress). Call inside `device.full_f32_matmul`.
    """
    b = a_gauge.shape[0]
    eps0 = 0.5 * (a_gauge + a_gauge.transpose(-1, -2))
    # "bijkl,bkl->bij" as a batched (9, 9) @ (9,) product.
    sig0 = torch.matmul(c4_det.reshape(b, 9, 9), eps0.reshape(b, 9, 1)).reshape(b, 3, 3)
    eye = torch.eye(3, device=a_gauge.device)
    sig_i = c4_det.diagonal(dim1=-2, dim2=-1).sum(dim=-1)  # σ(I) = C : I
    num = torch.einsum("i,bij,j->b", normal, sig0, normal)
    den = torch.einsum("i,bij,j->b", normal, sig_i, normal)
    lam = -num / torch.where(den.abs() < 1e-12, torch.ones_like(den), den)
    a = a_gauge + lam[:, None, None] * eye
    strain = eps0 + lam[:, None, None] * eye
    stress = sig0 + lam[:, None, None] * sig_i
    return a, strain, stress


def von_mises_strain(strain: np.ndarray) -> np.ndarray:
    """Equivalent (von Mises) strain of ``(..., 3, 3)`` tensors."""
    e = np.asarray(strain)
    dev = e - np.trace(e, axis1=-2, axis2=-1)[..., None, None] / 3 * np.eye(3)
    return np.sqrt(2.0 / 3.0 * np.einsum("...ij,...ij->...", dev, dev))


def hrebsd_map(
    patterns: np.ndarray,
    reference: np.ndarray,
    geometry: DetectorGeometry,
    centers: np.ndarray | None = None,
    roi_size: int = 64,
    upsample: int = 20,
    stiffness: np.ndarray | None = None,
    orientations: np.ndarray | None = None,
    f_min: float = 1.5,
    f_max: float | None = None,
    min_quality: float = 0.1,
    chunk: int = 128,
    mesh=None,
    remap_iterations: int = 1,
    calibration=None,
    scan_xy: np.ndarray | None = None,
    pc: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> HrebsdResult:
    """Full HR-EBSD pipeline: ROI shifts → deformation → strain/rotation.

    Args:
        patterns: ``(B, H, W)`` patterns (one grain, the reference's).
        reference: ``(H, W)`` reference pattern (strain is RELATIVE to it).
        geometry: detector geometry of the REFERENCE pattern: the pattern
            center must be accurate (PC error aliases into phantom
            strain). With ``calibration``, pass
            ``calibration.geometry_at(ref_scan_xy)``.
        centers: ``(R, 2)`` ROI centers; default `default_roi_centers`.
        roi_size / upsample / f_min / f_max: see `measure_roi_shifts`.
        stiffness: (6, 6) Voigt stiffness (crystal frame, e.g.
            `crystal.cubic_stiffness`) enabling the traction-free gauge and
            stress output; None leaves the ``a33 = 0`` gauge.
        orientations: ``(B, 4)`` or ``(4,)`` scalar-first crystal→detector
            quaternions rotating the stiffness per pattern; None uses the
            crystal frame as the detector frame.
        min_quality: drop ROIs whose XCF peak falls below this.
        chunk: patterns per device pass.
        mesh: optional `parallel.Mesh`, forwarded to `measure_roi_shifts`
            (the shift measurement shards; the 8x8 solves and the closure
            run on the first device).
        remap_iterations: iterative remapping passes after the
            first-order solve: remap each pattern through ``F = I + A``,
            re-correlate, compose ``F ← F (I + A_res)``, accepted PER
            PATTERN only where it lowers that pattern's fit residual.
            ``shifts_px``/``quality``/``residual_px`` report each pattern's
            accepted pass; ``0`` disables.
        calibration: optional `sim.ScanCalibration`: with ``scan_xy``
            every pattern's design matrix and remap warp use ITS OWN
            pattern center.
        scan_xy: ``(B, 2)`` scan positions in the calibration's units
            (required with ``calibration``).
        pc: alternative to ``calibration``: an explicit ``(B, 3)``
            per-pattern ``(pcx, pcy, dd)`` field.
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.
    """
    device = chunk_device(mesh, device, chunk)
    x = np.asarray(patterns)  # uint8 passes through to the device's widening
    if calibration is not None:
        if pc is not None:
            raise ValueError("give either calibration or pc, not both")
        if scan_xy is None:
            raise ValueError("calibration requires scan_xy positions")
        s_xy = np.asarray(scan_xy, np.float64)
        if s_xy.shape != (len(x), 2):
            raise ValueError(f"scan_xy must be ({len(x)}, 2), got {s_xy.shape}")
        pc = calibration.pc_at(s_xy)
    if pc is not None:
        pc = _as_pc_array(geometry, len(x), pc)
    if centers is None:
        centers = default_roi_centers(geometry, roi_size=roi_size)
    measure = dict(
        roi_size=roi_size, upsample=upsample, f_min=f_min, f_max=f_max, chunk=chunk,
        mesh=mesh, device=device,
    )
    shifts, quality = measure_roi_shifts(reference, x, centers, **measure)
    a_gauge, rms = solve_deformation(
        shifts, quality, geometry, centers, min_quality=min_quality, pc=pc, device=device
    )
    eye = np.eye(3)
    f_est = eye + a_gauge
    for _ in range(remap_iterations):
        shifts2, quality2 = measure_roi_shifts(
            reference, x, centers, deformation=f_est - eye, geometry=geometry, pc=pc,
            **measure,
        )
        # No pc= here: the warp projected each target back through its OWN
        # PC into the reference frame, so the residual carries no PC shift.
        a_res, rms2 = solve_deformation(
            shifts2, quality2, geometry, centers, min_quality=min_quality, device=device
        )
        # G = I + A_res, measured between the reference and the remapped
        # pattern, composes on the RIGHT: F_true = F_est G.
        f_new = f_est @ (eye + a_res)
        # Per-pattern acceptance: the remap wins only where it lowers the
        # fit residual; near-reference patterns would only pick up the
        # warp's bilinear-resampling noise, so they keep their pass.
        accept = rms2 < rms
        f_est = np.where(accept[:, None, None], f_new, f_est)
        shifts = np.where(accept[:, None, None], shifts2, shifts)
        quality = np.where(accept[:, None], quality2, quality)
        rms = np.where(accept, rms2, rms)
        # Back to the a33 = 0 gauge (the projective warp cannot see the
        # hydrostatic direction, so composition drifts freely along it).
        a_gauge = f_est - eye
        a_gauge = a_gauge - a_gauge[:, 2, 2][:, None, None] * eye
        f_est = eye + a_gauge
        if not accept.any():
            break

    stress = None
    if stiffness is not None:
        c0 = torch.from_numpy(_stiffness_tensor(np.asarray(stiffness, np.float64))).float()
        b = len(a_gauge)
        if orientations is None:
            g = torch.eye(3).expand(b, 3, 3)
        else:
            qo = torch.from_numpy(np.asarray(orientations, np.float32))
            if qo.ndim == 1:
                qo = qo[None].expand(b, 4)
            g = quat_to_matrix(qo)  # crystal → detector
        if geometry.tilt:
            t = math.radians(geometry.tilt)
            normal = torch.tensor([0.0, -math.sin(t), math.cos(t)], dtype=torch.float32)
        else:
            normal = torch.tensor([0.0, 0.0, 1.0])
        with torch.no_grad(), full_f32_matmul():
            c4 = _rotate_stiffness(g.to(device), c0.to(device))
            a_dev, strain_dev, stress_dev = _traction_free(
                torch.from_numpy(a_gauge.astype(np.float32)).to(device), c4, normal.to(device)
            )
            a = a_dev.cpu().numpy().astype(np.float64)
            strain = strain_dev.cpu().numpy().astype(np.float64)
            stress = stress_dev.cpu().numpy().astype(np.float64)
    else:
        a = a_gauge
        strain = 0.5 * (a + np.swapaxes(a, -1, -2))

    skew = 0.5 * (a - np.swapaxes(a, -1, -2))
    rotation = np.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], axis=-1)
    rot_deg = np.degrees(np.linalg.norm(rotation, axis=-1))
    width = geometry.shape[1]
    return HrebsdResult(
        a=a,
        strain=strain,
        rotation=rotation,
        rotation_deg=rot_deg,
        stress=stress,
        shifts_px=shifts,
        quality=quality,
        residual_px=rms * width,
    )
