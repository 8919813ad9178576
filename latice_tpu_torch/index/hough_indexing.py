"""Hough-based orientation indexing: detected bands → orientation.

The port of ``latice_tpu.index.hough_indexing``, the vendor OIM/Esprit/AZtec
algorithm beside the latent `index.pipeline` and the pattern `index.pattern_di`:

1. `data.hough.BandDetector` finds the k strongest bands as Radon peaks
   ``(theta, rho)``.
2. `band_plane_normals` (host float64) inverts the gnomonic detector model:
   each band line, with the beam source, spans the Kikuchi band plane.
3. Grid voting: a fundamental-zone orientation grid
   (`crystal.sample_fundamental_zone`) is expanded once into rotated
   reflector normals; every pattern's measured normals score every grid
   point in chunks of ``grid_chunk`` (one product and masked reductions
   per chunk).
4. Davenport's q-method refines the top candidates: each band takes its
   nearest rotated reflector and the rotation is the principal eigenvector
   of the 4x4 Davenport matrix, by the seeded power iteration
   (`solve_wahba`), for a fixed ``refine_iters`` rounds; the refined
   candidates are re-ranked by a soft band credit.

Every geometric product runs in full f32 (`device.full_f32_matmul`): bf16
or TF32 rounding is the size of 1 - cos(5°). Selections the JAX package
made with one-hot products are plain indexing here; they give the same
values.

With ``mesh=`` the orientation grid is the plane's dictionary: its chunks
shard over the mesh's devices, each device votes over and refines its own
block's top candidates, and the per-device winners merge on the first
device by the same soft band-credit rank (ties to the lowest device).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.crystal import reduce_to_fundamental_zone, sample_fundamental_zone
from latice_tpu_torch.data.hough import BandDetection, BandDetector
from latice_tpu_torch.device import full_f32_matmul
from latice_tpu_torch.index.knn import topk_lower_index_first
from latice_tpu_torch.parallel.mesh import check_mesh_device, replicate
from latice_tpu_torch.sim.geometry import DetectorGeometry
from latice_tpu_torch.sim.kinematical import _quat_rotate

__all__ = [
    "HoughIndexResult",
    "HoughIndexer",
    "MultiPhaseHoughIndexer",
    "MultiPhaseHoughResult",
    "band_plane_normals",
    "solve_wahba",
]


def band_plane_normals(
    theta_deg: np.ndarray,
    rho_px: np.ndarray,
    geometry: DetectorGeometry,
) -> np.ndarray:
    """Unit normals of the Kikuchi band planes, detector frame.

    A detected Radon line (``theta``, ``rho``: `data.hough` conventions —
    pixel coordinates centered on the image, x right / y up) lies in the
    detector plane ``z = dd`` of the gnomonic model (`sim.geometry`: the
    beam source sits at the origin, pcx/pcy offset the pixel grid). The
    band's *plane* contains that line and the source, so its normal is the
    cross product of the line's foot point ``P0`` (3-D) with the line
    direction ``t = (-sin θ, cos θ, 0)``:

        n ∝ P0 × t = (−dd·cosθ, −dd·sinθ, ρ/W + cx0·cosθ + cy0·sinθ)

    with ``cx0 = 1/2 − pcx``, ``cy0 = H/(2W) − pcy`` the image-center
    offset from the pattern center in detector-width units and ``ρ/W`` the
    Radon distance rescaled from pixels. Detector tilt rotates the normal
    exactly as `sim.geometry.pixel_directions` rotates pixel directions.

    The sign of a plane normal is inherently ambiguous (a band is a plane,
    not a direction); consumers must compare via ``|dot|``.

    Args:
        theta_deg / rho_px: any matching shape (e.g. ``(B, k)``).
        geometry: the detector model the patterns were captured with.

    Returns:
        ``theta_deg.shape + (3,)`` float64 unit normals.
    """
    h, w = geometry.shape
    th = np.radians(np.asarray(theta_deg, np.float64))
    rho = np.asarray(rho_px, np.float64) / w
    cx0 = 0.5 - geometry.pcx
    cy0 = h / (2.0 * w) - geometry.pcy
    ct, st = np.cos(th), np.sin(th)
    n = np.stack(
        [
            -geometry.dd * ct,
            -geometry.dd * st,
            rho + cx0 * ct + cy0 * st,
        ],
        axis=-1,
    )
    if geometry.tilt:
        t = math.radians(geometry.tilt)
        rot = np.array(
            [
                [1.0, 0.0, 0.0],
                [0.0, math.cos(t), -math.sin(t)],
                [0.0, math.sin(t), math.cos(t)],
            ]
        )
        n = n @ rot.T
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def solve_wahba(
    b_mat: torch.Tensor,
    init: torch.Tensor | None = None,
    iterations: int = 64,
) -> torch.Tensor:
    """Davenport q-method: optimal rotation from a cross-covariance stack.

    Given ``b_mat (..., 3, 3)`` = Σᵢ wᵢ·nᵢ·cᵢᵀ over paired unit vectors
    (``n`` observed in the detector frame, ``c`` in the crystal frame),
    returns the scalar-first unit quaternion of the proper rotation R
    (crystal → detector) maximizing Σ wᵢ·nᵢᵀ·R·cᵢ: the principal
    eigenvector of the 4×4 Davenport matrix. The q-method solves the
    passive convention, whose quaternion is the conjugate of the active one
    used throughout the package; the conjugation below converts.

    Args:
        init: optional ``(..., 4)`` scalar-first ACTIVE quaternion near the
            solution. With it, the eigenvector comes from the shifted power
            iteration seeded at ``init``, as ``ceil(log2(iterations))``
            squarings of the normalized shifted matrix; the shift
            ``‖K‖_F + ε`` ≥ ρ(K) makes the iteration converge to the most
            positive eigenvalue. It is valid only from a seed in the right
            basin. Without ``init`` the exact `torch.linalg.eigh` runs: the
            solve for cold starts.
    """
    tr = b_mat.diagonal(dim1=-2, dim2=-1).sum(-1)
    z = torch.stack(
        [
            b_mat[..., 1, 2] - b_mat[..., 2, 1],
            b_mat[..., 2, 0] - b_mat[..., 0, 2],
            b_mat[..., 0, 1] - b_mat[..., 1, 0],
        ],
        dim=-1,
    )
    s = b_mat + b_mat.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=b_mat.dtype, device=b_mat.device)
    lower = s - tr[..., None, None] * eye3
    top = torch.cat([tr[..., None, None], z[..., None, :]], dim=-1)
    bottom = torch.cat([z[..., :, None], lower], dim=-1)
    k4 = torch.cat([top, bottom], dim=-2)
    if init is None:
        _, vecs = torch.linalg.eigh(k4)
        q = vecs[..., -1]  # the largest eigenvalue's eigenvector
    else:
        v = _conjugate(init)  # active → passive seed
        # The Frobenius norm bounds the spectral radius; ε keeps a zero K
        # (a fully masked fit, which callers gate) at the seed.
        shift = torch.sqrt((k4 * k4).sum(dim=(-2, -1), keepdim=True)) + 1e-6
        m = k4 + shift * torch.eye(4, dtype=b_mat.dtype, device=b_mat.device)
        with full_f32_matmul():
            for _ in range(max(1, math.ceil(math.log2(max(iterations, 2))))):
                m = m @ m
                m = m / torch.sqrt((m * m).sum(dim=(-2, -1), keepdim=True)).clamp(min=1e-30)
            v = (m @ v[..., None])[..., 0]
        q = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-30)
    # Passive → active, then the canonical sign (scalar part ≥ 0).
    q = _conjugate(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def _conjugate(q: torch.Tensor) -> torch.Tensor:
    """``(w, -x, -y, -z)``, built on the device (a constant copied from the
    host would hold the host until the device caught up)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


class HoughIndexResult(NamedTuple):
    """Per-pattern Hough-indexing solution (host numpy)."""

    quaternions: np.ndarray  # (B, 4) scalar-first, fundamental zone
    eulers_deg: np.ndarray  # (B, 3) zxz Euler degrees
    fit_deg: np.ndarray  # (B,) weighted mean band residual, degrees
    n_matched: np.ndarray  # (B,) bands within tolerance of a reflector
    vote_score: np.ndarray  # (B,) winning grid candidate's vote
    success: np.ndarray  # (B,) bool, >= min_bands matched
    bands: BandDetection  # raw detection (theta/rho/strength/iq)
    band_score: np.ndarray | None = None  # (B,) soft band-credit rank of the
    # winner: the candidate-selection score, and the phase score of
    # `MultiPhaseHoughIndexer`


class HoughIndexer:
    """Band-based orientation indexing (the vendor Hough-indexing role).

    Zero training, zero dictionary patterns: only a reflector table and the
    detector geometry. Accuracy is set by the Radon bin resolution (~1° at
    the defaults) rather than the grid: the q-method solves below it.

    Args:
        reflectors: `sim.Reflectors` table (e.g. `sim.cubic_reflectors()`);
            entries below ``min_intensity`` are dropped for voting.
        geometry: detector model the patterns were captured with.
        group: proper point group for the orientation grid / FZ reduction.
        grid_resolution_deg: mean spacing of the voting grid.
        n_bands: bands detected and used per pattern.
        tolerance_deg: band-to-reflector residual treated as a match.
        min_bands: matched-band count below which ``success`` is False.
        top_candidates: grid candidates refined per pattern; the winner is
            re-ranked by soft band credit after refinement.
        refine_iters: q-method assign/solve rounds.
        batch_size: rows per device batch (inputs padded up to it).
        detector: optional pre-built `BandDetector` (its shape must match
            the geometry's); default builds one at the module defaults.
        grid_chunk: grid rows scored per product, bounding the
            ``(B, n_bands, grid_chunk, K)`` vote tensor.
        intensity_weight: weight of the band-intensity factor in the soft
            band-credit ranking (0 disables it).
        mesh: optional `parallel.Mesh`: the grid's chunks (their count
            padded to the mesh size) shard over its devices, each device
            refines its own top candidates, and the winners merge by rank
            on the first device (the band detection runs there too).
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.
    """

    def __init__(
        self,
        reflectors,
        geometry: DetectorGeometry | None = None,
        group: str = "432",
        grid_resolution_deg: float = 3.0,
        n_bands: int = 8,
        tolerance_deg: float = 3.0,
        min_bands: int = 4,
        min_intensity: float = 0.05,
        top_candidates: int = 16,
        refine_iters: int = 2,
        batch_size: int = 256,
        detector: BandDetector | None = None,
        grid_chunk: int = 256,
        intensity_weight: float = 0.5,
        mesh=None,
        device: str | torch.device | None = None,
    ) -> None:
        if mesh is not None:
            device = check_mesh_device(mesh, device)
        self.mesh = mesh
        self.geometry = geometry or DetectorGeometry()
        h, w = self.geometry.shape
        self.group = group
        self.n_bands = n_bands
        self.min_bands = min_bands
        self.batch_size = batch_size
        self.refine_iters = refine_iters
        self.tol_rad = math.radians(tolerance_deg)

        keep = reflectors.intensity >= min_intensity
        if keep.sum() < 3:
            raise ValueError(
                f"min_intensity={min_intensity} leaves "
                f"{int(keep.sum())} reflectors; indexing needs >= 3"
            )
        refl = np.ascontiguousarray(reflectors.normals[keep])
        kept_i = np.abs(np.asarray(reflectors.intensity, np.float64))[keep]
        refl_i = (kept_i / kept_i.max()).astype(np.float32)

        self.detector = detector or BandDetector(
            height=h, width=w, k=n_bands, batch_size=batch_size, device=device
        )
        self.device = self.detector.device
        if self.detector.shape != (h, w):
            raise ValueError(f"detector shape {self.detector.shape} != geometry {(h, w)}")
        if self.detector.k < n_bands:
            raise ValueError(f"detector returns {self.detector.k} bands < n_bands={n_bands}")

        grid = sample_fundamental_zone(group, grid_resolution_deg)
        self.m_valid = len(grid)
        pad = (-len(grid)) % grid_chunk
        if pad:
            grid = np.concatenate([grid, np.tile(grid[:1], (pad, 1))])
        if mesh is not None:
            # The chunk count padded to the mesh size, so every device holds
            # an equal block; pad rows are copies of grid[0], masked by
            # their global position.
            chunk_pad = (-(len(grid) // grid_chunk)) % mesh.size
            if chunk_pad:
                grid = np.concatenate([grid, np.tile(grid[:1], (chunk_pad * grid_chunk, 1))])
        self.grid_chunk = grid_chunk
        dev = self.device
        self._grid_q = torch.as_tensor(grid, dtype=torch.float32, device=dev)  # (Mp, 4)
        self._refl = torch.as_tensor(refl, dtype=torch.float32, device=dev)  # (K, 3)
        self._refl_i = torch.as_tensor(refl_i, device=dev)
        # Rotated reflector normals, once per indexer: (Mp, K, 3).
        self._grid_normals = _quat_rotate(self._grid_q, self._refl)
        self._blocks = None
        if mesh is not None:
            # Per device: (row offset, grid block, its normals, reflectors,
            # intensities), the block on its own device.
            rows = len(grid) // mesh.size
            refl_reps = replicate((self._refl, self._refl_i), mesh)
            self._blocks = [
                (i * rows, self._grid_q[i * rows : (i + 1) * rows].to(d, copy=True),
                 self._grid_normals[i * rows : (i + 1) * rows].to(d, copy=True), *reps)
                for i, (d, reps) in enumerate(zip(mesh.devices, refl_reps))
            ]
        # The vote gate uses the grid's covering radius (~2x its mean
        # resolution): gating at the assignment tolerance would zero the
        # true basin's vote when its nearest grid point is that far off.
        self.vote_tol_rad = max(self.tol_rad, math.radians(2.0 * grid_resolution_deg))
        self.top_p = top_candidates
        self.i_weight = intensity_weight

    @torch.inference_mode()
    def _solve(self, nrm: torch.Tensor, wts: torch.Tensor):
        """Vote over the grid, then refine: see `_index_bands`; with a mesh,
        per grid block and merged by rank."""
        kw = dict(
            tol_rad=self.tol_rad, vote_tol_rad=self.vote_tol_rad,
            refine_iters=self.refine_iters, top_p=self.top_p, m_valid=self.m_valid,
            i_weight=self.i_weight, grid_chunk=self.grid_chunk,
        )
        with full_f32_matmul():
            if self._blocks is None:
                return _index_bands(
                    nrm, wts, self._grid_q, self._grid_normals, self._refl, self._refl_i, **kw
                )
            first = self.mesh.devices[0]
            outs = [
                _index_bands(
                    nrm.to(d), wts.to(d), grid_q, grid_normals, refl, refl_i,
                    row_offset=offset, **kw,
                )
                for d, (offset, grid_q, grid_normals, refl, refl_i)
                in zip(self.mesh.devices, self._blocks)
            ]
            fields = [torch.stack([o[f].to(first) for o in outs]) for f in range(5)]
            # The first maximum is the lowest device: device 0 holds the
            # real grid[0] rows, so an all-pad block's copy never displaces
            # the genuine candidate.
            best = fields[4].argmax(dim=0)  # (B,)
            rows = torch.arange(best.shape[0], device=first)
            return tuple(f[best, rows] for f in fields)

    def index_bands(
        self, normals: np.ndarray, weights: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Solve orientations for pre-detected band normals.

        Args:
            normals: ``(B, n_bands, 3)`` unit band-plane normals, detector
                frame (sign-ambiguous is fine).
            weights: ``(B, n_bands)`` non-negative vote weights (band
                strengths; 0 disables a slot).

        Returns:
            ``(quats (B,4), fit_deg (B,), n_matched (B,), vote (B,),
            band_score (B,))``: quats NOT yet reduced to the fundamental
            zone.
        """
        out = self._solve(
            torch.as_tensor(np.asarray(normals, np.float32), device=self.device),
            torch.as_tensor(np.asarray(weights, np.float32), device=self.device),
        )
        return _to_host(out)

    def detect_bands(self, patterns: np.ndarray) -> tuple[BandDetection, np.ndarray, np.ndarray]:
        """Radon band detection + plane-normal inversion for a
        ``(B, H, W[, 1])`` stack, the phase-independent half of indexing:
        ``(detection, normals (B, n_bands, 3), weights (B, n_bands))``.
        `MultiPhaseHoughIndexer` runs it once for every phase."""
        det = self.detector(np.asarray(patterns))
        k = self.n_bands
        theta = det.theta_deg[:, :k]
        rho = det.rho_px[:, :k]
        strength = np.maximum(det.strength[:, :k], 0.0)
        normals = band_plane_normals(theta, rho, self.geometry)
        # Weights normalized per pattern, so the tolerance and vote scales
        # do not depend on the pattern's contrast.
        wmax = strength.max(axis=1, keepdims=True)
        weights = strength / np.maximum(wmax, 1e-12)
        return det, normals, weights

    def __call__(self, patterns: np.ndarray) -> HoughIndexResult:
        """Detect bands and index a ``(B, H, W[, 1])`` pattern stack."""
        det, normals, weights = self.detect_bands(patterns)
        return self.index_detected(det, normals, weights)

    def index_detected(
        self,
        det: BandDetection,
        normals: np.ndarray,
        weights: np.ndarray,
    ) -> HoughIndexResult:
        """Index pre-detected bands (`detect_bands` output) against THIS
        phase's grid, the phase-dependent half of `__call__`. The last
        batch is padded with its last row; every batch is enqueued before
        the first result is read back."""
        from scipy.spatial.transform import Rotation as R

        bs = self.batch_size
        pending = []
        for start in range(0, len(normals), bs):
            n_chunk = np.asarray(normals[start : start + bs], np.float32)
            w_chunk = np.asarray(weights[start : start + bs], np.float32)
            n = len(n_chunk)
            if n < bs:
                n_chunk = np.concatenate([n_chunk, np.tile(n_chunk[-1:], (bs - n, 1, 1))])
                w_chunk = np.concatenate([w_chunk, np.tile(w_chunk[-1:], (bs - n, 1))])
            out = self._solve(
                torch.from_numpy(n_chunk).to(self.device),
                torch.from_numpy(w_chunk).to(self.device),
            )
            pending.append((n, out))
        q, fit, nm, vote, score = _to_host(
            tuple(torch.cat([o[i][:n] for n, o in pending]) for i in range(5))
        )
        quats = reduce_to_fundamental_zone(q, self.group)
        # Vendor convention: phi1/phi2 in [0, 360) (scipy gives (-180, 180]).
        eulers = np.mod(
            R.from_quat(np.roll(quats, -1, axis=1)).as_euler("zxz", degrees=True), 360.0
        )
        return HoughIndexResult(
            quaternions=quats,
            eulers_deg=eulers,
            fit_deg=fit,
            n_matched=nm,
            vote_score=vote,
            success=nm >= self.min_bands,
            bands=det,
            band_score=score,
        )


def _to_host(out) -> tuple[np.ndarray, ...]:
    """`_index_bands`' device tensors as the host arrays `index_bands` returns."""
    q, fit, nm, vote, score = (t.cpu().numpy() for t in out)
    return (
        q.astype(np.float64),
        np.degrees(fit.astype(np.float64)),
        nm.astype(np.int64),
        vote.astype(np.float64),
        score.astype(np.float64),
    )


def _index_bands(nrm, wts, grid_q, grid_normals, refl, refl_i, *, tol_rad, vote_tol_rad,
                 refine_iters, top_p, m_valid, i_weight, grid_chunk, row_offset=0):
    """Vote over the grid, then q-method refinement. Call inside
    `device.full_f32_matmul`.

    Args:
        nrm: (B, Nb, 3) measured unit band normals (detector frame).
        wts: (B, Nb) vote weights.
        grid_q: (Mp, 4) grid quaternions (crystal→detector); rows from
            ``m_valid`` on are padding.
        grid_normals: (Mp, K, 3) rotated reflector normals.
        refl: (K, 3) crystal-frame reflector normals.
        refl_i: (K,) reflector intensities, max-normalized to [0, 1].
        row_offset: global position of this grid block's first row (0 on
            one device; a mesh block's offset), since ``m_valid`` addresses
            global grid positions.

    Returns ``(q (B, 4), fit_rad (B,), n_matched (B,), vote (B,),
    band_score (B,))`` on the device.
    """
    b, nb, _ = nrm.shape
    cos_tol = math.cos(vote_tol_rad)
    # Soft vote edge: ~1/4 of the tolerance window in cos-space.
    soft = (1.0 - cos_tol) * 0.25 + 1e-6
    flat = nrm.reshape(b * nb, 3)
    k = refl.shape[0]
    parts = []
    for start in range(0, grid_q.shape[0], grid_chunk):
        gc = grid_normals[start : start + grid_chunk]  # (G, K, 3)
        d = flat @ gc.reshape(-1, 3).T  # (B*Nb, G*K)
        best = d.abs_().reshape(b, nb, -1, k).amax(dim=-1)  # (B, Nb, G)
        gate = torch.sigmoid((best - cos_tol) / soft)
        parts.append(torch.einsum("bng,bn->bg", gate, wts))
    scores = torch.cat(parts, dim=1)  # (B, Mp)
    # Chunk-padding rows are copies of grid[0] with live votes; left in,
    # they could fill the candidate list with one orientation.
    scores = torch.where(
        row_offset + torch.arange(scores.shape[1], device=scores.device) < m_valid,
        scores,
        float("-inf"),
    )
    # The vote only has to put the right basin somewhere in the top few:
    # near-ties are broken after refinement.
    vote_p, idx_p = topk_lower_index_first(scores, top_p)  # (B, P)
    q = grid_q[idx_p].reshape(b * top_p, 4)

    # Candidates folded into the batch axis: all refine together.
    nrm_p = nrm.repeat_interleave(top_p, dim=0)  # (B*P, Nb, 3)
    wts_p = wts.repeat_interleave(top_p, dim=0)

    def residuals(q):
        """Band-to-nearest-reflector assignment at orientation q."""
        m_rot = _quat_rotate(q, refl)  # (B*P, K, 3)
        d = nrm_p @ m_rot.transpose(1, 2)  # (B*P, Nb, K)
        j = d.abs().argmax(dim=-1)  # the first maximum, as jnp.argmax
        dotj = d.gather(-1, j[..., None])[..., 0]  # signed
        ang = torch.arccos(dotj.abs().clamp(0.0, 1.0))
        return j, dotj, ang

    def refine_once(q, tol):
        j, dotj, ang = residuals(q)
        # Matched crystal normal, sign-resolved toward the measurement.
        c = refl[j] * torch.sign(dotj)[..., None]
        w = wts_p * (ang < tol)
        b_mat = (w[..., None] * nrm_p).transpose(1, 2) @ c  # (B*P, 3, 3)
        # The candidate (then the previous round's solve) seeds the power
        # iteration: it lies within the vote tolerance of the optimum.
        q_new = solve_wahba(b_mat, init=q)
        # Fewer than 2 usable bands: a degenerate Davenport matrix; keep q.
        ok = (w > 0).sum(dim=-1) >= 2
        return torch.where(ok[:, None], q_new, q)

    # The first round accepts residuals up to the grid covering radius;
    # later rounds tighten to the reported tolerance.
    for it in range(refine_iters):
        q = refine_once(q, max(tol_rad, vote_tol_rad) if it == 0 else tol_rad)

    # Rank the refined candidates by soft band credit:
    #   rank = Σ_n w_n · [ (1 − ang_n/tol)₊ · (1 + i_weight·I_n) + 0.5·m_n ]
    # with I_n the intensity of band n's reflector and m_n = (ang_n < tol);
    # n_matched and fit keep their hard definitions.
    j, _, ang = residuals(q)
    matched = (ang < tol_rad) & (wts_p > 0)
    w = wts_p * matched
    wsum = w.sum(dim=-1).clamp(min=1e-12)
    fit = (w * ang).sum(dim=-1) / wsum  # (B*P,)
    n_matched = matched.sum(dim=-1)
    credit = wts_p * torch.clamp(1.0 - ang / tol_rad, min=0.0) * (1.0 + i_weight * refl_i[j])
    rank = (credit + 0.5 * w).sum(dim=-1).reshape(b, top_p)
    best_p = rank.argmax(dim=-1)  # (B,), the first maximum
    rows = torch.arange(b, device=rank.device)

    def take(x):
        return x.reshape(b, top_p, *x.shape[1:])[rows, best_p]

    return take(q), take(fit), take(n_matched), vote_p[rows, best_p], rank[rows, best_p]


class MultiPhaseHoughResult(NamedTuple):
    """Per-pattern multi-phase Hough solution: the winning phase's fields
    (host numpy), plus the full per-phase results."""

    quaternions: np.ndarray  # (B, 4) winner's FZ quaternion (its group)
    eulers_deg: np.ndarray  # (B, 3) zxz Euler degrees
    fit_deg: np.ndarray  # (B,)
    n_matched: np.ndarray  # (B,)
    vote_score: np.ndarray  # (B,)
    band_score: np.ndarray  # (B,) winner's soft band credit (phase rank)
    phase: np.ndarray  # (B,) int winning phase id (list position)
    success: np.ndarray  # (B,) winner matched >= min_bands
    bands: BandDetection  # shared raw detection (phase-independent)
    per_phase: tuple  # tuple[HoughIndexResult, ...] full per-phase results


class MultiPhaseHoughIndexer:
    """Multi-phase band indexing: score every phase, keep the per-pixel best.

    The Radon scan and plane-normal inversion are phase-independent, so they
    run once through one shared `BandDetector`; only the grid vote and the
    q-method refinement repeat per phase. The phase is decided by the same
    soft band-credit score that picks each phase's orientation
    (``band_score``).

    Args:
        phases: sequence of ``(reflectors, group)`` pairs; phase id = list
            position (the .ang/.ctf phase column is written 1-based).
        geometry: shared detector model.
        **kwargs: forwarded to every per-phase `HoughIndexer`.
    """

    def __init__(self, phases, geometry: DetectorGeometry | None = None, **kwargs) -> None:
        if len(phases) < 1:
            raise ValueError("need at least one (reflectors, group) phase")
        detector = kwargs.pop("detector", None)
        self.indexers: list[HoughIndexer] = []
        for reflectors, group in phases:
            ix = HoughIndexer(reflectors, geometry, group=group, detector=detector, **kwargs)
            detector = ix.detector  # one Radon matrix for every phase
            self.indexers.append(ix)

    @property
    def groups(self) -> list[str]:
        return [ix.group for ix in self.indexers]

    def __call__(self, patterns: np.ndarray) -> MultiPhaseHoughResult:
        """Detect once, index every phase, pick the per-pattern winner."""
        det, normals, weights = self.indexers[0].detect_bands(patterns)
        per = tuple(ix.index_detected(det, normals, weights) for ix in self.indexers)
        rank = np.stack([r.band_score for r in per])  # (P, B)
        phase = np.argmax(rank, axis=0)  # (B,)

        def take(field: str) -> np.ndarray:
            stacked = np.stack([getattr(r, field) for r in per])  # (P, B, ...)
            idx = phase.reshape((1, -1) + (1,) * (stacked.ndim - 2))
            return np.take_along_axis(stacked, idx, axis=0)[0]

        return MultiPhaseHoughResult(
            quaternions=take("quaternions"),
            eulers_deg=take("eulers_deg"),
            fit_deg=take("fit_deg"),
            n_matched=take("n_matched"),
            vote_score=take("vote_score"),
            band_score=take("band_score"),
            phase=phase,
            success=take("success"),
            bands=det,
            per_phase=per,
        )
