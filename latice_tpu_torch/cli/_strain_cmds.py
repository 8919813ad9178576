"""``python -m latice_tpu_torch.cli.index strain|calibrate``: HR-EBSD strain
mapping and autodiff detector calibration, the port of
``latice_tpu/cli/_strain_cmds.py``."""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from latice_tpu_torch.cli._band_cmds import _parse_hough_phase, _structure_spec
from latice_tpu_torch.cli._common import _load_raw_pattern_stack
from latice_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def _load_orientation_quats(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Initial orientations for calibration → ``(quats, success)``.

    Accepts the outputs of any indexing pass: an ``(N, 3)`` zxz-Euler-degree
    or ``(N, 4)`` scalar-first-quaternion ``.npy``, or a vendor ``.ang`` /
    ``.ctf`` result (whose success mask filters unindexed pixels out of the
    fit).
    """
    from latice_tpu_torch.crystal import from_euler_zxz_deg

    low = path.lower()
    if low.endswith(".ang") or low.endswith(".ctf"):
        from latice_tpu_torch.data import read_ang, read_ctf

        vm = read_ang(path) if low.endswith(".ang") else read_ctf(path)
        eulers, success = vm.eulers, vm.success
    else:
        arr = np.load(path)
        if arr.ndim != 2 or arr.shape[1] not in (3, 4):
            raise SystemExit(
                f"--orientations {path}: expected (N, 3) Euler degrees or "
                f"(N, 4) quaternions, got {arr.shape}"
            )
        if arr.shape[1] == 4:
            q = arr / np.linalg.norm(arr, axis=1, keepdims=True)
            return q.astype(np.float32), np.ones(len(arr), bool)
        eulers, success = arr, np.ones(len(arr), bool)
    q = from_euler_zxz_deg(torch.as_tensor(np.asarray(eulers, np.float32))).numpy()
    return q.astype(np.float32), np.asarray(success, bool)


def _calibration_subset(n: int, grid, success: np.ndarray, max_patterns: int) -> np.ndarray:
    """Pick <= max_patterns indexed pattern indices spread over the scan.

    With a (rows, cols) grid the subset is a coarse sub-grid (corners +
    interior: the gradient G is constrained by the spanned area); without
    one it is an even stride through the stack.
    """
    if grid:
        rows, cols = grid
        k = max(2, int(np.ceil(np.sqrt(max_patterns))))
        r_idx = np.unique(np.linspace(0, rows - 1, k).round().astype(int))
        c_idx = np.unique(np.linspace(0, cols - 1, k).round().astype(int))
        idx = (r_idx[:, None] * cols + c_idx[None, :]).ravel()
        idx = idx[idx < n]
    else:
        idx = np.unique(np.linspace(0, n - 1, max_patterns).round().astype(int))
    idx = idx[success[idx]]
    if len(idx) > max_patterns:
        idx = idx[np.unique(np.linspace(0, len(idx) - 1, max_patterns).round().astype(int))]
    if len(idx) < 3:
        raise SystemExit(
            f"calibration needs >= 3 indexed patterns after subsetting (got {len(idx)})"
        )
    return idx


def _parse_stiffness(spec: str | None, flag: str) -> np.ndarray | None:
    """A cubic ``(6, 6)`` Voigt stiffness from a `crystal.CUBIC_STIFFNESS`
    preset name or a ``C11,C12,C44`` GPa triplet; None without a spec."""
    from latice_tpu_torch.crystal import CUBIC_STIFFNESS, cubic_stiffness

    if not spec:
        return None
    parts = spec.split(",")
    if len(parts) == 3:
        return cubic_stiffness(*(float(p) for p in parts))
    if spec in CUBIC_STIFFNESS:
        return cubic_stiffness(*CUBIC_STIFFNESS[spec])
    raise SystemExit(
        f"{flag} {spec!r}: use C11,C12,C44 (GPa) or one of {sorted(CUBIC_STIFFNESS)}"
    )


def cmd_strain(args) -> None:
    """HR-EBSD cross-correlation strain and rotation mapping (`hrebsd`).

    Measures the RELATIVE elastic strain and lattice rotation of every
    pattern against a reference pattern from the same grain (sub-pixel ROI
    shifts → displacement-gradient tensor). With ``--stiffness`` the
    traction-free surface condition closes the hydrostatic gauge and stress
    maps are written too. The reference must share the grain: run per
    grain, with ``--ref`` inside it.
    """
    from latice_tpu_torch.crystal import from_euler_zxz_deg
    from latice_tpu_torch.hrebsd import hrebsd_map, von_mises_strain
    from latice_tpu_torch.sim import DetectorGeometry, ScanCalibration

    device = resolve_device(args.device)
    raw = _load_raw_pattern_stack(args)
    if raw.ndim == 4:
        raw = raw.reshape(-1, *raw.shape[-2:])
    if raw.dtype != np.uint8:
        raw = raw.astype(np.float32, copy=False)
    if not 0 <= args.ref < len(raw):
        raise SystemExit(f"--ref {args.ref} out of range for {len(raw)} patterns")
    geometry = DetectorGeometry(
        shape=raw.shape[1:], pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2], tilt=args.tilt
    )
    stiffness = _parse_stiffness(args.stiffness, "--stiffness")
    orientations = None
    if args.euler:
        orientations = from_euler_zxz_deg(
            torch.tensor([args.euler], dtype=torch.float32)
        ).numpy()[0]

    calibration = scan_xy = None
    if args.calibration:
        if not args.scan_grid:
            raise SystemExit(
                "--calibration needs --scan-grid ROWS COLS (per-pattern scan positions "
                "evaluate the PC model)"
            )
        blob = np.load(args.calibration)
        for key in ("pc0", "gradient"):
            if key not in blob:
                raise SystemExit(
                    f"--calibration {args.calibration}: missing {key!r} (expected the "
                    "`calibrate --scan-grid` npz)"
                )
        calibration = ScanCalibration(
            pc0=blob["pc0"], gradient=blob["gradient"], shape=raw.shape[1:], tilt=args.tilt
        )
        rows, cols = args.scan_grid
        if rows * cols != len(raw):
            raise SystemExit(f"--scan-grid {rows}x{cols} does not hold {len(raw)} patterns")
        rr, cc = np.divmod(np.arange(len(raw)), cols)
        # The (x = col·step, y = row·step) convention `calibrate --scan-grid`
        # fitted the model in.
        scan_xy = np.stack([cc * args.calibration_step, rr * args.calibration_step], axis=1)
        # The deformation model expands around the REFERENCE's geometry.
        geometry = calibration.geometry_at(scan_xy[args.ref])

    t0 = time.time()
    res = hrebsd_map(
        raw, raw[args.ref], geometry,
        roi_size=args.roi_size, upsample=args.upsample,
        stiffness=stiffness, orientations=orientations,
        f_min=args.f_min, f_max=args.f_max,
        min_quality=args.min_quality, chunk=args.batch_size,
        remap_iterations=args.remap,
        calibration=calibration, scan_xy=scan_xy, device=device,
    )
    dt = time.time() - t0

    vm = von_mises_strain(res.strain)
    out = {
        "a": res.a, "strain": res.strain, "rotation": res.rotation,
        "rotation_deg": res.rotation_deg, "von_mises": vm,
        "shifts_px": res.shifts_px, "quality": res.quality,
        "residual_px": res.residual_px,
        "pc": np.asarray(args.pc), "ref_index": args.ref,
    }
    if res.stress is not None:
        out["stress"] = res.stress
    np.savez(args.out, **out)
    summary = {
        "n_patterns": len(raw),
        "ref_index": args.ref,
        "median_von_mises": round(float(np.median(vm)), 8),
        "max_von_mises": round(float(vm.max()), 8),
        "median_rotation_deg": round(float(np.median(res.rotation_deg)), 5),
        "max_rotation_deg": round(float(res.rotation_deg.max()), 5),
        "mean_quality": round(float(res.quality.mean()), 4),
        "median_residual_px": round(float(np.median(res.residual_px)), 4),
        "first_order_valid": bool(res.rotation_deg.max() < 1.5),
        "remap_iterations": args.remap,
        "seconds": round(dt, 2),
        "output": args.out,
    }
    if args.map:
        if not args.scan_grid:
            raise SystemExit("--map needs --scan-grid ROWS COLS")
        rows, cols = args.scan_grid
        if rows * cols != len(vm):
            raise SystemExit(f"--scan-grid {rows}x{cols} does not hold {len(vm)} patterns")
        from latice_tpu_torch.utils._mpl import ensure_headless_backend

        ensure_headless_backend()
        import matplotlib.image as mpimg

        img = vm.reshape(rows, cols)
        lo, hi = float(img.min()), float(img.max())
        mpimg.imsave(args.map, (img - lo) / max(hi - lo, 1e-12), cmap="viridis")
        summary["map"] = args.map
    print(json.dumps(summary))


def cmd_calibrate(args) -> None:
    """Autodiff detector-geometry calibration (`sim.calibrate`).

    Fits the pattern center by maximizing the NCC between the renders and
    the measured patterns, jointly with per-pattern orientation
    corrections. A shared PC by default; the affine scan-varying model
    ``PC(xy) = PC0 + G.xy`` with ``--scan-grid ROWS COLS`` or ``--scan-xy``.
    Initial orientations come from any indexing pass (an Euler or
    quaternion ``.npy``, or a vendor ``.ang``/``.ctf``, whose success mask
    filters unindexed pixels). ``--pin`` holds them fixed (a known single
    crystal).
    """
    from latice_tpu_torch.data import prepare_patterns
    from latice_tpu_torch.sim import DetectorGeometry, calibrate_geometry, calibrate_scan_geometry

    _, refl, _group, _ = _parse_hough_phase(_structure_spec(args), args)
    device = resolve_device(args.device)
    raw = _load_raw_pattern_stack(args)
    quats, success = _load_orientation_quats(args.orientations)
    if len(quats) != len(raw):
        raise SystemExit(f"{len(raw)} patterns but {len(quats)} orientations")
    # The detector's native shape (no model-input resize): the geometry
    # being fitted lives in these pixels.
    native = raw.shape[1:3] if raw.ndim == 4 else raw.shape[-2:]
    x = prepare_patterns(raw, image_size=native)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    h, w = x.shape[1], x.shape[2]
    nominal = DetectorGeometry(
        shape=(h, w), pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2], tilt=args.tilt
    )

    scan_mode = bool(args.scan_grid) or args.scan_xy is not None
    grid = tuple(args.scan_grid) if args.scan_grid else None
    idx = _calibration_subset(len(x), grid, success, args.max_patterns)
    steps = args.steps if args.steps else (2500 if scan_mode else 300)
    lr_orientation = 0.0 if args.pin else args.lr_orientation

    t0 = time.time()
    if scan_mode:
        if args.scan_xy is not None:
            scan_xy = np.load(args.scan_xy)
            if scan_xy.shape != (len(x), 2):
                raise SystemExit(f"--scan-xy must be ({len(x)}, 2), got {scan_xy.shape}")
        else:
            rows, cols = grid
            if rows * cols != len(x):
                raise SystemExit(f"--scan-grid {rows}x{cols} does not hold {len(x)} patterns")
            rr, cc = np.divmod(np.arange(len(x)), cols)
            scan_xy = np.stack([cc * args.step, rr * args.step], axis=1)
        fit, refined, ncc = calibrate_scan_geometry(
            x[idx], quats[idx], scan_xy[idx], nominal, refl,
            steps=steps, lr_pc=args.lr_pc, lr_orientation=lr_orientation, device=device,
        )
        model = dict(pc0=fit.pc0, gradient=fit.gradient, shape=np.asarray(fit.shape),
                     tilt=fit.tilt)
        summary = {
            "model": "affine",
            "pc0": [round(float(v), 6) for v in fit.pc0],
            "gradient": [[float(f"{v:.3e}") for v in row] for row in fit.gradient],
            "pc_center": [round(float(v), 6) for v in fit.pc_at(scan_xy.mean(axis=0))],
        }
    else:
        fitted, refined, ncc = calibrate_geometry(
            x[idx], quats[idx], nominal, refl,
            steps=steps, lr_pc=args.lr_pc, lr_orientation=lr_orientation, device=device,
        )
        model = dict(pc=np.array([fitted.pcx, fitted.pcy, fitted.dd]),
                     shape=np.asarray(fitted.shape), tilt=fitted.tilt)
        summary = {
            "model": "shared",
            "pc": [round(float(v), 6) for v in (fitted.pcx, fitted.pcy, fitted.dd)],
        }
    dt = time.time() - t0
    np.savez(args.out, **model, refined_quats=refined, pattern_indices=idx)
    summary.update(
        n_used=int(len(idx)),
        steps=int(steps),
        pinned=bool(args.pin),
        mean_ncc=round(float(ncc), 5),
        seconds=round(dt, 2),
        out=args.out,
    )
    logger.info(
        f"Calibrated {summary['model']} PC model from {len(idx)} patterns "
        f"in {dt:.1f}s (NCC {ncc:.4f})"
    )
    print(json.dumps(summary))


def register(sub, common) -> None:
    """Attach the strain and calibrate parsers."""
    st = sub.add_parser(
        "strain",
        help="HR-EBSD cross-correlation strain + lattice-rotation mapping "
        "(relative to a reference pattern in the same grain)",
    )
    st.add_argument("--patterns", required=True, help=".npy stack, HDF5 scan or EDAX .up1/.up2")
    st.add_argument("--h5-dataset", default=None,
                    help="HDF5 dataset path (default: the detected pattern stack)")
    st.add_argument(
        "--ref", type=int, default=0,
        help="index of the reference pattern (strain is relative to it; pick a "
        "low-strain point inside the grain)",
    )
    st.add_argument("--out", default="strain.npz")
    st.add_argument(
        "--pc", type=float, nargs=3, default=(0.5, 0.5, 0.7), metavar=("PCX", "PCY", "DD"),
        help="pattern center + detector distance, detector-width units: PC errors "
        "alias into phantom strain; calibrate first",
    )
    st.add_argument("--tilt", type=float, default=0.0,
                    help="detector tilt, degrees (sets the traction-free surface normal)")
    st.add_argument("--roi-size", type=int, default=64,
                    help="ROI window edge, px (21 ROIs: center + two rings)")
    st.add_argument("--upsample", type=int, default=20,
                    help="sub-pixel factor kappa: shifts resolve to ~1/kappa px")
    st.add_argument(
        "--stiffness", default=None, metavar="PHASE|C11,C12,C44",
        help="cubic elastic constants (GPa): a preset name (ni, cu, al, fe-alpha, "
        "fe-gamma, w) or three comma-separated values; enables the traction-free "
        "gauge closure and stress output",
    )
    st.add_argument(
        "--euler", type=float, nargs=3, default=None, metavar=("PHI1", "PHI", "PHI2"),
        help="grain orientation (zxz extrinsic, degrees) rotating the stiffness into "
        "the detector frame",
    )
    st.add_argument("--f-min", type=float, default=1.5,
                    help="Fourier high-pass, cycles per ROI (kills background)")
    st.add_argument("--f-max", type=float, default=None,
                    help="Fourier low-pass, cycles per ROI (None keeps all)")
    st.add_argument("--min-quality", type=float, default=0.1,
                    help="drop ROIs whose XCF peak quality falls below this")
    st.add_argument(
        "--calibration", default=None, metavar="CAL.npz",
        help="scan-varying PC model from `calibrate --scan-grid` (pc0 + gradient): "
        "every pattern's design matrix and remap warp then use its own pattern "
        "center; needs --scan-grid (and --calibration-step if the fit used a scan step)",
    )
    st.add_argument(
        "--calibration-step", type=float, default=1.0,
        help="scan step in the calibration's units (the --step given to `calibrate`; "
        "default %(default)s)",
    )
    st.add_argument(
        "--remap", type=int, default=1, metavar="N",
        help="iterative remapping passes: re-project each pattern through the recovered "
        "deformation and re-correlate (accepted per pattern only where the fit "
        "residual drops); 0 disables",
    )
    st.add_argument("--batch-size", type=int, default=128)
    st.add_argument(
        "--scan-grid", type=int, nargs=2, metavar=("ROWS", "COLS"), default=None,
        help="scan shape for --map and --calibration (UP headers fill it)",
    )
    st.add_argument("--map", default=None, metavar="OUT.png",
                    help="render the von Mises equivalent-strain map (needs --scan-grid)")
    st.add_argument("--device", default=None, help="torch device (default: cuda)")
    st.set_defaults(fn=cmd_strain)

    cal = sub.add_parser(
        "calibrate",
        help="autodiff pattern-center calibration: shared PC, or the affine "
        "scan-varying model PC(xy) = PC0 + G.xy (--scan-grid)",
    )
    cal.add_argument("--patterns", required=True,
                     help=".npy stack, HDF5 scan or EDAX .up1/.up2")
    cal.add_argument("--h5-dataset", default=None,
                     help="HDF5 dataset path (default: the detected pattern stack)")
    cal.add_argument(
        "--orientations", required=True,
        help="initial orientations from any indexing pass: (N, 3) Euler-degree "
        "or (N, 4) quaternion .npy, or a vendor .ang/.ctf result (its success "
        "mask filters unindexed pixels)",
    )
    cal.add_argument(
        "--out", default="calibration.npz",
        help="fitted model output (.npz: pc / pc0+gradient, shape, tilt, "
        "refined quats, pattern indices used)",
    )
    cal.add_argument("--structure", default="fcc", choices=("fcc", "bcc", "sc", "hcp"))
    cal.add_argument("--lattice", type=float, default=3.52)
    cal.add_argument("--lattice-c", type=float, default=None)
    cal.add_argument("--kv", type=float, default=20.0)
    cal.add_argument("--max-hkl", type=int, default=3)
    cal.add_argument("--min-d", type=float, default=0.8)
    cal.add_argument(
        "--pc", type=float, nargs=3, default=(0.5, 0.5, 0.7),
        metavar=("PCX", "PCY", "DD"),
        help="NOMINAL pattern center: the optimization's starting point",
    )
    cal.add_argument("--tilt", type=float, default=0.0)
    cal.add_argument(
        "--scan-grid", type=int, nargs=2, metavar=("ROWS", "COLS"), default=None,
        help="fit the affine scan-varying PC model over this raster "
        "(positions from row-major order x --step)",
    )
    cal.add_argument("--step", type=float, default=1.0,
                     help="scan step for --scan-grid positions, um (the gradient "
                     "is reported per this unit)")
    cal.add_argument("--scan-xy", default=None,
                     help="explicit (N, 2) scan-position .npy: the affine model at "
                     "arbitrary positions; overrides --scan-grid")
    cal.add_argument("--max-patterns", type=int, default=64,
                     help="calibration subset size, spread across the scan (a "
                     "coarse sub-grid under --scan-grid; an even stride otherwise)")
    cal.add_argument("--pin", action="store_true",
                     help="hold the orientations fixed (known single crystal): "
                     "removes the PC<->rotation degeneracy")
    cal.add_argument("--steps", type=int, default=None,
                     help="Adam steps (default 300 shared / 2500 affine)")
    cal.add_argument("--lr-pc", type=float, default=2e-3)
    cal.add_argument("--lr-orientation", type=float, default=2e-3)
    cal.add_argument("--device", default=None, help="torch device (default: cuda)")
    cal.set_defaults(fn=cmd_calibrate)
