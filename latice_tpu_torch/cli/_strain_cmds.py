"""``python -m latice_tpu_torch.cli.index calibrate``: autodiff detector
calibration, the port of ``calibrate`` in ``latice_tpu/cli/_strain_cmds.py``.
``strain`` (HR-EBSD) waits for a later slice."""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from latice_tpu_torch.cli._band_cmds import _parse_hough_phase, _structure_spec
from latice_tpu_torch.cli._common import _load_raw_pattern_stack, later_slice
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


def cmd_strain(args) -> None:
    raise later_slice("strain (HR-EBSD, hrebsd.py)", "slice D")


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
    """Attach the calibrate parser, and strain, which waits for a later
    slice."""
    st = sub.add_parser(
        "strain",
        help="HR-EBSD cross-correlation strain + lattice-rotation mapping (waits for slice D)",
    )
    st.set_defaults(fn=cmd_strain, takes_any_arguments=True)

    cal = sub.add_parser(
        "calibrate",
        help="autodiff pattern-center calibration: shared PC, or the affine "
        "scan-varying model PC(xy) = PC0 + G.xy (--scan-grid)",
    )
    cal.add_argument("--patterns", required=True,
                     help=".npy stack (HDF5 scans and EDAX .up1/.up2 wait for slice E)")
    cal.add_argument("--h5-dataset", default=None, help="HDF5 dataset path (slice E)")
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
