"""``python -m latice_tpu_torch.cli.index quality/hough``: the Radon band
plane, the port of ``latice_tpu/cli/_band_cmds.py``."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np

from latice_tpu_torch.cli._common import _load_raw_pattern_stack
from latice_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def cmd_quality(args) -> None:
    """Hough/Radon pattern-quality maps (`data.BandDetector`): the mean
    peak response of the detected bands is the Image Quality practitioners
    map; no indexing."""
    from latice_tpu_torch.data import BandDetector, prepare_patterns

    device = resolve_device(args.device)
    raw = _load_raw_pattern_stack(args)
    x = prepare_patterns(raw)
    h, w = x.shape[1], x.shape[2]

    t0 = time.time()
    det = BandDetector(
        height=h, width=w, n_theta=args.n_theta, n_rho=args.n_rho,
        k=args.bands, band_width_px=args.band_width,
        batch_size=args.batch_size, device=device,
    )
    res = det(x)
    dt = time.time() - t0
    iq = res.iq
    count = res.band_count
    if args.scan_grid:
        rows, cols = args.scan_grid
        if rows * cols != len(iq):
            raise SystemExit(f"--scan-grid {rows}x{cols} does not hold {len(iq)} patterns")
        iq = iq.reshape(rows, cols)
        count = count.reshape(rows, cols)
    prefix = args.out_prefix
    np.save(f"{prefix}_iq.npy", iq)
    np.savez(
        f"{prefix}_bands.npz",
        theta_deg=res.theta_deg,
        rho_px=res.rho_px,
        strength=res.strength,
        band_count=res.band_count,
    )
    summary = {
        "n_patterns": len(res.iq),
        "mean_iq": round(float(res.iq.mean()), 4),
        "min_iq": round(float(res.iq.min()), 4),
        "max_iq": round(float(res.iq.max()), 4),
        "mean_band_count": round(float(res.band_count.mean()), 2),
        "seconds": round(dt, 2),
        "outputs": [f"{prefix}_iq.npy", f"{prefix}_bands.npz"],
    }
    if args.iq_map:
        if not args.scan_grid:
            raise SystemExit("--iq-map needs --scan-grid ROWS COLS")
        try:
            import matplotlib.image as mpimg
        except ImportError:
            raise SystemExit(
                "--iq-map needs matplotlib, which is not installed; the IQ map is in "
                f"{prefix}_iq.npy"
            ) from None
        lo, hi = float(iq.min()), float(iq.max())
        mpimg.imsave(args.iq_map, (iq - lo) / max(hi - lo, 1e-9), cmap="gray")
        summary["iq_map"] = args.iq_map
    print(json.dumps(summary))


def _parse_hough_phase(spec: str, args) -> tuple:
    """Parse one ``--phase`` spec → ``(name, reflectors, group, (a,b,c))``.

    Two formats:

    * ``[NAME=]STRUCT:a[:c]`` — presets: ``fcc``/``bcc``/``sc`` (point
      group 432) and ``hcp`` (622, c defaults to 1.587·a). kv/max-hkl/
      min-d come from the shared CLI flags.
    * ``[NAME=]cell.json`` — arbitrary cell via `sim.reflectors_from_cell`
      (exact non-cubic metric + structure-factor extinctions). Keys:
      ``group`` and ``a`` required; ``b``, ``c``, ``alpha``, ``beta``,
      ``gamma``, ``basis`` (fractional positions), ``kv``, ``max_hkl``,
      ``min_d``, ``name`` optional (defaults: cubic angles, b=c=a,
      single-atom basis, the shared CLI flags).
    """
    from latice_tpu_torch.sim import cubic_reflectors, hexagonal_reflectors, reflectors_from_cell

    name = None
    head, sep, tail = spec.partition("=")
    if sep and not head.endswith(".json"):
        name, spec = head, tail
    if spec.endswith(".json"):
        cell = json.loads(Path(spec).read_text())
        missing = {"group", "a"} - set(cell)
        if missing:
            raise SystemExit(f"--phase {spec}: cell JSON must define {sorted(missing)}")
        a = float(cell["a"])
        b = float(cell.get("b", a))
        c = float(cell.get("c", a))
        refl = reflectors_from_cell(
            a=a, b=b, c=c,
            alpha=float(cell.get("alpha", 90.0)),
            beta=float(cell.get("beta", 90.0)),
            gamma=float(cell.get("gamma", 90.0)),
            basis=cell.get("basis", ((0.0, 0.0, 0.0),)),
            kv=float(cell.get("kv", args.kv)),
            max_hkl=int(cell.get("max_hkl", args.max_hkl)),
            min_d=float(cell.get("min_d", args.min_d)),
        )
        return (name or cell.get("name") or Path(spec).stem, refl, str(cell["group"]), (a, b, c))
    parts = spec.split(":")
    struct = parts[0]
    a = float(parts[1]) if len(parts) > 1 else args.lattice
    if struct == "hcp":
        c = float(parts[2]) if len(parts) > 2 else (args.lattice_c or 1.587 * a)
        refl = hexagonal_reflectors(a=a, c=c, kv=args.kv, max_hkl=args.max_hkl, min_d=args.min_d)
        return (name or struct, refl, "622", (a, a, c))
    if struct not in ("fcc", "bcc", "sc"):
        raise SystemExit(
            f"--phase {spec!r}: structure must be fcc/bcc/sc/hcp or a cell .json path"
        )
    refl = cubic_reflectors(struct, a=a, kv=args.kv, max_hkl=args.max_hkl, min_d=args.min_d)
    return (name or struct, refl, "432", (a, a, a))


def _structure_spec(args) -> str:
    """The single-phase ``--phase`` spec of ``--structure/--lattice[-c]``."""
    if args.structure == "hcp" and args.lattice_c:
        return f"{args.structure}:{args.lattice}:{args.lattice_c}"
    return f"{args.structure}:{args.lattice}"


def cmd_hough(args) -> None:
    """Band-based (Hough) orientation indexing (`index.HoughIndexer`): no
    training and no dictionary patterns, only reflector tables and the
    detector geometry. With several ``--phase`` specs the Radon scan runs
    once and every phase solves against the same bands
    (`index.MultiPhaseHoughIndexer`). ``--refine`` runs `sim.refine` on
    every pattern, failed ones included, seeded by the Hough solution."""
    from scipy.spatial.transform import Rotation as R

    from latice_tpu_torch.data import BandDetector, prepare_patterns
    from latice_tpu_torch.index import HoughIndexer, MultiPhaseHoughIndexer
    from latice_tpu_torch.index.pipeline import DenseIndexResult
    from latice_tpu_torch.sim import DetectorGeometry

    # Phase specs are parsed before the pattern load, so a bad one fails fast.
    specs = args.phase or [_structure_spec(args)]
    phases = [_parse_hough_phase(s, args) for s in specs]
    names = [p[0] for p in phases]
    groups = [p[2] for p in phases]
    lattices = [p[3] for p in phases]

    device = resolve_device(args.device)
    raw = _load_raw_pattern_stack(args)
    x = prepare_patterns(raw)
    h, w = x.shape[1], x.shape[2]

    geometry = DetectorGeometry(
        shape=(h, w), pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2], tilt=args.tilt
    )
    detector = BandDetector(
        height=h, width=w, n_theta=args.n_theta, n_rho=args.n_rho,
        k=args.bands, band_width_px=args.band_width,
        batch_size=args.batch_size, device=device,
    )
    common = dict(
        grid_resolution_deg=args.grid_resolution, n_bands=args.bands,
        tolerance_deg=args.tolerance, min_bands=args.min_bands,
        batch_size=args.batch_size, detector=detector,
    )
    t0 = time.time()
    if len(phases) > 1:
        indexer = MultiPhaseHoughIndexer([(p[1], p[2]) for p in phases], geometry, **common)
    else:
        indexer = HoughIndexer(phases[0][1], geometry, group=groups[0], **common)
    t_build = time.time() - t0
    t0 = time.time()
    res = indexer(x)
    dt = time.time() - t0
    n = len(res.success)
    phase_ids = res.phase if len(phases) > 1 else None
    logger.info(f"Hough-indexed {n} patterns in {dt:.2f}s ({n / max(dt, 1e-9):,.0f}/s)")
    refine_summary = {}
    if args.refine:
        # Sub-bin refinement through the renderer, seeded by the Hough
        # solution, with the reflector table that voted; multi-phase
        # refines each pattern against its winning phase's table.
        from latice_tpu_torch.crystal import reduce_to_fundamental_zone
        from latice_tpu_torch.sim import refine_orientations

        t0 = time.time()
        refined_q = np.asarray(res.quaternions, np.float64).copy()
        ncc = np.full(n, np.nan, np.float32)
        pid = phase_ids if phase_ids is not None else np.zeros(n, np.int64)
        for i, (_, refl, grp, _) in enumerate(phases):
            m = pid == i
            if not m.any():
                continue
            q, c = refine_orientations(
                x[m], refined_q[m].astype(np.float32), geometry, refl,
                steps=args.refine, device=device,
            )
            refined_q[m] = reduce_to_fundamental_zone(q.astype(np.float64), grp)
            ncc[m] = c
        eulers = np.mod(
            R.from_quat(np.roll(refined_q, -1, axis=1)).as_euler("zxz", degrees=True), 360.0
        )
        res = res._replace(quaternions=refined_q, eulers_deg=eulers)
        refine_summary = {
            "refine_steps": args.refine,
            "refine_ncc_median": round(float(np.nanmedian(ncc)), 4),
            "refine_seconds": round(time.time() - t0, 2),
        }
        logger.info(
            f"Refined {n} orientations in {refine_summary['refine_seconds']}s; "
            f"median NCC {refine_summary['refine_ncc_median']}"
        )
    np.save(args.out, res.eulers_deg)
    detail = dict(
        quaternions=res.quaternions,
        eulers_deg=res.eulers_deg,
        fit_deg=res.fit_deg,
        n_matched=res.n_matched,
        vote_score=res.vote_score,
        band_score=res.band_score,
        success=res.success,
        iq=res.bands.iq,
    )
    if phase_ids is not None:
        detail["phase"] = phase_ids
    np.savez(args.out.replace(".npy", "") + "_detail.npz", **detail)
    summary = {
        "n_patterns": n,
        "success_rate": float(res.success.mean()),
        "mean_fit_deg": round(float(res.fit_deg[res.success].mean()), 3)
        if res.success.any()
        else None,
        "mean_bands_matched": round(float(res.n_matched.mean()), 2),
        "build_seconds": round(t_build, 2),
        "seconds": round(dt, 2),
        "out": args.out,
        **refine_summary,
    }
    if phase_ids is not None:
        phase_out = args.out.replace(".npy", "") + "_phase.npy"
        np.save(phase_out, phase_ids)
        summary["phase_out"] = phase_out
        summary["phase_names"] = names
        summary["phase_counts"] = np.bincount(phase_ids, minlength=len(phases)).tolist()
    if args.ang or args.ctf:
        # The export plane's vocabulary: confidence = 1 - fit/tolerance,
        # the real Hough IQ.
        from latice_tpu_torch.data import write_ang, write_ctf

        conf = np.clip(1.0 - res.fit_deg / args.tolerance, 0.0, 1.0)
        dense = DenseIndexResult(
            mean_orientation=np.where(res.success[:, None], res.eulers_deg, np.nan),
            best_orientation=res.eulers_deg,
            success=res.success,
            n_similar=res.n_matched,
            indices=np.zeros((n, 1), np.int64),
            scores=conf[:, None],
            phase=phase_ids,
        )
        grid = tuple(args.scan_grid) if args.scan_grid else None
        header = dict(grid=grid, step=args.step, phase_names=names, phase_groups=groups,
                      phase_lattices=lattices)
        if args.ang:
            write_ang(args.ang, dense, iq=res.bands.iq, **header)
            summary["ang_out"] = args.ang
        if args.ctf:
            write_ctf(args.ctf, dense, **header)
            summary["ctf_out"] = args.ctf
    print(json.dumps(summary))


def register(sub, common) -> None:
    """Attach the quality and hough parsers."""
    qu = sub.add_parser(
        "quality",
        help="Hough/Radon band detection + Image Quality maps (no indexing)",
    )
    qu.add_argument("--patterns", required=True,
                    help=".npy stack, HDF5 scan or EDAX .up1/.up2")
    qu.add_argument("--h5-dataset", default=None,
                    help="HDF5 dataset path (default: the detected pattern stack)")
    qu.add_argument("--out-prefix", default="quality")
    qu.add_argument(
        "--scan-grid", type=int, nargs=2, metavar=("ROWS", "COLS"),
        default=None, help="reshape IQ to the scan map",
    )
    qu.add_argument("--bands", type=int, default=10,
                    help="bands detected per pattern (strongest first)")
    qu.add_argument("--band-width", type=float, default=8.0,
                    help="expected Kikuchi band width in pixels (butterfly plateau)")
    qu.add_argument("--n-theta", type=int, default=90)
    qu.add_argument("--n-rho", type=int, default=96)
    qu.add_argument("--batch-size", type=int, default=256)
    qu.add_argument(
        "--iq-map", default=None, metavar="OUT.png",
        help="also render the IQ map as a grayscale image (needs --scan-grid and matplotlib)",
    )
    qu.add_argument("--device", default=None, help="torch device (default: cuda)")
    qu.set_defaults(fn=cmd_quality)

    ho = sub.add_parser(
        "hough",
        help="band-based (Hough) orientation indexing: no training, no "
        "dictionary (the vendor OIM/AZtec algorithm)",
    )
    ho.add_argument("--patterns", required=True,
                    help=".npy stack, HDF5 scan or EDAX .up1/.up2")
    ho.add_argument("--h5-dataset", default=None,
                    help="HDF5 dataset path (default: the detected pattern stack)")
    ho.add_argument("--out", default="hough_orientations.npy")
    ho.add_argument(
        "--structure", default="fcc", choices=("fcc", "bcc", "sc", "hcp"),
        help="lattice/structure (hcp votes in point group 622)",
    )
    ho.add_argument(
        "--phase", action="append", default=None, metavar="[NAME=]SPEC",
        help="repeatable phase spec for multi-phase indexing: 'fcc:3.52', "
        "'hcp:2.95:4.68', or a cell .json path ({'group','a',...} via "
        "sim.reflectors_from_cell); overrides --structure/--lattice. The "
        "Radon scan runs once, every phase is scored against the same "
        "bands, the per-pixel best wins; phase ids (list positions) go to "
        "<out>_phase.npy and the .ang/.ctf phase column",
    )
    ho.add_argument("--lattice", type=float, default=3.52,
                    help="lattice parameter a, Angstrom (default: nickel)")
    ho.add_argument("--lattice-c", type=float, default=None,
                    help="hcp c parameter, Angstrom (default: 1.587*a)")
    ho.add_argument("--kv", type=float, default=20.0, help="beam kV")
    ho.add_argument(
        "--pc", type=float, nargs=3, default=(0.5, 0.5, 0.7),
        metavar=("PCX", "PCY", "DD"),
        help="pattern center + detector distance, detector-width units",
    )
    ho.add_argument("--tilt", type=float, default=0.0,
                    help="detector tilt about the horizontal axis, degrees")
    ho.add_argument("--max-hkl", type=int, default=3)
    ho.add_argument("--min-d", type=float, default=0.8,
                    help="drop reflectors with d-spacing below this (Angstrom)")
    ho.add_argument("--grid-resolution", type=float, default=3.0,
                    help="voting-grid mean spacing, degrees (refinement solves below it)")
    ho.add_argument("--bands", type=int, default=8, help="bands detected and used per pattern")
    ho.add_argument("--tolerance", type=float, default=3.0,
                    help="band-to-reflector residual counted as a match, degrees")
    ho.add_argument("--min-bands", type=int, default=4,
                    help="matched bands below which a pattern is marked unindexed")
    ho.add_argument("--band-width", type=float, default=8.0,
                    help="expected Kikuchi band width in pixels (butterfly plateau)")
    ho.add_argument("--n-theta", type=int, default=90)
    ho.add_argument("--n-rho", type=int, default=96)
    ho.add_argument("--batch-size", type=int, default=256)
    ho.add_argument(
        "--scan-grid", type=int, nargs=2, metavar=("ROWS", "COLS"),
        default=None, help="scan shape for .ang/.ctf x/y",
    )
    ho.add_argument("--step", type=float, default=1.0, help="scan step, um")
    ho.add_argument("--ang", default=None, help="also write a TSL .ang file")
    ho.add_argument("--ctf", default=None, help="also write a Channel .ctf file")
    ho.add_argument(
        "--refine", type=int, default=None, metavar="STEPS",
        help="autodiff sub-bin orientation refinement through the "
        "kinematical renderer, seeded by the Hough solution and using the "
        "same reflector tables that voted (multi-phase refines each pattern "
        "against its winning phase); 40 steps is typical",
    )
    ho.add_argument("--device", default=None, help="torch device (default: cuda)")
    ho.set_defaults(fn=cmd_hough)
