"""``python -m latice_tpu_torch.cli.index sphere``: dictionary-free
spherical-harmonic indexing on the device, the port of
``latice_tpu/cli/_sphere_cmds.py``."""

from __future__ import annotations

import json
import logging
import time

import numpy as np

from latice_tpu_torch.cli._common import _load_raw_pattern_stack
from latice_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def cmd_sphere(args) -> None:
    """Spherical-harmonic indexing (`index.spherical`): a dictionary-free
    global SO(3) search. Needs only a master pattern (``learn-master``
    output, `sim.make_kinematical_master`, or an imported one) and the
    detector geometry: each pattern is back-projected onto the sphere and
    cross-correlated against the master over all orientations at once.
    Repeat ``--master`` for multi-phase indexing."""
    from latice_tpu_torch.index.pipeline import DenseIndexResult
    from latice_tpu_torch.index.spherical import (
        MultiPhaseSphericalIndexer,
        SphericalIndexerConfig,
    )
    from latice_tpu_torch.sim import DetectorGeometry

    device = resolve_device(args.device)
    masters = [np.load(p) for p in args.master]
    if args.master_layout == "square":
        from latice_tpu_torch.sim import resample_square_lambert

        masters = [resample_square_lambert(m) for m in masters]
    n_phases = len(masters)

    def _per_phase(values, fallback, flag):
        if not values:
            return [fallback] * n_phases
        if len(values) == 1:
            return list(values) * n_phases
        if len(values) != n_phases:
            raise SystemExit(
                f"{flag} given {len(values)} times for {n_phases} "
                f"--master flags (give it once to share, or once per "
                f"master)"
            )
        return list(values)

    groups = _per_phase(args.group, "432", "--group")
    # Flag-count errors surface before the (possibly minutes-long) run.
    names = _per_phase(args.phase_name, None, "--phase-name")
    names = [
        nm if nm is not None else f"phase{i + 1}"
        for i, nm in enumerate(names)
    ]
    lat_a = _per_phase(args.lattice, 3.52, "--lattice")
    lat_c = _per_phase(args.lattice_c, None, "--lattice-c")
    if (
        args.lattice_c
        and len(args.lattice_c) == 1
        and n_phases > 1
        and len(set(groups)) > 1
    ):
        logger.warning(
            "a single --lattice-c is broadcast to all %d phases with "
            "differing point groups (%s) — the shared c lands in every "
            "phase's lattice header; give --lattice-c once per --master "
            "if the phases differ",
            n_phases, "/".join(groups),
        )
    lattices = [
        (a, a, c if c is not None else a)
        for a, c in zip(lat_a, lat_c)
    ]

    raw = _load_raw_pattern_stack(args)
    if raw.ndim == 4:  # (rows, cols, H, W) scans flatten to a stack
        if not args.scan_grid:
            args.scan_grid = list(raw.shape[:2])
        raw = raw.reshape(-1, *raw.shape[2:])
    h, w = raw.shape[1], raw.shape[2]
    geometry = DetectorGeometry(
        shape=(h, w), pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2],
        tilt=args.tilt,
    )
    cfg = SphericalIndexerConfig(
        bandwidth=args.bandwidth,
        beta_count=args.beta_count,
        alpha_count=args.alpha_count,
        detector_bin=args.bin,
        chunk=args.batch_size,
        symmetry=groups[0],
        refine=not args.no_refine,
    )
    t0 = time.time()
    indexer = MultiPhaseSphericalIndexer(
        masters, geometry, cfg, symmetries=groups, device=device
    )
    t_build = time.time() - t0
    t0 = time.time()
    res = indexer.index_patterns(raw)
    dt = time.time() - t0
    n = len(res)
    logger.info(
        f"sphere-indexed {n} patterns in {dt:.2f}s "
        f"({n/max(dt, 1e-9):,.0f}/s; setup {t_build:.1f}s)"
    )
    np.save(args.out, res.eulers_deg)
    np.savez(
        args.out.replace(".npy", "") + "_detail.npz",
        quaternions=res.quaternions,
        eulers_deg=res.eulers_deg,
        scores=res.scores,
        phase=res.phase,
        phase_scores=res.phase_scores,
    )
    summary = {
        "n_patterns": n,
        "n_phases": n_phases,
        "bandwidth": args.bandwidth,
        # A scalar for one phase, a list per phase for several.
        "kept_degrees": (
            len(indexer.indexers[0]._l_keep)
            if n_phases == 1
            else [len(ix._l_keep) for ix in indexer.indexers]
        ),
        "mean_score": round(float(res.scores.mean()), 4),
        "build_seconds": round(t_build, 2),
        "seconds": round(dt, 2),
        "out": args.out,
    }
    if n_phases > 1:
        summary["phase_counts"] = np.bincount(
            res.phase, minlength=n_phases
        ).tolist()
    if args.ang or args.ctf:
        success = np.ones(n, bool)
        dense = DenseIndexResult(
            mean_orientation=res.eulers_deg.astype(np.float64),
            best_orientation=res.eulers_deg.astype(np.float64),
            success=success,
            n_similar=np.ones(n, np.int64),
            indices=np.zeros((n, 1), np.int64),
            scores=res.scores[:, None].astype(np.float64),
            phase=res.phase,
        )
        grid = tuple(args.scan_grid) if args.scan_grid else None
        if args.ang:
            from latice_tpu_torch.data import write_ang

            write_ang(args.ang, dense, grid=grid, step=args.step,
                      phase_names=names, phase_groups=groups,
                      phase_lattices=lattices)
            summary["ang_out"] = args.ang
        if args.ctf:
            from latice_tpu_torch.data import write_ctf

            write_ctf(args.ctf, dense, grid=grid, step=args.step,
                      phase_names=names, phase_groups=groups,
                      phase_lattices=lattices)
            summary["ctf_out"] = args.ctf
    if args.ambiguity:
        # The secondary-peak pseudo-symmetry diagnostic (same npz and
        # vocabulary as `query --ambiguity`), against the FIRST master:
        # the rival search reads one master's correlation volume.
        if n_phases > 1:
            logger.warning(
                "--ambiguity with %d masters diagnoses orientation "
                "pseudo-symmetry against the FIRST master only (phase "
                "ambiguity is already in phase_scores)", n_phases,
            )
        amb = indexer.indexers[0].ambiguity(
            raw, min_separation_deg=args.ambiguity_separation,
        )
        np.savez(
            args.ambiguity,
            angle_deg=amb.angle_deg,
            score_gap=amb.score_gap,
            has_rival=amb.has_rival,
        )
        flagged = amb.ambiguous(max_gap=args.ambiguity_gap)
        summary["ambiguity_out"] = args.ambiguity
        summary["ambiguous_frac"] = round(float(flagged.mean()), 4)
        logger.info(
            f"{flagged.sum()} / {len(flagged)} pixels ambiguous "
            f"(rival SO(3) peak within {args.ambiguity_gap} correlation "
            f"score)"
        )
    print(json.dumps(summary))




def register(sub, common) -> None:
    """Attach this module's subcommand parser(s)."""
    sp = sub.add_parser(
        "sphere",
        help="spherical-harmonic indexing against a master pattern — "
        "dictionary-free global SO(3) search (the EMSphInx role)",
    )
    sp.add_argument(
        "--patterns", required=True,
        help=".npy stack, HDF5 scan or EDAX .up1/.up2",
    )
    sp.add_argument("--h5-dataset", default=None,
                    help="HDF5 dataset path (default: the detected pattern stack)")
    sp.add_argument(
        "--master", required=True, action="append",
        help="master image .npy (learn-master output, or an external "
        "master — see --master-layout); repeat the flag for multi-phase "
        "indexing (per-pattern phase = highest correlation peak)",
    )
    sp.add_argument(
        "--master-layout", choices=("circle", "square"), default="circle",
        help="'square' imports square-Lambert (EMsoft-style) masters "
        "(applies to every --master)",
    )
    sp.add_argument("--out", default="sphere_orientations.npy")
    sp.add_argument(
        "--bandwidth", type=int, default=64,
        help="harmonic band limit L (~180/L deg grid before the "
        "sub-grid peak interpolation; default: %(default)s)",
    )
    sp.add_argument(
        "--beta-count", type=int, default=None,
        help="SO(3) grid points over beta (default 2L)",
    )
    sp.add_argument(
        "--alpha-count", type=int, default=None,
        help="SO(3) grid points over alpha/gamma (default 2L)",
    )
    sp.add_argument(
        "--bin", type=int, default=2,
        help="detector mean-pool factor before projection",
    )
    sp.add_argument(
        "--group", default=None, action="append",
        help="proper point group for the fundamental-zone reduction "
        "(default 432); repeat per --master, or give once to share",
    )
    sp.add_argument(
        "--no-refine", action="store_true",
        help="disable the parabolic sub-grid peak interpolation",
    )
    sp.add_argument(
        "--pc", type=float, nargs=3, default=(0.5, 0.5, 0.7),
        metavar=("PCX", "PCY", "DD"),
        help="pattern center + detector distance, detector-width units",
    )
    sp.add_argument(
        "--tilt", type=float, default=0.0,
        help="detector tilt about the horizontal axis, degrees",
    )
    sp.add_argument("--batch-size", type=int, default=64,
                    help="patterns per device pass (the correlation chunk)")
    sp.add_argument(
        "--phase-name", default=None, action="append",
        help="phase name(s) written to .ang/.ctf headers — repeat per "
        "--master (default phase1, phase2, ...)",
    )
    sp.add_argument(
        "--lattice", type=float, default=None, action="append",
        help="lattice parameter a for .ang/.ctf headers, Angstrom — "
        "repeat per --master (default 3.52)",
    )
    sp.add_argument(
        "--lattice-c", type=float, default=None, action="append",
        help="c parameter for .ang/.ctf headers (default: a) — repeat "
        "per --master",
    )
    sp.add_argument(
        "--scan-grid", type=int, nargs=2, metavar=("ROWS", "COLS"),
        default=None, help="scan shape for .ang/.ctf x/y (UP autofills)",
    )
    sp.add_argument("--step", type=float, default=1.0, help="scan step, um")
    sp.add_argument("--ang", default=None, help="also write a TSL .ang file")
    sp.add_argument(
        "--ctf", default=None, help="also write a Channel .ctf file"
    )
    sp.add_argument(
        "--ambiguity", default=None, metavar="OUT.npz",
        help="write the secondary-SO(3)-peak pseudo-symmetry diagnostic "
        "(per-pixel angle and correlation-score gap to the best "
        "genuinely different basin; same vocabulary as `query "
        "--ambiguity`) and report the ambiguous fraction",
    )
    sp.add_argument(
        "--ambiguity-gap", type=float, default=0.02,
        help="score margin under which a rival basin counts as ambiguous "
        "(default: %(default)s)",
    )
    sp.add_argument(
        "--ambiguity-separation", type=float, default=None,
        help="disorientation (deg) below which a cell belongs to the "
        "winner's own basin (default: 2x the SO(3) grid spacing, "
        "2*180/L)",
    )
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_sphere)

