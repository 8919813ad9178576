"""``python -m latice_tpu_torch.cli.index sample/simulate/learn-master``:
the simulation plane, the port of ``latice_tpu/cli/_sim_cmds.py``.
``simulate --master [--fit-bands]`` renders from a master pattern on the
device, ``learn-master`` learns one from indexed patterns, and ``master``
computes the dynamical Bloch-wave master (``--mc``: Monte-Carlo weighted)."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np

from latice_tpu_torch.cli._common import _load_raw_pattern_stack, mesh_from_flag
from latice_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def cmd_sample(args) -> None:
    """Write an anglefile of a quasi-uniform grid over a point group's
    fundamental zone (`crystal.sample_fundamental_zone`), consumable by
    ``build --angles``, ``simulate --angles`` and ``di --dict-angles``."""
    from scipy.spatial.transform import Rotation as R

    from latice_tpu_torch.crystal import sample_fundamental_zone, write_anglefile

    # The grid is host numpy; the device is resolved as in every command,
    # so a machine without the card it names is refused here too.
    resolve_device(args.device)
    quats = sample_fundamental_zone(args.group, args.resolution)
    eulers = R.from_quat(np.roll(quats, -1, axis=1)).as_euler("zxz", degrees=True)
    write_anglefile(args.out, eulers)
    print(
        json.dumps(
            {
                "n_orientations": len(eulers),
                "group": args.group,
                "resolution_deg": args.resolution,
                "out": args.out,
            }
        )
    )


def _fit_master_bands(args, master_img):
    """Fit the differentiable band model to a master image (`sim.master_fit`)
    for refinement provenance. The candidate band geometry comes from the
    master's own ``.mastermeta.json`` phase record when there is one, else
    from the structure and lattice flags under ``--fit-bands``; returns
    ``(Reflectors, fit_ncc, source)``, or None when neither applies.
    Candidates use the Bravais sublattice (fcc for zincblende, hcp for
    wurtzite): lattice-type extinctions are exact master zeros, and the fit
    measures what the basis adds."""
    from latice_tpu_torch.sim import (
        cubic_reflectors,
        fit_reflectors_to_master,
        hexagonal_reflectors,
    )

    mm = Path(args.master + ".mastermeta.json")
    if mm.exists():
        meta = json.loads(mm.read_text())
        structure = meta["structure"]
        a, kv, c = meta["lattice"], meta["kv"], meta.get("lattice_c")
        max_hkl = min(int(meta.get("max_hkl", 4)), 5)
        min_d = max(float(meta.get("min_d", 0.5)), 0.45)
        source = "mastermeta"
    elif args.fit_bands:
        structure = args.structure
        a, kv, c = args.lattice, args.kv, args.lattice_c
        max_hkl, min_d = args.max_hkl, max(args.min_d, 0.45)
        source = "cli_args"
    else:
        return None
    if structure in ("hcp", "wurtzite"):
        c = c or (1.587 if structure == "hcp" else 1.626) * a
        cand = hexagonal_reflectors(a=a, c=c, kv=kv, max_hkl=max_hkl, min_d=min_d)
    else:
        cand = cubic_reflectors("fcc" if structure == "zincblende" else structure,
                                a=a, kv=kv, max_hkl=max_hkl, min_d=min_d)
    fitted, ncc = fit_reflectors_to_master(np.asarray(master_img), cand)
    logger.info(f"Fitted {len(fitted)} bands to master (source: {source}, NCC {ncc:.3f}); "
                "refinement provenance persisted")
    return fitted, ncc, source


def _simulate_master(args, eulers, geometry, device) -> None:
    """``simulate --master``: render by lookup into a master image on the
    device (`sim.render_from_master`), with ``kind: master_fit`` provenance
    when the band model is fitted to the master."""
    from latice_tpu_torch.sim import render_from_master, resample_square_lambert

    t0 = time.time()
    master_img = np.load(args.master)
    if args.master_layout == "square":
        master_img = resample_square_lambert(master_img)  # one-time import
    patterns = render_from_master(master_img, eulers, geometry, device=device)
    if args.uint8:
        patterns = np.round(patterns * 255.0).astype(np.uint8)
    dt = time.time() - t0
    out_path = args.out if args.out.endswith(".npy") else args.out + ".npy"
    np.save(out_path, patterns)
    summary = {
        "n_patterns": len(patterns),
        "shape": list(patterns.shape[1:]),
        "master": args.master,
        "seconds": round(dt, 2),
        "out": args.out,
    }
    fit = _fit_master_bands(args, master_img)
    if fit is not None:
        fitted, fit_ncc, source = fit
        meta = {
            "kind": "master_fit",
            "master": args.master,
            "fit_source": source,
            "fit_ncc": round(fit_ncc, 4),
            "size": args.size,
            "pc": list(args.pc),
            "tilt": args.tilt,
            "fitted_bands": {
                "normals": fitted.normals.tolist(),
                "sin_theta": fitted.sin_theta.tolist(),
                "intensity": fitted.intensity.tolist(),
            },
        }
        with open(out_path + ".simmeta.json", "w") as f:
            json.dump(meta, f)
        summary.update(fit_ncc=round(fit_ncc, 4), n_fitted_bands=len(fitted),
                       refine_provenance=True)
    print(json.dumps(summary))


def cmd_simulate(args) -> None:
    """Render a dictionary stack from an anglefile on the device: the
    kinematical band model (`sim.simulate_patterns`), or with ``--master``
    a lookup into a master image. A ``.simmeta.json`` provenance sidecar,
    which ``build`` copies into the npz, lets ``query --refine`` rebuild the
    forward model (for a master, when its bands are fitted)."""
    from latice_tpu_torch.data import parse_angle_file
    from latice_tpu_torch.sim import (
        DetectorGeometry,
        cubic_reflectors,
        hexagonal_reflectors,
        simulate_patterns,
    )

    device = resolve_device(args.device)
    eulers = parse_angle_file(args.angles)
    geometry = DetectorGeometry(
        shape=(args.size, args.size), pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2],
        tilt=args.tilt,
    )
    if args.master:
        _simulate_master(args, eulers, geometry, device)
        return
    if args.structure == "hcp":
        c = args.lattice_c if args.lattice_c else 1.587 * args.lattice
        reflectors = hexagonal_reflectors(
            a=args.lattice, c=c, kv=args.kv, max_hkl=args.max_hkl, min_d=args.min_d
        )
    else:
        reflectors = cubic_reflectors(
            args.structure, a=args.lattice, kv=args.kv, max_hkl=args.max_hkl, min_d=args.min_d
        )
    t0 = time.time()
    patterns = simulate_patterns(
        eulers, geometry, reflectors, dtype=np.uint8 if args.uint8 else np.float32,
        device=device,
    )
    dt = time.time() - t0
    # np.save appends .npy when missing; the sidecar sits next to the file.
    out_path = args.out if args.out.endswith(".npy") else args.out + ".npy"
    np.save(out_path, patterns)
    meta = {
        "structure": args.structure,
        "lattice": args.lattice,
        "lattice_c": args.lattice_c,
        "kv": args.kv,
        "size": args.size,
        "pc": list(args.pc),
        "tilt": args.tilt,
        "max_hkl": args.max_hkl,
        "min_d": args.min_d,
    }
    with open(out_path + ".simmeta.json", "w") as f:
        json.dump(meta, f)
    print(
        json.dumps(
            {
                "n_patterns": len(patterns),
                "shape": list(patterns.shape[1:]),
                "n_reflectors": len(reflectors),
                "structure": args.structure,
                "seconds": round(dt, 2),
                "out": args.out,
            }
        )
    )


def cmd_learn_master(args) -> None:
    """Learn a master pattern FROM indexed patterns on the device
    (`sim.master_from_patterns`), the inverse of ``simulate --master``: the
    orientations of any indexing plane (an anglefile, or the ``.ang`` any of
    them exports) back-project the patterns into a master estimate, which
    then feeds ``sphere`` or ``simulate --master`` as a simulated one
    would."""
    from latice_tpu_torch.data import parse_angle_file, read_ang
    from latice_tpu_torch.sim import DetectorGeometry, master_from_patterns

    device = resolve_device(args.device)
    raw = _load_raw_pattern_stack(args)
    if raw.ndim == 4:
        raw = raw.reshape(-1, *raw.shape[2:])
    if args.angles.endswith(".ang"):
        eulers = read_ang(args.angles).eulers
    else:
        eulers = parse_angle_file(args.angles)
    h, w = raw.shape[1], raw.shape[2]
    geometry = DetectorGeometry(
        shape=(h, w), pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2], tilt=args.tilt
    )
    t0 = time.time()
    master, weights = master_from_patterns(
        raw, eulers, geometry, size=args.size, group=args.group or None, device=device
    )
    dt = time.time() - t0
    np.save(args.out, master)
    covered = float((weights > 1e-9).mean())
    logger.info(f"learned ({args.size}, {args.size}) master from {len(raw)} patterns in "
                f"{dt:.1f}s; bin coverage {covered:.1%}")
    print(json.dumps({
        "n_patterns": int(len(raw)),
        "size": args.size,
        "group": args.group,
        "coverage": round(covered, 4),
        "seconds": round(dt, 2),
        "out": args.out,
    }))


def _master_structure(args):
    """The `sim.dynamical` structure the ``master`` flags name."""
    from latice_tpu_torch.sim import (
        cubic_structure,
        hexagonal_structure,
        wurtzite_structure,
        zincblende_structure,
    )

    def species(tok):
        tok = tok.strip()
        return int(tok) if tok.isdigit() else tok

    parts = [species(t) for t in args.element.split(",")]
    two_species = args.structure in ("zincblende", "wurtzite")
    if two_species and len(parts) != 2:
        raise SystemExit(
            f"--structure {args.structure} needs --element CATION,ANION "
            f"(e.g. 'ga,as'); got {args.element!r}"
        )
    if not two_species and len(parts) != 1:
        raise SystemExit(
            f"--structure {args.structure} takes a single --element; got {args.element!r}"
        )
    if args.structure == "hcp":
        c = args.lattice_c if args.lattice_c else 1.587 * args.lattice
        return hexagonal_structure(parts[0], a=args.lattice, c=c, debye_waller=args.debye_waller)
    if args.structure == "zincblende":
        return zincblende_structure(
            parts[0], parts[1], a=args.lattice, debye_waller=args.debye_waller
        )
    if args.structure == "wurtzite":
        c = args.lattice_c if args.lattice_c else 1.626 * args.lattice
        return wurtzite_structure(
            parts[0], parts[1], a=args.lattice, c=c, u=args.wurtzite_u,
            debye_waller=args.debye_waller,
        )
    return cubic_structure(
        args.structure, parts[0], a=args.lattice, debye_waller=args.debye_waller
    )


def cmd_master(args) -> None:
    """Compute a dynamical (Bloch-wave) master pattern on the device.

    The output feeds ``simulate --master`` (sim.master's equal-area
    convention), so ``sample`` → ``master`` → ``simulate --master`` →
    ``build`` → ``query`` makes dynamical-profile dictionaries with no
    external simulation package (`sim.dynamical` has the model). With
    ``--mc`` a Monte-Carlo backscatter simulation replaces the exponential
    depth profile (`sim.montecarlo`). Writes the same ``.npy``,
    ``.mastermeta.json`` and summary line as the JAX CLI."""
    from latice_tpu_torch.sim import dynamical_beams, dynamical_master_pattern

    mesh = mesh_from_flag(args.devices, args.device, "master generation")
    device = resolve_device(args.device)
    structure = _master_structure(args)
    beams = dynamical_beams(
        structure, kv=args.kv, n_beams=args.beams, max_hkl=args.max_hkl, min_d=args.min_d
    )
    mc_meta = {}
    t0 = time.time()
    if args.mc:
        from latice_tpu_torch.sim import mc_weighted_master_pattern, simulate_bse_monte_carlo

        mc = simulate_bse_monte_carlo(
            structure, kv=args.kv, tilt_deg=args.tilt, n_electrons=args.mc_electrons,
            energy_bins=args.mc_energy_bins, depth_bins=args.mc_depth_bins, mesh=mesh,
            device=device,
        )
        logger.info(f"MC: eta={mc.bse_yield:.3f}, depth p90 "
                    f"{float(np.percentile(mc.max_depth_nm, 90)):.0f} nm")
        img = mc_weighted_master_pattern(
            structure, mc, size=args.size, n_beams=args.beams,
            absorption_ratio=args.absorption, max_hkl=args.max_hkl, min_d=args.min_d,
            mesh=mesh, device=device,
        )
        mc_meta = {
            "mc": True,
            "mc_electrons": args.mc_electrons,
            "mc_tilt_deg": args.tilt,
            "mc_bse_yield": round(mc.bse_yield, 4),
            "mc_energy_weights": [round(float(w), 4) for w in mc.energy_weights],
            "mc_energy_edges_kev": [round(float(e), 3) for e in mc.energy_edges_kev],
        }
    else:
        img = dynamical_master_pattern(
            structure, kv=args.kv, size=args.size, depth_nm=args.depth_nm,
            absorption_ratio=args.absorption, beams=beams, mesh=mesh, device=device,
        )
    dt = time.time() - t0
    out_path = args.out if args.out.endswith(".npy") else args.out + ".npy"
    np.save(out_path, img)
    meta = {
        "kind": "dynamical_master",
        "structure": args.structure,
        "centrosymmetric": bool(beams.is_centrosymmetric),
        "element": args.element,
        "lattice": args.lattice,
        "lattice_c": args.lattice_c,
        "kv": args.kv,
        "size": args.size,
        "n_beams": len(beams),
        "depth_nm": args.depth_nm,
        "absorption_ratio": args.absorption,
        "max_hkl": args.max_hkl,
        "min_d": args.min_d,
        "convention": "sim.master equal-area north hemisphere",
        **mc_meta,
    }
    with open(out_path + ".mastermeta.json", "w") as f:
        json.dump(meta, f)
    summary = {
        "size": args.size,
        "n_beams": len(beams),
        "mean_inner_potential": round(beams.u0, 6),
        "seconds": round(dt, 2),
        "out": out_path,
    }
    if args.mc:
        summary["mc_bse_yield"] = mc_meta["mc_bse_yield"]
    print(json.dumps(summary))


def register(sub, common) -> None:
    """Attach the sample, simulate, master and learn-master parsers."""
    s = sub.add_parser("sample", help="generate a dictionary orientation grid (anglefile)")
    s.add_argument(
        "--group", default="432",
        help="proper point group of the phase (crystal.ROTATION_GROUPS key)",
    )
    s.add_argument(
        "--resolution", type=float, default=2.0,
        help="target mean nearest-neighbour misorientation between grid "
        "points, degrees (default: %(default)s)",
    )
    s.add_argument("--out", default="anglefile.txt")
    s.add_argument("--device", default=None, help="torch device (default: cuda)")
    s.set_defaults(fn=cmd_sample)

    m = sub.add_parser("simulate", help="render a kinematical dictionary stack from an anglefile")
    m.add_argument("--angles", required=True, help="anglefile (see 'sample')")
    m.add_argument("--out", default="dict_patterns.npy")
    m.add_argument(
        "--structure", default="fcc", choices=("fcc", "bcc", "sc", "hcp"),
        help="lattice/structure (hcp uses point group 622 at query time)",
    )
    m.add_argument(
        "--lattice", type=float, default=3.52,
        help="lattice parameter a, Angstrom (default: nickel)",
    )
    m.add_argument(
        "--lattice-c", type=float, default=None,
        help="hcp c parameter, Angstrom (default: 1.587*a)",
    )
    m.add_argument("--kv", type=float, default=20.0, help="beam kV")
    m.add_argument("--size", type=int, default=128, help="detector px")
    m.add_argument(
        "--pc", type=float, nargs=3, default=(0.5, 0.5, 0.7), metavar=("PCX", "PCY", "DD"),
        help="pattern center + detector distance, detector-width units",
    )
    m.add_argument("--tilt", type=float, default=0.0,
                   help="detector tilt about the horizontal axis, degrees")
    m.add_argument("--max-hkl", type=int, default=3)
    m.add_argument(
        "--min-d", type=float, default=0.8,
        help="drop reflectors with d-spacing below this (Angstrom)",
    )
    m.add_argument(
        "--uint8", action="store_true",
        help="write detector-native 8-bit patterns (4x smaller; the index "
        "planes take uint8 as it is and divide on the device)",
    )
    m.add_argument(
        "--master", default=None, metavar="MASTER.npy",
        help="render by lookup into a hemisphere master image (sim.master's "
        "equal-area convention) instead of the kinematical band model; refinement "
        "provenance is band-fitted from <master>.mastermeta.json when present, or "
        "from the structure/lattice args under --fit-bands",
    )
    m.add_argument(
        "--master-layout", default="circle", choices=("circle", "square"),
        help="--master image layout: 'circle' (sim.master's convention) or 'square' "
        "(square-Lambert, EMsoft-style; resampled on load)",
    )
    m.add_argument(
        "--fit-bands", action="store_true",
        help="with --master: fit the differentiable band model to the master from the "
        "structure/lattice flags and persist it as refinement provenance, so "
        "`query --refine` works on this dictionary",
    )
    m.add_argument("--device", default=None, help="torch device (default: cuda)")
    m.set_defaults(fn=cmd_simulate)

    dm = sub.add_parser("master", help="compute a dynamical (Bloch-wave) master pattern")
    dm.add_argument("--out", default="master.npy")
    dm.add_argument(
        "--structure", default="fcc",
        choices=("fcc", "bcc", "sc", "hcp", "zincblende", "wurtzite"),
        help="zincblende/wurtzite are non-centrosymmetric (complex-Hermitian Bloch path) "
        "and take --element CATION,ANION",
    )
    dm.add_argument(
        "--element", default="ni",
        help="element symbol or atomic number; for zincblende/wurtzite a 'cation,anion' "
        "pair, e.g. 'ga,as' (default: %(default)s)",
    )
    dm.add_argument("--lattice", type=float, default=3.52,
                    help="lattice parameter a, Angstrom (default: nickel)")
    dm.add_argument(
        "--lattice-c", type=float, default=None,
        help="hcp/wurtzite c parameter, Angstrom (default: 1.587*a hcp, 1.626*a wurtzite)",
    )
    dm.add_argument("--wurtzite-u", type=float, default=0.377,
                    help="wurtzite internal anion parameter u (ideal 3/8)")
    dm.add_argument("--kv", type=float, default=20.0, help="beam kV")
    dm.add_argument("--size", type=int, default=201,
                    help="master image edge, pixels (default: %(default)s)")
    dm.add_argument(
        "--beams", type=int, default=64,
        help="Bloch beam budget (whole reflection families only; the realized count is "
        "reported)",
    )
    dm.add_argument("--depth-nm", type=float, default=50.0,
                    help="backscatter generation depth scale z0, nm")
    dm.add_argument("--absorption", type=float, default=0.1,
                    help="imaginary/real potential ratio kappa (0.05-0.15 typical)")
    dm.add_argument("--debye-waller", type=float, default=0.35,
                    help="isotropic Debye-Waller B, Angstrom^2")
    dm.add_argument("--max-hkl", type=int, default=5)
    dm.add_argument("--min-d", type=float, default=0.4,
                    help="reflection sweep d-spacing floor, Angstrom")
    dm.add_argument(
        "--mc", action="store_true",
        help="replace the exponential depth profile with a Monte-Carlo backscatter "
        "simulation (sim.montecarlo): one Bloch master per exit-energy bin with the bin's "
        "measured generation-depth distribution, summed by electron weight. --depth-nm is "
        "then ignored.",
    )
    dm.add_argument("--mc-electrons", type=int, default=200_000,
                    help="with --mc: incident electrons traced (default: %(default)s)")
    dm.add_argument(
        "--mc-energy-bins", type=int, default=8,
        help="with --mc: exit-energy bins (each kept bin costs one Bloch master solve; bins "
        "under 2%% weight fold into neighbors)",
    )
    dm.add_argument("--mc-depth-bins", type=int, default=40,
                    help="with --mc: generation-depth histogram bins")
    dm.add_argument("--tilt", type=float, default=70.0,
                    help="with --mc: sample tilt from the beam, degrees (EBSD: 70)")
    dm.add_argument(
        "--devices", type=int, default=0,
        help="shard master generation over this many devices (ignored with a warning "
        "when fewer cards are attached; N CPU entries with --device cpu)",
    )
    dm.add_argument("--device", default=None, help="torch device (default: cuda)")
    dm.set_defaults(fn=cmd_master)

    lm = sub.add_parser(
        "learn-master",
        help="learn a master pattern FROM indexed patterns (inverse of `simulate "
        "--master`; feeds `sphere` / `simulate --master` like a simulated one)",
    )
    lm.add_argument("--patterns", required=True,
                    help=".npy stack, HDF5 scan or EDAX .up1/.up2")
    lm.add_argument("--h5-dataset", default=None,
                    help="HDF5 dataset path (default: the detected pattern stack)")
    lm.add_argument(
        "--angles", required=True,
        help="orientations of the patterns: anglefile (zxz degrees; `sample`/`query` "
        "output) or a .ang file from any indexing plane",
    )
    lm.add_argument("--out", default="learned_master.npy")
    lm.add_argument("--size", type=int, default=257, help="master image edge, px")
    lm.add_argument(
        "--group", default="432",
        help="proper point group: the estimate is symmetrized over its orbit (pass an "
        "empty string to skip)",
    )
    lm.add_argument(
        "--pc", type=float, nargs=3, default=(0.5, 0.5, 0.7), metavar=("PCX", "PCY", "DD"),
        help="pattern center + detector distance, detector-width units",
    )
    lm.add_argument("--tilt", type=float, default=0.0,
                    help="detector tilt about the horizontal axis, degrees")
    lm.add_argument("--device", default=None, help="torch device (default: cuda)")
    lm.set_defaults(fn=cmd_learn_master, scan_grid=None)
