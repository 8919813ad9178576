"""``python -m latice_tpu_torch.cli.index sample/simulate``: the simulation
plane, the port of ``latice_tpu/cli/_sim_cmds.py``. ``simulate --master``,
``--fit-bands``, ``master`` and ``learn-master`` wait for the master-pattern
modules of a later slice."""

from __future__ import annotations

import json
import time

import numpy as np

from latice_tpu_torch.cli._common import later_slice
from latice_tpu_torch.device import resolve_device


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


def cmd_simulate(args) -> None:
    """Render a kinematical dictionary stack from an anglefile on the device
    (`sim.simulate_patterns`), with a ``.simmeta.json`` provenance sidecar
    that ``build`` copies into the npz for ``query --refine``."""
    from latice_tpu_torch.data import parse_angle_file
    from latice_tpu_torch.sim import (
        DetectorGeometry,
        cubic_reflectors,
        hexagonal_reflectors,
        simulate_patterns,
    )

    if args.master or args.fit_bands:
        raise later_slice("simulate --master and --fit-bands", "slice D")
    device = resolve_device(args.device)
    eulers = parse_angle_file(args.angles)
    geometry = DetectorGeometry(
        shape=(args.size, args.size), pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2],
        tilt=args.tilt,
    )
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


def cmd_master_planes(args) -> None:
    raise later_slice(args.cmd, "slice D")


def register(sub, common) -> None:
    """Attach the sample and simulate parsers, and the master commands that
    wait for a later slice."""
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
    m.add_argument("--master", default=None, metavar="MASTER.npy",
                   help="render from a master pattern (waits for slice D)")
    m.add_argument("--master-layout", default="circle", choices=("circle", "square"),
                   help="--master image layout (slice D)")
    m.add_argument("--fit-bands", action="store_true",
                   help="with --master: fit the band model to the master (slice D)")
    m.add_argument("--device", default=None, help="torch device (default: cuda)")
    m.set_defaults(fn=cmd_simulate)

    for name, text in (("master", "compute a dynamical (Bloch-wave) master pattern"),
                       ("learn-master", "learn a master pattern from indexed patterns")):
        p = sub.add_parser(name, help=f"{text} (waits for slice D)")
        p.set_defaults(fn=cmd_master_planes, takes_any_arguments=True)
