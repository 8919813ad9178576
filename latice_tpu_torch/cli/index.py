"""The port's indexing CLI: orientation grids, kinematical simulation,
dictionary build, latent export, batch indexing and pattern-space dictionary
indexing, on the GPU by default.

    # the native dictionary loop: a 2-degree cubic grid, its patterns, and
    # zero-training NCC indexing of a scan against them
    python -m latice_tpu_torch.cli.index sample --group 432 --resolution 2 \\
        --out grid.txt
    python -m latice_tpu_torch.cli.index simulate --angles grid.txt \\
        --out dict.npy --uint8
    python -m latice_tpu_torch.cli.index di --dict-patterns dict.npy \\
        --dict-angles grid.txt --patterns scan.npy --ang scan.ang

    # build a dictionary database from simulated patterns + angles
    python -m latice_tpu_torch.cli.index build --patterns dict.npy \\
        --angles angles.txt --checkpoint vae-best.pt --db latent_index.npz

    # index unknown patterns against it (--device cpu runs the kernels'
    # plain twins on the CPU)
    python -m latice_tpu_torch.cli.index query --patterns scan.npy \\
        --db latent_index.npz --checkpoint vae-best.pt --engine fused \\
        --out orientations.npy --ang scan.ang

    # NLPAR-denoise a 64x64 scan first, then refine each orientation
    # against the dictionary's forward model (its simulate provenance)
    python -m latice_tpu_torch.cli.index query --patterns scan.npy \\
        --db latent_index.npz --nlpar 1 --scan-grid 64 64 --refine 40

    # the band plane: Hough IQ maps, Hough indexing (no training, no
    # dictionary) and pattern-center calibration from its result
    python -m latice_tpu_torch.cli.index quality --patterns scan.npy \\
        --scan-grid 64 64 --out-prefix scan
    python -m latice_tpu_torch.cli.index hough --patterns scan.npy \\
        --out hough.npy --ang scan.ang --refine 40
    python -m latice_tpu_torch.cli.index calibrate --patterns scan.npy \\
        --orientations hough.npy --scan-grid 64 64

    # the master-pattern plane: a dictionary rendered from a master (its
    # bands fitted for --refine), a master learned from an indexed scan,
    # and dictionary-free spherical indexing against masters
    python -m latice_tpu_torch.cli.index simulate --angles grid.txt \\
        --master master.npy --fit-bands --out dict.npy
    python -m latice_tpu_torch.cli.index learn-master --patterns scan.npy \\
        --angles scan.ang --out learned.npy
    python -m latice_tpu_torch.cli.index sphere --patterns scan.npy \\
        --master fcc.npy --master hcp.npy --group 432 --group 622 --ang scan.ang

    # HR-EBSD: elastic strain and lattice rotation of every pattern of a
    # grain against a reference pattern in it (stress with --stiffness)
    python -m latice_tpu_torch.cli.index strain --patterns scan.up2 \\
        --ref 0 --stiffness ni --out strain.npz

    # the analysis plane on an indexed map: grains, KAM, grain statistics,
    # CSL boundaries, texture, Schmid/Taylor/Young's maps, GND density and
    # parent grains; .ang/.ctf files carry their grid and phases
    python -m latice_tpu_torch.cli.index analyze --orientations scan.ang \\
        --grain-stats --csl --schmid 0 0 1 --taylor --youngs ni \\
        --gnd 0.25 --components all --texture-index --clean 4

Every command that reads patterns takes a ``.npy`` stack, an HDF5 scan
(``--h5-dataset``, or the detected pattern stack) or an EDAX ``.up1``/``.up2``
file, whose header gives ``--scan-grid`` when the flag is absent; ``query``
streams such scans in ``--h5-chunk`` slabs. ``--checkpoint`` is a
reference-layout ``.pt`` state dict (a JAX checkpoint converts with
`models.flax_params_to_state_dict` and ``torch.save``); without one the
weights are random, drawn from a fixed seed. The model runs at ``16-mixed``
(bf16 autocast).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> None:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run the command."""
    from latice_tpu_torch.cli import (
        _analyze_cmds,
        _band_cmds,
        _db_cmds,
        _di_cmds,
        _sim_cmds,
        _sphere_cmds,
        _strain_cmds,
    )

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--checkpoint", default=None, help="reference-layout .pt state dict")
    common.add_argument("--db", default="latent_index.npz")
    common.add_argument("--inplanes", type=int, default=32)
    common.add_argument("--latent-dim", type=int, default=16)
    common.add_argument("--batch-size", type=int, default=256)
    common.add_argument("--device", default=None, help="torch device (default: cuda)")
    _db_cmds.register(sub, common)
    _sim_cmds.register(sub, common)
    _di_cmds.register(sub, common)
    _band_cmds.register(sub, common)
    _sphere_cmds.register(sub, common)
    _strain_cmds.register(sub, common)
    _analyze_cmds.register(sub, common)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    args.fn(args)


if __name__ == "__main__":
    main()
