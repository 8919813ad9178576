"""The port's indexing CLI: dictionary build, latent export and batch
indexing, on the GPU by default.

    # build a dictionary database from simulated patterns + angles
    python -m latice_tpu_torch.cli.index build --patterns dict.npy \\
        --angles angles.txt --checkpoint vae-best.pt --db latent_index.npz

    # index unknown patterns against it (--device cpu runs the kernels'
    # plain twins on the CPU)
    python -m latice_tpu_torch.cli.index query --patterns scan.npy \\
        --db latent_index.npz --checkpoint vae-best.pt --engine fused \\
        --out orientations.npy --ang scan.ang

``--checkpoint`` is a reference-layout ``.pt`` state dict (a JAX checkpoint
converts with `models.flax_params_to_state_dict` and ``torch.save``);
without one the weights are random, drawn from a fixed seed. The model runs
at ``16-mixed`` (bf16 autocast). The other commands of the JAX package's
``index.py`` wait for later slices.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> None:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run the command."""
    from latice_tpu_torch.cli import _db_cmds

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
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    args.fn(args)


if __name__ == "__main__":
    main()
