"""Shared helpers of the port's indexing CLI command modules."""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

# The raw-scan containers of the JAX package's CLI (data/h5io.py, data/up.py).
HDF5_EXTENSIONS = (".h5", ".hdf5", ".h5oina", ".oh5", ".hdf")
UP_EXTENSIONS = (".up1", ".up2")


def later_slice(what: str, slice_name: str) -> SystemExit:
    """The exit of a CLI option whose port waits for a later slice."""
    return SystemExit(
        f"{what} is not ported to latice_tpu_torch yet; it waits for a later slice "
        f"({slice_name})"
    )


def _load_model(checkpoint: str | None, inplanes: int, latent_dim: int, device):
    """The VAE from a reference-layout ``.pt``, or seeded random weights
    with a warning, on ``device`` in eval mode and at ``16-mixed`` (bf16
    autocast), the precision the JAX CLI builds its model at."""
    from latice_tpu_torch.models import VariationalAutoEncoderRawData, load_checkpoint

    if checkpoint:
        model = load_checkpoint(checkpoint, inplanes, latent_dim, device=device)
        logger.info(f"Loaded checkpoint from {checkpoint}")
    else:
        model = VariationalAutoEncoderRawData(inplanes, latent_dim)
        model.init_weights(torch.Generator().manual_seed(0)).to(device)
        logger.warning("No checkpoint given; using random weights")
    return model.set_precision("16-mixed").eval()


def _load_raw_pattern_stack(args) -> np.ndarray:
    """``args.patterns`` as an array: ``.npy`` stacks; HDF5 scans and EDAX
    UP files raise until slice E."""
    low = args.patterns.lower()
    if low.endswith(HDF5_EXTENSIONS):
        raise later_slice("reading HDF5 scans", "slice E")
    if low.endswith(UP_EXTENSIONS):
        raise later_slice("reading EDAX UP files", "slice E")
    return np.load(args.patterns)
