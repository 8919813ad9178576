"""Shared helpers of the port's indexing CLI command modules."""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def mesh_from_flag(n: int | None, device, what: str):
    """The mesh of a ``--devices N`` flag, or None.

    N <= 1 (or unset) runs on one device. On cards: a mesh over the first N
    attached cards, or, with fewer attached, the JAX CLI's warning and one
    device. With ``--device cpu``: a mesh of N CPU entries, the counterpart
    of the JAX package's virtual CPU devices.
    """
    if not n or n <= 1:
        return None
    from latice_tpu_torch.parallel import make_mesh

    if torch.device(device or "cuda").type == "cpu":
        mesh = make_mesh(n, devices=["cpu"] * n)
    else:
        attached = torch.cuda.device_count()
        if attached < n:
            logger.warning(f"--devices {n} ignored: only {attached} attached")
            return None
        mesh = make_mesh(n)
    logger.info(f"sharding {what} over {mesh.size} devices")
    return mesh


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


@contextlib.contextmanager
def _open_scan(args):
    """``args.patterns`` as ``(patterns, batches)`` while the block runs: an
    indexable ``(N, H, W)`` HDF5 dataset or UP memmap and the function that
    yields its slabs of ``--h5-chunk`` rows (the file is closed on exit); or
    ``(stack, None)`` for a ``.npy`` stack, read whole. A UP header fills
    ``args.scan_grid`` when the flag is absent."""
    from latice_tpu_torch.data import (
        HDF5_EXTENSIONS,
        UP_EXTENSIONS,
        find_pattern_dataset,
        iter_pattern_batches,
        iter_up_batches,
        open_up_patterns,
    )

    low = args.patterns.lower()
    if low.endswith(HDF5_EXTENSIONS):
        f, dset = find_pattern_dataset(args.patterns, args.h5_dataset)
        try:
            yield dset, lambda: iter_pattern_batches(dset, args.h5_chunk)
        finally:
            f.close()
    elif low.endswith(UP_EXTENSIONS):
        header, pats = open_up_patterns(args.patterns)
        if not args.scan_grid and header.scan_grid:
            # Square-grid UP headers carry the scan geometry, so NLPAR and
            # the .ang/.ctf export work without the flag.
            args.scan_grid = list(header.scan_grid)
            logger.info(f"scan grid {header.scan_grid[0]}x{header.scan_grid[1]} from the UP header")
        yield pats, lambda: iter_up_batches(pats, args.h5_chunk)
    else:
        yield np.load(args.patterns), None


def _load_raw_pattern_stack(args) -> np.ndarray:
    """``args.patterns`` read whole (`_open_scan`): a ``.npy`` stack, an
    HDF5 scan or an EDAX ``.up1``/``.up2`` file."""
    with _open_scan(args) as (raw, _):
        return np.asarray(raw[...])


def _load_phase_stacks(pattern_paths, angle_paths, phase_groups: str | None):
    """``(stack, angles, phases, groups)`` of one ``.npy`` pattern stack and
    anglefile per phase: phases are ``None`` for a single phase without
    ``--phase-groups``, else an ``(N,)`` int32 phase id per row, and then
    every phase needs its point group."""
    from latice_tpu_torch.data import parse_angle_file

    if len(pattern_paths) != len(angle_paths):
        raise SystemExit("dictionary patterns and angles must be given the same number of times")
    groups = phase_groups.split(",") if phase_groups else None
    multiphase = len(pattern_paths) > 1 or groups is not None
    if multiphase and (not groups or len(groups) < len(pattern_paths)):
        raise SystemExit(
            f"{len(pattern_paths)} phases need --phase-groups with one group per phase"
        )
    stacks, angle_parts, phase_parts = [], [], []
    for pid, (pp, ap) in enumerate(zip(pattern_paths, angle_paths)):
        s = np.load(pp)
        a = parse_angle_file(str(ap))
        if len(s) != len(a):
            raise SystemExit(f"{pp} holds {len(s)} patterns but {ap} lists {len(a)} angles")
        stacks.append(s)
        angle_parts.append(a)
        phase_parts.append(np.full(len(s), pid, np.int32))
    phases = np.concatenate(phase_parts) if multiphase else None
    return np.concatenate(stacks), np.concatenate(angle_parts), phases, groups


def _reflectors_from_meta(meta: dict):
    """The simulate-time reflector table from a dictionary's provenance:
    explicit fitted bands (master-fit dictionaries) or the structure and
    lattice record of a kinematical one."""
    from latice_tpu_torch.sim import Reflectors, cubic_reflectors, hexagonal_reflectors

    if "fitted_bands" in meta:
        fb = meta["fitted_bands"]
        return Reflectors(
            normals=np.asarray(fb["normals"], np.float32),
            sin_theta=np.asarray(fb["sin_theta"], np.float32),
            intensity=np.asarray(fb["intensity"], np.float32),
        )
    if meta["structure"] == "hcp":
        c = meta.get("lattice_c") or 1.587 * meta["lattice"]
        return hexagonal_reflectors(
            a=meta["lattice"], c=c, kv=meta["kv"], max_hkl=meta["max_hkl"], min_d=meta["min_d"]
        )
    return cubic_reflectors(
        meta["structure"], a=meta["lattice"], kv=meta["kv"],
        max_hkl=meta["max_hkl"], min_d=meta["min_d"],
    )


def _refine_result(args, meta: dict, patterns: np.ndarray, result, steps: int, db, device):
    """Autodiff refinement (`sim.refine`) of an indexing result against the
    dictionary's own forward model, rebuilt from its provenance. With
    ``--refine-candidates K`` > 1 every top-K candidate is refined and the
    best NCC wins. Returns the result with refined ``best_orientation`` and
    the summary's refine fields."""
    from latice_tpu_torch.crystal import from_euler_zxz_deg, to_euler_zxz_deg
    from latice_tpu_torch.sim import DetectorGeometry, refine_candidates, refine_orientations

    geometry = DetectorGeometry(
        shape=(meta["size"], meta["size"]), pcx=meta["pc"][0], pcy=meta["pc"][1],
        dd=meta["pc"][2], tilt=meta.get("tilt", 0.0),
    )
    reflectors = _reflectors_from_meta(meta)
    x = np.asarray(patterns)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    t0 = time.time()
    k = min(getattr(args, "refine_candidates", 1) or 1, result.indices.shape[1])
    summary = {"refine_steps": steps}
    if k > 1:
        eulers = torch.as_tensor(db._orientations[result.indices[:, :k]], dtype=torch.float32)
        cand = from_euler_zxz_deg(eulers.reshape(-1, 3)).numpy().reshape(len(x), k, 4)
        refined_q, ncc, best_k = refine_candidates(
            x, cand, geometry, reflectors, steps=steps, device=device
        )
        summary["refine_reranked_frac"] = round(float((best_k > 0).mean()), 4)
    else:
        init_q = from_euler_zxz_deg(
            torch.as_tensor(result.best_orientation, dtype=torch.float32)
        ).numpy()
        refined_q, ncc = refine_orientations(
            x, init_q, geometry, reflectors, steps=steps, device=device
        )
    refined = to_euler_zxz_deg(torch.from_numpy(refined_q)).numpy().astype(np.float64)
    logger.info(
        f"Refined {len(x)} orientations (top-{k}) in {time.time() - t0:.1f}s; "
        f"median NCC {np.median(ncc):.3f}"
    )
    summary["refine_ncc_median"] = round(float(np.median(ncc)), 4)
    return result._replace(best_orientation=refined), summary
