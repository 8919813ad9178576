"""Schmid factor maps: resolved shear stress geometry per pixel (the port of
``latice_tpu/crystal/schmid.py``).

``m = |cos φ · cos λ|`` (φ: slip-plane normal vs load, λ: slip direction vs
load) ranks how favourably each orientation is set for slip under a
uniaxial load. Slip families come from integer crystallography (every
symmetric {hkl}<uvw> pair with n ⊥ d), built on the host exactly as the
JAX package builds them: ``fcc`` {111}<110>, ``bcc`` {110}<111> and
``bcc112`` {112}<111>, 12 systems each. ``g`` maps sample → crystal frames,
so the crystal-frame load is ``R(q) @ load``; the map runs on the device.
"""

from __future__ import annotations

from itertools import permutations, product
from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.crystal.quaternion import from_euler_zxz_deg, quat_to_matrix
from latice_tpu_torch.device import full_f32_matmul, resolve_device

__all__ = [
    "SLIP_FAMILIES",
    "SchmidResult",
    "schmid_factors",
    "slip_systems",
]

SLIP_FAMILIES = ("fcc", "bcc", "bcc112")


def _unique_updirs(vecs) -> list[tuple[int, ...]]:
    """Integer directions deduplicated up to sign (one hemisphere kept)."""
    seen = set()
    out = []
    for v in vecs:
        v = tuple(int(x) for x in v)
        if v == (0, 0, 0):
            continue
        key = tuple(-x for x in v) if (np.sign(v)[np.nonzero(v)[0][0]] < 0) else v
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


def _family(hkl: tuple[int, int, int]) -> list[tuple[int, ...]]:
    """All signed permutations of ±h±k±l, deduplicated up to sign."""
    perms = set(permutations(hkl))
    signed = {
        tuple(s * v for s, v in zip(signs, p))
        for p in perms
        for signs in product((1, -1), repeat=3)
    }
    return _unique_updirs(sorted(signed))


def slip_systems(family: str = "fcc", dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Unit (normals, directions) arrays ``(S, 3)`` of a slip family."""
    if family == "fcc":
        planes, dirs = _family((1, 1, 1)), _family((1, 1, 0))
    elif family == "bcc":
        planes, dirs = _family((1, 1, 0)), _family((1, 1, 1))
    elif family == "bcc112":
        planes, dirs = _family((1, 1, 2)), _family((1, 1, 1))
    else:
        raise ValueError(f"unknown slip family {family!r}; known: {SLIP_FAMILIES}")
    n_out, d_out = [], []
    for n in planes:
        for d in dirs:
            if sum(a * b for a, b in zip(n, d)) == 0:
                n_out.append(n)
                d_out.append(d)
    normals = np.asarray(n_out, np.float64)
    directions = np.asarray(d_out, np.float64)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    return normals.astype(dtype), directions.astype(dtype)


class SchmidResult(NamedTuple):
    """Per-pixel Schmid analysis (host arrays, the input's leading shape)."""

    #: Maximum |m| over the family's systems (0..0.5).
    max_factor: np.ndarray
    #: Index of the maximizing system into the family's (normals, dirs).
    system: np.ndarray


@torch.no_grad()
def _schmid(euler_deg, load, normals, directions):
    """(N, 3) Euler degrees → (max |m|, argmax system) over (S, 3) tables."""
    rot = quat_to_matrix(from_euler_zxz_deg(euler_deg))  # sample -> crystal
    with full_f32_matmul():
        l_c = rot @ load
        m = (l_c @ normals.T).mul_(l_c @ directions.T).abs_()
    best, idx = m.max(dim=-1)
    return best, idx


def schmid_factors(
    euler_deg: np.ndarray,
    load_direction=(0.0, 0.0, 1.0),
    family: str = "fcc",
    device=None,
) -> SchmidResult:
    """Maximum Schmid factor and active system of each ``(..., 3)`` zxz
    Euler-degree orientation under a uniaxial sample-frame load (normalized
    here), for the ``fcc``, ``bcc`` or ``bcc112`` family."""
    euler = np.asarray(euler_deg, np.float32)
    if euler.ndim < 1 or euler.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) Euler angles, got {euler.shape}")
    lead = euler.shape[:-1]
    load = np.asarray(load_direction, np.float64)
    nrm = np.linalg.norm(load)
    if not nrm > 0:
        raise ValueError("load_direction must be nonzero")
    normals, directions = slip_systems(family)
    dev = resolve_device(device)
    m, idx = _schmid(
        torch.as_tensor(euler.reshape(-1, 3), device=dev),
        torch.as_tensor(load / nrm, dtype=torch.float32, device=dev),
        torch.as_tensor(normals, device=dev),
        torch.as_tensor(directions, device=dev),
    )
    return SchmidResult(
        max_factor=m.cpu().numpy().astype(np.float32).reshape(lead),
        system=idx.cpu().numpy().astype(np.int32).reshape(lead),
    )
