"""Texture components: volume fractions of the named ideal orientations (the
port of ``latice_tpu/crystal/components.py``).

Each pixel goes to the nearest named component (Cube, Goss, Brass, Copper,
S, ...) within a misorientation tolerance, conventionally 15°. The
equivalence class of a component is ``s_c ⊗ g ⊗ s_s``: the crystal point
group on the left and the sample symmetry on the right (rolled sheet:
orthorhombic, so Brass (35°, 45°, 0°) and its mirror are one component).
The deviation is ``2·arccos(max |⟨g, o⟩|)`` over the deduplicated orbit,
built on the host; the per-pixel maxima run on the device, tiled by pixels
(`TILE_BYTES`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from latice_tpu_torch.crystal.csl import _host_symmetry, _qmul_np
from latice_tpu_torch.crystal.quaternion import from_euler_zxz_deg
from latice_tpu_torch.device import full_f32_matmul, resolve_device

__all__ = [
    "SAMPLE_SYMMETRIES",
    "TEXTURE_COMPONENTS",
    "TextureComponentResult",
    "component_orbit",
    "texture_component_fractions",
]

_A = math.degrees(math.atan(1.0 / math.sqrt(2.0)))  # 35.2644°

#: Bytes of the largest per-tile intermediate, the ``(pixels, nC·K)``
#: score matrix (~3 GB untiled for the full table at 1024x1024).
TILE_BYTES = 1 << 30

#: Named ideal orientations, Bunge zxz degrees: Cube {001}<100>, rotated
#: cube {001}<110>, Goss {011}<100>, Brass {011}<211>, Copper {112}<111>,
#: S {123}<634>, and the bcc γ-fibre's E {111}<110> and F {111}<112>.
TEXTURE_COMPONENTS: dict[str, tuple[float, float, float]] = {
    "cube": (0.0, 0.0, 0.0),
    "rotated_cube": (45.0, 0.0, 0.0),
    "goss": (0.0, 45.0, 0.0),
    "brass": (_A, 45.0, 0.0),
    "copper": (90.0, _A, 45.0),
    "s": (58.98, 36.70, 63.43),
    "e": (0.0, 54.74, 45.0),
    "f": (30.0, 54.74, 45.0),
}

#: Sample symmetries: ``triclinic`` = none; ``orthorhombic`` = the RD/TD/ND
#: 180° flips of a rolled sheet (point group 222); ``monoclinic`` = ND only.
SAMPLE_SYMMETRIES = ("triclinic", "monoclinic", "orthorhombic")


def _sample_symmetry_quats(name: str) -> np.ndarray:
    if name == "triclinic":
        return np.asarray([[1.0, 0.0, 0.0, 0.0]])
    if name == "monoclinic":
        return np.asarray([[1.0, 0, 0, 0], [0.0, 0, 0, 1.0]])  # 180° about ND
    if name == "orthorhombic":
        return _host_symmetry("222")
    raise ValueError(f"unknown sample symmetry {name!r}; known: {SAMPLE_SYMMETRIES}")


def component_orbit(
    euler_deg: Sequence[float],
    group: str = "432",
    sample_symmetry: str = "orthorhombic",
) -> np.ndarray:
    """Deduplicated orbit ``s_crystal ⊗ g ⊗ s_sample`` of an ideal
    orientation, on the host. The orientation's quaternion is taken in
    float32, as the JAX package takes it."""
    q = from_euler_zxz_deg(torch.as_tensor(np.asarray(euler_deg, np.float32)))
    q = q.to(torch.float64).numpy()
    left = _host_symmetry(group)
    right = _sample_symmetry_quats(sample_symmetry)
    orbit = _qmul_np(left[:, None, :], _qmul_np(q[None, :], right)[None, :, :]).reshape(-1, 4)
    flip = orbit[:, :1] < 0
    orbit = np.where(flip, -orbit, orbit)
    orbit = np.unique(np.round(orbit, 9), axis=0)
    return orbit / np.linalg.norm(orbit, axis=-1, keepdims=True)


@torch.no_grad()
def _component_deviations(euler_deg: torch.Tensor, orbits: torch.Tensor, valid: torch.Tensor):
    """(N, 3) Euler degrees → (N, nC) deviation degrees from each component,
    in blocks of pixels that keep the ``(pixels, nC·K)`` score matrix within
    `TILE_BYTES`; every pixel's maximum is independent."""
    ns, k, _ = orbits.shape
    table = orbits.reshape(ns * k, 4).T.contiguous()
    mask = valid.reshape(ns * k).to(table.dtype)
    step = max(1, TILE_BYTES // (ns * k * 4))
    out = []
    for i in range(0, len(euler_deg), step):
        q = from_euler_zxz_deg(euler_deg[i:i + step])
        with full_f32_matmul():
            dots = q @ table
        dots.abs_().mul_(mask)
        best = dots.view(len(q), ns, k).amax(dim=-1)
        del dots  # one tile alive at a time
        out.append(2.0 * torch.rad2deg(torch.arccos(torch.clamp(best, 0.0, 1.0))))
    return torch.cat(out)


class TextureComponentResult(NamedTuple):
    """Per-pixel component assignment and summary fractions."""

    #: Component names, in the order label indices refer to.
    names: tuple[str, ...]
    #: Per-pixel label: index into ``names``, or -1 (none within tolerance).
    labels: np.ndarray
    #: Per-pixel deviation (degrees) from the assigned (or nearest) component.
    deviation_deg: np.ndarray
    #: name -> fraction of pixels (plus ``"other"``).
    fractions: dict[str, float]


def texture_component_fractions(
    euler_deg: np.ndarray,
    components: Sequence[str] | dict[str, Sequence[float]] | None = None,
    group: str = "432",
    sample_symmetry: str = "orthorhombic",
    tolerance_deg: float = 15.0,
    device=None,
) -> TextureComponentResult:
    """Assign each ``(..., 3)`` zxz Euler-degree orientation to the nearest
    named texture component within ``tolerance_deg``.

    ``components`` is a list of `TEXTURE_COMPONENTS` names or a ``{name:
    (φ1, Φ, φ2)}`` dict (default: the whole table); ``sample_symmetry`` is
    ``"orthorhombic"`` (default), ``"monoclinic"`` or ``"triclinic"``.
    """
    euler = np.asarray(euler_deg, np.float32)
    lead = euler.shape[:-1]
    if euler.ndim < 1 or euler.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) Euler angles, got {euler.shape}")
    if components is None:
        table = dict(TEXTURE_COMPONENTS)
    elif isinstance(components, dict):
        table = {k: tuple(v) for k, v in components.items()}
    else:
        unknown = [c for c in components if c not in TEXTURE_COMPONENTS]
        if unknown:
            raise ValueError(
                f"unknown components {unknown}; known: "
                f"{', '.join(TEXTURE_COMPONENTS)} (or pass a dict)"
            )
        table = {c: TEXTURE_COMPONENTS[c] for c in components}
    if not table:
        raise ValueError("no components given")
    names = tuple(table)

    orbits = [component_orbit(table[n], group, sample_symmetry) for n in names]
    kmax = max(len(o) for o in orbits)
    packed = np.zeros((len(orbits), kmax, 4), np.float32)
    valid = np.zeros((len(orbits), kmax), bool)
    for i, o in enumerate(orbits):
        packed[i, : len(o)] = o
        valid[i, : len(o)] = True

    dev = resolve_device(device)
    dev_deg = _component_deviations(
        torch.as_tensor(euler.reshape(-1, 3), device=dev),
        torch.as_tensor(packed, device=dev),
        torch.as_tensor(valid, device=dev),
    ).cpu().numpy()
    nearest = np.argmin(dev_deg, axis=-1)
    nearest_dev = np.take_along_axis(dev_deg, nearest[:, None], axis=-1)[:, 0]
    labels = np.where(nearest_dev <= tolerance_deg, nearest, -1).astype(np.int16)

    n = len(labels)
    fractions = {name: float((labels == i).sum() / n) for i, name in enumerate(names)}
    fractions["other"] = float((labels < 0).sum() / n)
    return TextureComponentResult(
        names=names,
        labels=labels.reshape(lead),
        deviation_deg=nearest_dev.astype(np.float32).reshape(lead),
        fractions=fractions,
    )
