"""The JAX package's spherical-indexing readings on the inputs of
``chip_smoke.py``'s ``sphere`` phase, on the CPU, for comparison with the
port's on the GPU.

    LATICE_TPU_SHT_CACHE=<dir> JAX_PLATFORMS=cpu PYTHONPATH=. \\
        python examples/sphere_jax_reference.py

Renders the phase's seeded orientations from the kinematical fcc (and hcp)
masters with ``latice_tpu.sim`` (the port renders the same orientations on
the card), then prints one JSON line: `SphericalIndexer` at the phase's
full width (L=64, bin 2) in the grid, parabolic and Newton modes over the
1,024 fcc patterns (the readings of ``chip_smoke.sphere_readings``), the
ambiguity diagnostic over the first 256 with ``chip_smoke.SPHERE_AMB_CELLS``
cells (at L=64 a winner's own basin fills the default 32), and the multi-phase fcc + hcp run's
wrong-phase count and per-phase readings. Chunks of 16 keep the host memory
near a gigabyte; a pattern's result does not depend on its chunk. The
Wigner table is built once per process (~40 s at L=64 on one core); the
cache directory spares the multi-phase indexer a second build.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

import numpy as np
from scipy.spatial.transform import Rotation as R

import chip_smoke as cs
from latice_tpu.crystal import ROTATION_GROUPS
from latice_tpu.index.spherical import (
    MultiPhaseSphericalIndexer,
    SphericalIndexer,
    SphericalIndexerConfig,
    projection_tables,
)
from latice_tpu.sim import (
    DetectorGeometry,
    hexagonal_reflectors,
    make_kinematical_master,
    render_from_master,
)

CHUNK = 16


def disorientation_deg(est: np.ndarray, truth: np.ndarray, group: str) -> np.ndarray:
    """Least misorientation over the group's images, degrees."""
    sym = R.from_quat(np.roll(ROTATION_GROUPS[group], -1, axis=1))
    ra, rb = (R.from_quat(np.roll(np.asarray(q, np.float64), -1, axis=1)) for q in (est, truth))
    return np.array([math.degrees(min(((a * s).inv() * b).magnitude() for s in sym))
                     for a, b in zip(ra, rb)])


def main() -> int:
    t0 = time.perf_counter()
    geom = DetectorGeometry()
    fcc = make_kinematical_master(size=cs.SPHERE_MASTER)
    hcp = make_kinematical_master(size=cs.SPHERE_MASTER, reflectors=hexagonal_reflectors(**cs.HCP))
    truth = cs._bands_truth(cs.SPHERE_PATTERNS, cs.SPHERE_SEEDS["fcc"])
    patterns = render_from_master(fcc, truth, geom)
    cfg = SphericalIndexerConfig(bandwidth=cs.SPHERE_L, detector_bin=cs.SPHERE_BIN, chunk=CHUNK)
    tables = projection_tables(cs.SPHERE_L, geom, cs.SPHERE_BIN)
    out = {}
    for mode, refine in zip(cs.SPHERE_MODES, (False, "parabolic", "newton")):
        ix = SphericalIndexer(fcc, geom, dataclasses.replace(cfg, refine=refine), tables=tables)
        res = ix.index_patterns(patterns)
        out[mode] = dict(**cs.sphere_readings(disorientation_deg(res.quaternions, truth, "432")),
                         mean_score=float(res.scores.mean()))
    amb = ix.ambiguity(patterns[: cs.SPHERE_AMBIGUITY], n_cells=cs.SPHERE_AMB_CELLS)
    gap = amb.score_gap[amb.has_rival]
    out["ambiguity"] = dict(has_rival=float(amb.has_rival.mean()),
                            median_gap=float(np.median(gap)),
                            median_angle_deg=float(np.median(amb.angle_deg[amb.has_rival])),
                            ambiguous=float(amb.ambiguous().mean()))
    q_f = cs._bands_truth(cs.SPHERE_MULTI, cs.SPHERE_SEEDS["multi_fcc"])
    q_h = cs._bands_truth(cs.SPHERE_MULTI, cs.SPHERE_SEEDS["multi_hcp"])
    mixed = np.concatenate([render_from_master(fcc, q_f, geom), render_from_master(hcp, q_h, geom)])
    res = MultiPhaseSphericalIndexer([fcc, hcp], geom, cfg,
                                     symmetries=["432", "622"]).index_patterns(mixed)
    phase_truth = np.repeat([0, 1], cs.SPHERE_MULTI)
    multi = dict(phase_wrong=int((res.phase != phase_truth).sum()))
    for pid, (group, q) in enumerate((("432", q_f), ("622", q_h))):
        m = phase_truth == pid
        multi[group] = cs.sphere_readings(disorientation_deg(res.quaternions[m], q, group))
    out["multi"] = multi
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
