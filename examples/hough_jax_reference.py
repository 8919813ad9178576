"""The JAX package's Hough readings on the inputs of ``chip_smoke.py``'s
``bands`` phase, on the CPU, for comparison with the port's on the GPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python examples/hough_jax_reference.py

Renders the phase's seeded orientations with ``latice_tpu.sim`` (the port
renders the same orientations on the card; the two renders agree within
~2e-6), then prints one JSON line: the Hough IQ of the clean and noisy
stacks, single-phase Hough indexing of the 1,024 fcc patterns at full width
(the accuracy the phase holds the port to) and the multi-phase fcc + hcp
run's phase assignment and accuracy.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
from scipy.spatial.transform import Rotation as R

import chip_smoke as cs
from latice_tpu.crystal import ROTATION_GROUPS
from latice_tpu.data import BandDetector
from latice_tpu.index import HoughIndexer, MultiPhaseHoughIndexer
from latice_tpu.sim import cubic_reflectors, hexagonal_reflectors, simulate_patterns


def disorientation_deg(est: np.ndarray, truth: np.ndarray, group: str) -> np.ndarray:
    """Least misorientation over the group's images, degrees."""
    sym = R.from_quat(np.roll(ROTATION_GROUPS[group], -1, axis=1))
    ra, rb = (R.from_quat(np.roll(np.asarray(q, np.float64), -1, axis=1)) for q in (est, truth))
    return np.array([math.degrees(min(((a * s).inv() * b).magnitude() for s in sym))
                     for a, b in zip(ra, rb)])


def accuracy(res, truth: np.ndarray, group: str) -> dict:
    """The readings ``chip_smoke.py``'s bands phase takes: the success share,
    the median and largest disorientation, and the share of patterns that
    meet each per-pattern bound of tests/index/test_hough_indexing.py
    (success, under 4 degrees, fit under 3 degrees, 5 or more bands)."""
    err = disorientation_deg(res.quaternions, truth, group)
    ok = ((res.success) & (err < cs.HOUGH_MAX_DEG) & (res.fit_deg < cs.HOUGH_FIT_MAX_DEG)
          & (res.n_matched >= cs.HOUGH_MIN_MATCHED))
    return dict(success_rate=float(res.success.mean()), median_deg=float(np.median(err)),
                max_deg=float(err.max()), fit_max_deg=float(res.fit_deg.max()),
                matched_min=int(res.n_matched.min()), within_bounds=float(ok.mean()),
                over_max_deg=int((err >= cs.HOUGH_MAX_DEG).sum()))


def main() -> int:
    fcc, hcp = cubic_reflectors(), hexagonal_reflectors(**cs.HCP)
    truth = cs._bands_truth(cs.BANDS_PATTERNS, cs.BANDS_SEEDS["fcc"])
    clean = simulate_patterns(truth, reflectors=fcc)
    noise = np.random.default_rng(cs.BANDS_SEEDS["noise"]).standard_normal(clean.shape,
                                                                            dtype=np.float32)
    noisy = clean + noise * cs.BANDS_NOISE
    out = {}
    t0 = time.perf_counter()
    det = BandDetector()
    out["iq_mean"] = dict(clean=float(det(clean).iq.mean()), noisy=float(det(noisy).iq.mean()))
    ix = HoughIndexer(fcc)
    out["hough"] = accuracy(ix(clean), truth, "432")
    out["hough_noisy"] = accuracy(ix(noisy), truth, "432")
    q_f = cs._bands_truth(cs.MULTI_PER_PHASE, cs.BANDS_SEEDS["multi_fcc"])
    q_h = cs._bands_truth(cs.MULTI_PER_PHASE, cs.BANDS_SEEDS["multi_hcp"])
    mixed = np.concatenate([simulate_patterns(q_f, reflectors=fcc),
                            simulate_patterns(q_h, reflectors=hcp)])
    res = MultiPhaseHoughIndexer([(fcc, "432"), (hcp, "622")], n_bands=cs.MULTI_BANDS,
                                 detector=BandDetector(k=cs.MULTI_BANDS))(mixed)
    phase_truth = np.repeat([0, 1], cs.MULTI_PER_PHASE)
    multi = dict(phase_wrong=int((res.phase != phase_truth).sum()))
    for pid, (group, q) in enumerate((("432", q_f), ("622", q_h))):
        m = phase_truth == pid
        sub = res._replace(quaternions=res.quaternions[m], success=res.success[m],
                           fit_deg=res.fit_deg[m], n_matched=res.n_matched[m])
        multi[group] = accuracy(sub, q, group)
    out["multi"] = multi
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"jax_reference": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
