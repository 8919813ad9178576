"""The port's pattern DI (`PatternDictionaryIndexer`, the exact engine over
the default bf16 table, whose card route is K5) against the plain PyTorch
reference beside the tests (``reference_torch/pattern_di.py``) and the
benchmark's reference consensus, on the CPU.

The dictionary is 2,048 seeded 32x32 uint8 patterns in groups of 32: noisy
copies of a group's base pattern, with orientations within 0.7° of the
group's, so that a query (another noisy copy) finds its group and the
consensus succeeds. Bin 1 and 2, one phase (432) and two (432 and 622, by
group). Indices must be equal except at ties within 1e-6, scores within
1e-6 (f32 sums in other orders), success, n_similar and phase equal, and
orientations within 1e-4° (the port's consensus in f32, the reference's in
f64).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from reference_torch import pattern_di as ref

from latice_tpu_torch.index import PatternDictionaryIndexer
from port_bench.reference import rotations as rot
from port_bench.reference.consensus import consensus

ROWS, GROUP, SIDE, QUERIES = 2_048, 32, 32, 96


def _small_turns(rng, n: int, max_deg: float) -> np.ndarray:
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = np.deg2rad(rng.uniform(0, max_deg, (n, 1))) / 2
    return np.concatenate([np.cos(half), np.sin(half) * axis], axis=1)


def _euler_zxz_deg(q: np.ndarray) -> np.ndarray:
    """Extrinsic zxz degrees of unit quaternions (rotations.py's convention)."""
    w, x, y, z = q.T
    m20, m21, m22 = 2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)
    m02, m12 = 2 * (x * z + w * y), 2 * (y * z - w * x)
    return np.rad2deg(np.stack([np.arctan2(m20, m21), np.arctan2(np.hypot(m20, m21), m22),
                                np.arctan2(m02, -m12)], axis=1))


@pytest.fixture(scope="module")
def scan():
    state = torch.random.get_rng_state()
    rng = np.random.default_rng(21)
    groups = ROWS // GROUP
    base = rng.integers(0, 256, (groups, SIDE, SIDE)).astype(np.float64)

    def copies(owner):
        noisy = base[owner] + rng.normal(0, 12, (len(owner), SIDE, SIDE))
        return np.clip(np.round(noisy), 0, 255).astype(np.uint8)

    owner = np.repeat(np.arange(groups), GROUP)
    centre = rng.normal(size=(groups, 4))
    centre /= np.linalg.norm(centre, axis=1, keepdims=True)
    quats = rot.mul(centre[owner], _small_turns(rng, ROWS, 0.7))
    query_owner = rng.integers(0, groups, QUERIES)
    yield dict(dictionary=copies(owner), euler=_euler_zxz_deg(quats), phases=(owner % 2).astype(np.int32),
               queries=copies(query_owner))
    torch.random.set_rng_state(state)


def _reference(s: dict, bin_factor: int, phases: bool) -> tuple:
    table = ref.features(torch.from_numpy(s["dictionary"]), bin_factor)
    q = ref.features(torch.from_numpy(s["queries"]), bin_factor)
    scores, idx = ref.topk(ref.scores(q, table, "bfloat16"), 20)
    idx = idx.numpy()
    groups = ["432", "622"] if phases else None
    cons = consensus(rot.from_euler_zxz_deg(s["euler"])[idx], 3.0, 18, 3,
                     s["phases"][idx] if phases else None, groups)
    return scores.numpy(), idx, cons


@pytest.mark.parametrize("phases", [False, True], ids=["one_phase", "two_phases"])
@pytest.mark.parametrize("bin_factor", [1, 2])
def test_port_matches_the_reference(scan, bin_factor, phases):
    kw = dict(dictionary_phases=scan["phases"], phase_symmetries=["432", "622"]) if phases else {}
    di = PatternDictionaryIndexer(scan["dictionary"], scan["euler"], bin_factor=bin_factor,
                                  batch_size=32, device="cpu", **kw)
    got = di(scan["queries"])
    scores, idx, cons = _reference(scan, bin_factor, phases)
    tied = (np.abs(np.diff(scores, axis=1)) < 1e-6).any(axis=1)
    same = (got.indices == idx).all(axis=1)
    assert (same | tied).all() and same.mean() > 0.9
    np.testing.assert_allclose(got.scores[same], scores[same], rtol=0, atol=1e-6)
    assert 0.5 < cons.success.mean()
    np.testing.assert_array_equal(got.success[same], cons.success[same])
    np.testing.assert_array_equal(got.n_similar[same], cons.n_similar[same])
    if phases:
        np.testing.assert_array_equal(got.phase[same], cons.phase[same])
    ok = same & cons.success
    gap = np.rad2deg(rot.misorientation(rot.from_euler_zxz_deg(got.mean_orientation[ok]), cons.mean[ok]))
    assert gap.max() < 1e-4
    best = np.rad2deg(rot.misorientation(rot.from_euler_zxz_deg(got.best_orientation[same]),
                                         cons.best[same]))
    assert best.max() < 1e-4


def test_reference_features_are_ncc(scan):
    """Zero-mean unit rows, so that a dot product is the normalized
    cross-correlation, and blind to a gain and an offset."""
    x = torch.from_numpy(scan["queries"][:8])
    f = ref.features(x)
    torch.testing.assert_close(f.sum(1), torch.zeros(8), rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.linalg.vector_norm(f, dim=1), torch.ones(8))
    torch.testing.assert_close(ref.features(x.float() * 0.5 + 7.0), f, rtol=0, atol=1e-5)
