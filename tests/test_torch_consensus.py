"""Port consensus against latice_tpu.index.consensus.consensus_orientations.

Candidate sets are clusters around seeded orientations plus outliers, built
so that no misorientation to a trial reference lies within 1e-3° of the
threshold (f32 roundoff could otherwise flip a comparison). ``success``,
``similar_mask``, ``chosen_iter`` and ``phase`` must be equal and the means
within 1e-3° misorientation; Euler angles are compared as rotations, since
they are ill-conditioned near Φ=0.
"""

import numpy as np
import pytest
import torch

from latice_tpu.crystal import stack_symmetry_tables as jax_stack
from latice_tpu.index.consensus import consensus_orientations as jax_consensus
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.index import consensus_orientations

B, K, ITERS = 48, 20, 3


def _mis_deg_np(a, b):
    """Misorientation in degrees, float64 numpy, for building the inputs."""
    a = torch.from_numpy(np.asarray(a, np.float64))
    b = torch.from_numpy(np.asarray(b, np.float64))
    return np.rad2deg(misorientation_angle(a, b).numpy())


def _random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _small_rotation(rng, n, max_deg):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = np.deg2rad(rng.uniform(0, max_deg, size=(n, 1))) / 2
    return np.concatenate([np.cos(half), np.sin(half) * axis], axis=1)


def _qmul(a, b):
    from latice_tpu_torch.crystal import quat_mul

    return quat_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _candidates(seed, threshold_deg):
    """(B, K, 4) f32 candidate sets with a margin of 1e-3° at the threshold."""
    rng = np.random.default_rng(seed)
    out = np.empty((B, K, 4))
    for b in range(B):
        while True:
            center = _random_quats(rng, 1)
            n_cluster = rng.integers(12, K + 1)
            spread = rng.choice([0.5, 2.5]) * threshold_deg  # tight or loose cluster
            cluster = _qmul(_small_rotation(rng, n_cluster, spread), center)
            cand = np.concatenate([cluster, _random_quats(rng, K - n_cluster)])
            cand = cand[rng.permutation(K)]
            cand *= rng.choice([-1.0, 1.0], size=(K, 1))  # q and -q are one rotation
            cand = cand.astype(np.float32)
            mis = _mis_deg_np(cand[:ITERS, None, :], cand[None, :, :])
            if np.all(np.abs(mis - threshold_deg) > 1e-3):
                out[b] = cand
                break
    return out.astype(np.float32)


def _run_both(cand, threshold, **kw):
    want = jax_consensus(cand, threshold, **kw)
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = consensus_orientations(torch.from_numpy(cand), threshold, **tkw)
    return got, want


def _assert_same(got, want):
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.similar_mask.numpy(), np.asarray(want.similar_mask))
    np.testing.assert_array_equal(got.chosen_iter.numpy(), np.asarray(want.chosen_iter))
    np.testing.assert_allclose(
        got.misorientation_deg.numpy(), np.asarray(want.misorientation_deg), atol=1e-3
    )
    qg = from_euler_zxz_deg(got.mean_euler.double())
    qw = from_euler_zxz_deg(torch.from_numpy(np.asarray(want.mean_euler, np.float64)))
    assert np.rad2deg(misorientation_angle(qg, qw).numpy()).max() < 1e-3
    if want.phase is None:
        assert got.phase is None
    else:
        np.testing.assert_array_equal(got.phase.numpy(), np.asarray(want.phase))


@pytest.mark.parametrize("min_matches", [6, 14])
def test_degrees(min_matches):
    cand = _candidates(0, 3.0)
    got, want = _run_both(cand, 3.0, min_required_matches=min_matches, max_iterations=ITERS)
    assert 0 < got.success.sum() < B  # both branches exercised
    _assert_same(got, want)


def test_radians():
    cand = _candidates(1, np.rad2deg(0.05))
    got, want = _run_both(
        cand, 0.05, min_required_matches=8, max_iterations=ITERS, angle_unit="rad"
    )
    assert got.success.any()
    _assert_same(got, want)


def test_phases_with_stacked_tables():
    cand = _candidates(2, 3.0)
    rng = np.random.default_rng(3)
    phases = rng.integers(0, 2, size=(B, K)).astype(np.int32)
    phases[: B // 2] = 0  # half the rows single-phase, so some succeed
    tables = np.asarray(jax_stack(["432", "622"]))
    got, want = _run_both(
        cand, 3.0, min_required_matches=6, max_iterations=ITERS,
        cand_phases=phases, sym_tables=tables,
    )
    assert got.success.any()
    _assert_same(got, want)


def test_phases_default_cubic_tables():
    cand = _candidates(4, 3.0)
    phases = np.zeros((B, K), np.int32)
    got, want = _run_both(cand, 3.0, min_required_matches=6, cand_phases=phases)
    _assert_same(got, want)


def test_candidate_weights():
    cand = _candidates(5, 3.0)
    rng = np.random.default_rng(6)
    weights = rng.uniform(0.2, 1.0, size=(B, K)).astype(np.float32) ** 8
    weights[0] = 0.0  # all-zero row: uniform fallback
    got, want = _run_both(
        cand, 3.0, min_required_matches=6, max_iterations=ITERS, cand_weights=weights
    )
    _assert_same(got, want)


def test_iterations_clamped_to_k():
    cand = _candidates(7, 3.0)[:, :2]
    got, want = _run_both(cand, 3.0, min_required_matches=2, max_iterations=5)
    _assert_same(got, want)


def test_bad_unit_raises():
    with pytest.raises(ValueError, match="angle_unit"):
        consensus_orientations(torch.zeros(1, 3, 4), 1.0, angle_unit="grad")
