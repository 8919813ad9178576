"""Port quaternion and symmetry math held against latice_tpu.crystal.

Same seeded f32 inputs through both; angles within 1e-5 rad and
quaternions within 1e-5 (f32 roundoff of short op chains).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import latice_tpu.crystal.quaternion as jq
import latice_tpu.crystal.symmetry as js
import latice_tpu_torch.crystal.quaternion as tq
import latice_tpu_torch.crystal.symmetry as ts

ATOL_Q = 1e-5
ATOL_RAD = 1e-5
GROUPS = sorted(js.ROTATION_GROUPS)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _eulers(rng, n):
    e = rng.uniform([0, 0, 0], [360, 180, 360], size=(n, 3))
    # Gimbal-locked rows at both poles.
    e[:4, 1] = 0.0
    e[4:8, 1] = 180.0
    return e.astype(np.float32)


def _j(a):
    return np.asarray(a)


def _t(fn, *args, **kw):
    return fn(*(torch.from_numpy(np.array(a)) for a in args), **kw).numpy()


def _angle_diff_rad(a_deg, b_deg):
    d = (np.asarray(a_deg, np.float64) - np.asarray(b_deg, np.float64) + 180.0) % 360.0 - 180.0
    return np.deg2rad(np.abs(d))


def test_elementwise_ops():
    rng = np.random.default_rng(0)
    a, b = _quats(rng, 256), _quats(rng, 256)
    np.testing.assert_allclose(_t(tq.quat_mul, a, b), _j(jq.quat_mul(a, b)), atol=ATOL_Q)
    np.testing.assert_allclose(_t(tq.quat_inv, a), _j(jq.quat_inv(a)), atol=ATOL_Q)
    np.testing.assert_allclose(_t(tq.quat_canonical, a), _j(jq.quat_canonical(a)), atol=ATOL_Q)
    np.testing.assert_allclose(
        _t(tq.quat_normalize, 3.0 * a), _j(jq.quat_normalize(3.0 * a)), atol=ATOL_Q
    )
    np.testing.assert_allclose(_t(tq.quat_angle, a), _j(jq.quat_angle(a)), atol=ATOL_RAD)
    np.testing.assert_allclose(
        _t(tq.misorientation_angle, a, b), _j(jq.misorientation_angle(a, b)), atol=ATOL_RAD
    )
    np.testing.assert_allclose(_t(tq.quat_to_matrix, a), _j(jq.quat_to_matrix(a)), atol=ATOL_Q)


def test_broadcasting_matches():
    rng = np.random.default_rng(1)
    a, b = _quats(rng, 6).reshape(2, 3, 1, 4), _quats(rng, 5)
    np.testing.assert_allclose(
        _t(tq.misorientation_angle, a, b), _j(jq.misorientation_angle(a, b)), atol=ATOL_RAD
    )


def test_from_euler_including_poles():
    rng = np.random.default_rng(2)
    e = _eulers(rng, 200)
    np.testing.assert_allclose(
        _t(tq.from_euler_zxz_deg, e), _j(jq.from_euler_zxz_deg(e)), atol=ATOL_Q
    )


@pytest.mark.parametrize("source", ["random", "poles"])
def test_to_euler_matches(source):
    rng = np.random.default_rng(3)
    if source == "random":
        q = _quats(rng, 300)
    else:
        q = _j(jq.from_euler_zxz_deg(_eulers(rng, 8)[:8]))
    got = _t(tq.to_euler_zxz_deg, q)
    want = _j(jq.to_euler_zxz_deg(q))
    assert np.all(_angle_diff_rad(got, want) < ATOL_RAD)
    if source == "poles":
        # Gimbal lock: the last extrinsic angle is zeroed, as scipy does.
        np.testing.assert_allclose(got[:, 2], 0.0, atol=1e-4)


def test_matrix_to_euler_matches():
    rng = np.random.default_rng(4)
    m = _j(jq.quat_to_matrix(_quats(rng, 100)))
    got = _t(tq.matrix_to_euler_zxz_deg, m)
    want = _j(jq.matrix_to_euler_zxz_deg(m))
    assert np.all(_angle_diff_rad(got, want) < ATOL_RAD)


@pytest.mark.parametrize("weighted", [False, True])
def test_quat_mean_matches(weighted):
    rng = np.random.default_rng(5)
    centers = _quats(rng, 16)
    noise = rng.normal(scale=0.02, size=(16, 12, 4)).astype(np.float32)
    q = centers[:, None, :] + noise
    q *= np.where(rng.uniform(size=(16, 12, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w = rng.uniform(size=(16, 12)).astype(np.float32) if weighted else None
    if weighted:
        w[0] = 0.0  # all-zero weights: identity start, finite result
    got = tq.quat_mean(torch.from_numpy(q), None if w is None else torch.from_numpy(w)).numpy()
    want = _j(jq.quat_mean(q, w))
    np.testing.assert_allclose(got, want, atol=ATOL_Q)


@pytest.mark.parametrize("group", GROUPS)
def test_symmetry_tables_equal(group):
    np.testing.assert_array_equal(ts.ROTATION_GROUPS[group], js.ROTATION_GROUPS[group])
    np.testing.assert_array_equal(
        ts.symmetry_quats(group).numpy(), _j(js.symmetry_quats(group))
    )


def test_cubic_tables_equal():
    np.testing.assert_array_equal(ts.QUAT_SYM_WXYZ, js.QUAT_SYM_WXYZ)
    assert ts.CUBIC_SYMMETRY == js.CUBIC_SYMMETRY


def test_stack_symmetry_tables_equal():
    groups = ["432", "622", "1", "23"]
    np.testing.assert_array_equal(
        ts.stack_symmetry_tables(groups).numpy(), _j(js.stack_symmetry_tables(groups))
    )


def test_unknown_group_raises():
    with pytest.raises(ValueError, match="unknown point group"):
        ts.symmetry_quats("7")


@pytest.mark.parametrize("compose", ["sample", "crystal"])
@pytest.mark.parametrize("group", GROUPS)
def test_nearest_symmetry_equivalent_matches(group, compose):
    rng = np.random.default_rng(2 * GROUPS.index(group) + (compose == "crystal"))
    ref, cand = _quats(rng, 64), _quats(rng, 64)
    sym = np.asarray(js.ROTATION_GROUPS[group], np.float32)
    got = ts.nearest_symmetry_equivalent(
        torch.from_numpy(ref), torch.from_numpy(cand), torch.from_numpy(sym), compose=compose
    ).numpy()
    want = _j(js.nearest_symmetry_equivalent(ref, cand, jnp.asarray(sym), compose=compose))
    np.testing.assert_allclose(got, want, atol=ATOL_Q)


def test_nearest_symmetry_equivalent_per_query_tables():
    rng = np.random.default_rng(6)
    ref, cand = _quats(rng, 8)[:, None, :], _quats(rng, 40).reshape(8, 5, 4)
    tables = np.asarray(js.stack_symmetry_tables(["432", "622"]))
    sym = tables[rng.integers(0, 2, size=8)][:, None]  # (B, 1, S, 4)
    got = ts.nearest_symmetry_equivalent(
        torch.from_numpy(ref), torch.from_numpy(cand), torch.from_numpy(sym)
    ).numpy()
    want = _j(js.nearest_symmetry_equivalent(ref, cand, jnp.asarray(sym)))
    np.testing.assert_allclose(got, want, atol=ATOL_Q)
