"""The port's GND density and parent-grain reconstruction against the JAX
package's on the same seeded inputs, on the CPU.

Tolerances: the GND density and Nye entries within 1e-4 relative of the
map's median density (a curvature is a difference of f32 rotation vectors
of ~0.3°, so a near-zero entry carries the f32 floor of its neighbours'
rotations); validity masks equal; OR rotations, variant tables and
adjacency, host numpy copied, equal; parent labels, counts and variants
equal, parent orientations within 1e-3° of misorientation (compared by
misorientation, never by Euler triple), fits through cos(θ/2) within
1e-6.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import latice_tpu.crystal as jc
from latice_tpu.crystal.csl import _qmul_np
from latice_tpu_torch import crystal as tc


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _bent_map(h=20, w=24, seed=7):
    """Two grains, each bent by a smooth lattice curvature (~0.4° per step)
    plus 0.02° of noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.where(xx[..., None] < w // 2, [[30.0, 40.0, 50.0]], [[100.0, 20.0, 70.0]])
    bend = np.stack([0.4 * xx, 0.25 * yy, 0.1 * (xx + yy)], -1)
    rot = R.from_rotvec(np.radians(bend.reshape(-1, 3))) * R.from_euler(
        "zxz", base.reshape(-1, 3), degrees=True)
    rot = R.from_rotvec(rng.normal(scale=np.radians(0.02), size=(h * w, 3))) * rot
    return rot.as_euler("zxz", degrees=True).reshape(h, w, 3)


def test_gnd_matches_jax():
    euler = _bent_map()
    got = tc.gnd_density(euler, step_um=0.5, burgers_nm=0.25, device="cpu")
    want = jc.gnd_density(euler, step_um=0.5, burgers_nm=0.25)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert 0.8 < got.valid.mean() < 1.0
    scale = np.nanmedian(want.density)
    np.testing.assert_allclose(got.density, want.density, rtol=1e-4, atol=1e-4 * scale)
    b_m = 0.25e-9
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-4, atol=1e-4 * scale * b_m)
    k1, k2, valid = tc.lattice_curvature(euler, 0.5, device="cpu")
    w1, w2, wvalid = jc.lattice_curvature(euler, 0.5)
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_allclose(k1, w1, rtol=1e-4, atol=1e-4 * scale * b_m)
    np.testing.assert_allclose(k2, w2, rtol=1e-4, atol=1e-4 * scale * b_m)
    for kw, msg in ((dict(step_um=0.0), "step_um"), (dict(burgers_nm=-1.0), "burgers_nm")):
        with pytest.raises(ValueError, match=msg):
            tc.gnd_density(euler, device="cpu", **kw)


def _forward_map(seed=0, relationship="ks"):
    """3 parents x 4 children of distinct variants on a 12-grain chain, as
    tests/crystal/test_reconstruction.py builds them."""
    rng = np.random.default_rng(seed)
    t = jc.or_rotation(relationship)
    sym = np.asarray(jc.symmetry_quats("432"), np.float64)
    parent_eulers = np.asarray([[15.0, 30.0, 45.0], [70.0, 55.0, 10.0], [40.0, 80.0, 60.0]])
    child_eulers, parent_of = [], []
    for p, pe in enumerate(parent_eulers):
        gp = np.roll(R.from_euler("zxz", pe, degrees=True).as_quat(), 1)
        for k in rng.choice(24, size=4, replace=False):
            sp, sc = sym[k], sym[rng.integers(0, 24)]
            gc = _qmul_np(sc, _qmul_np(t, _qmul_np(sp, gp)))
            pert = R.from_rotvec(rng.normal(scale=np.radians(0.1), size=3))
            child_eulers.append((R.from_quat(np.roll(gc, -1)) * pert).as_euler("zxz",
                                                                               degrees=True))
            parent_of.append(p)
    parent_of = np.asarray(parent_of)
    edges = []
    for p in range(3):
        ids = np.where(parent_of == p)[0]
        edges += [(ids[i], ids[i + 1]) for i in range(len(ids) - 1)]
    edges += [(3, 4), (7, 8)]
    return np.asarray(child_eulers), np.asarray(edges), parent_of, parent_eulers


def _misorientation_deg(a, b, group="432"):
    qa, qb = (np.roll(R.from_euler("zxz", x, degrees=True).as_quat(), 1, axis=-1) for x in (a, b))
    sym = np.asarray(jc.symmetry_quats(group), np.float64)
    # max over s of |<s ⊗ qa, qb>|, pixel by pixel
    best = np.abs((_qmul_np(sym[:, None, :], qa[None, :, :]) * qb[None]).sum(-1)).max(0)
    return 2 * np.degrees(np.arccos(np.clip(best, 0.0, 1.0)))


@pytest.mark.parametrize("relationship", ["ks", "nw", "bain", "pitsch"])
def test_or_tables_equal_jax(relationship):
    np.testing.assert_array_equal(tc.or_rotation(relationship), jc.or_rotation(relationship))
    np.testing.assert_array_equal(tc.or_variant_table(relationship),
                                  jc.or_variant_table(relationship))
    child = _forward_map()[0][:5]
    np.testing.assert_allclose(tc.parent_candidates(child, relationship, device="cpu"),
                               jc.parent_candidates(child, relationship), atol=1e-6)


def test_grain_adjacency_equal_jax():
    labels = np.random.default_rng(0).integers(0, 6, (8, 9))
    np.testing.assert_array_equal(tc.grain_adjacency(labels), jc.grain_adjacency(labels))


@pytest.mark.parametrize("seed", [0, 4])
def test_reconstruction_matches_jax(seed, monkeypatch):
    from latice_tpu_torch.crystal import reconstruction as mod

    child, edges, truth, parents = _forward_map(seed=seed)
    got = tc.reconstruct_parents(child, edges, "ks", tolerance_deg=2.5, device="cpu")
    want = jc.reconstruct_parents(child, edges, "ks", tolerance_deg=2.5)
    assert got.n_parents == want.n_parents == 3
    np.testing.assert_array_equal(got.parent_labels, want.parent_labels)
    np.testing.assert_array_equal(got.variant, want.variant)
    assert _misorientation_deg(got.parent_orientation, want.parent_orientation).max() < 1e-3
    # Fits of ~0.1°: through cos(θ/2), where one f32 ulp of a dot is 6e-8.
    np.testing.assert_allclose(np.cos(np.radians(got.fit_deg) / 2),
                               np.cos(np.radians(want.fit_deg) / 2), atol=1e-6)
    # The planted parents, modulo parent symmetry.
    found = got.parent_orientation[got.parent_labels[[0, 4, 8]]]
    assert _misorientation_deg(found, parents).max() < 0.5
    for p in range(3):
        assert len(set(got.parent_labels[truth == p])) == 1
    # Blocks of 4 pairs give the one-block answer.
    monkeypatch.setattr(mod, "_EDGE_BLOCK", 4)
    small = tc.reconstruct_parents(child, edges, "ks", tolerance_deg=2.5, device="cpu")
    np.testing.assert_array_equal(small.parent_labels, got.parent_labels)
    np.testing.assert_array_equal(small.parent_orientation, got.parent_orientation)
    with pytest.raises(ValueError, match="adjacency references"):
        tc.reconstruct_parents(child[:3], edges, device="cpu")
