"""The port's master-pattern module (`latice_tpu_torch.sim.master`) against
latice_tpu.sim.master on the same seeded inputs, on the CPU.

* The Lambert maps, the square-Lambert import and `make_kinematical_master`
  are host float64 copies: within `HOST_ATOL` (float64 roundoff).
* `render_from_master` runs on the device in float32, the JAX package on
  the host in float32: within `RENDER_ATOL` of JAX's render at 64x64 from a
  257 master (crystal-frame directions summed in another order; measured
  2.3e-6 on min-max normalized patterns).
* `master_from_patterns` deposits with ``index_add_`` in float64, the JAX
  package with ``np.add.at``: the learned master within `LEARN_ATOL` and the
  weights within relative `WEIGHT_RTOL` (sums in another order).
* Both run on ``cuda`` unless given ``device="cpu"``, and raise without one.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.sim import DetectorGeometry as JGeom
from latice_tpu.sim import hexagonal_reflectors as j_hex
from latice_tpu.sim import master as jm
from latice_tpu_torch.sim import DetectorGeometry, hexagonal_reflectors
from latice_tpu_torch.sim import master as tm

HOST_ATOL = 1e-12
RENDER_ATOL = 1e-5
LEARN_ATOL, WEIGHT_RTOL = 1e-6, 1e-9


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def master():
    return jm.make_kinematical_master(size=257)


def _quats(n, seed):
    return np.roll(R.random(n, random_state=seed).as_quat(), 1, axis=1)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["directions_to_lambert", "lambert_to_directions",
                                "square_lambert_to_directions",
                                "_directions_to_square_lambert"])
def test_lambert_maps_match_jax(fn):
    x = _dirs(300, 0) if "directions_to" in fn else np.random.default_rng(1).uniform(
        -1, 1, (300, 2))
    np.testing.assert_allclose(getattr(tm, fn)(x), getattr(jm, fn)(x), atol=HOST_ATOL, rtol=0)


@pytest.mark.parametrize("size", [None, 97])
def test_resample_square_lambert_matches_jax(size):
    square = np.random.default_rng(2).random((65, 65))
    np.testing.assert_allclose(tm.resample_square_lambert(square, size),
                               jm.resample_square_lambert(square, size), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="square master"):
        tm.resample_square_lambert(square[:, :-1])


@pytest.mark.parametrize("phase", ["fcc", "hcp"])
def test_make_kinematical_master_matches_jax(master, phase):
    if phase == "fcc":
        got = tm.make_kinematical_master(size=257)
        want = master
    else:
        got = tm.make_kinematical_master(size=129, reflectors=hexagonal_reflectors())
        want = jm.make_kinematical_master(size=129, reflectors=j_hex())
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "kind, normalize, geometry",
    [("quats", True, dict(shape=(64, 64))), ("eulers", True, dict(shape=(64, 64))),
     ("quats", False, dict(shape=(48, 64), pcx=0.45, pcy=0.55, dd=0.65, tilt=10.0))],
    ids=["quats", "eulers", "raw_tilted"],
)
def test_render_matches_jax(master, kind, normalize, geometry):
    q = _quats(10, 3)
    o = R.from_quat(np.roll(q, -1, axis=1)).as_euler("zxz", degrees=True) if kind == "eulers" else q
    got = tm.render_from_master(master, o, DetectorGeometry(**geometry), normalize=normalize,
                                chunk=4, device="cpu")
    want = jm.render_from_master(master, o, JGeom(**geometry), normalize=normalize)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RENDER_ATOL, rtol=RENDER_ATOL)


def test_render_validation(master):
    with pytest.raises(ValueError, match="square"):
        tm.render_from_master(master[:, :-1], _quats(2, 0), device="cpu")
    with pytest.raises(ValueError, match="Euler"):
        tm.render_from_master(master, np.zeros((2, 5)), device="cpu")


@pytest.fixture(scope="module")
def scan(master):
    """24 renders at 64x64 and their orientations."""
    q = _quats(24, 4)
    geom = dict(shape=(64, 64))
    return q, jm.render_from_master(master, q, JGeom(**geom)), geom


@pytest.mark.parametrize("group", [None, "432"], ids=["raw", "symmetrized"])
def test_master_from_patterns_matches_jax(scan, group):
    q, pats, geom = scan
    got, got_w = tm.master_from_patterns(pats, q, DetectorGeometry(**geom), size=129,
                                         group=group, chunk=10, device="cpu")
    want, want_w = jm.master_from_patterns(pats, q, JGeom(**geom), size=129, group=group)
    assert got.dtype == np.float32 and got_w.dtype == np.float64
    np.testing.assert_allclose(got_w, want_w, rtol=WEIGHT_RTOL, atol=1e-12)
    np.testing.assert_allclose(got, want, atol=LEARN_ATOL, rtol=0)


def test_master_from_patterns_euler_input_and_uint8(scan):
    q, pats, geom = scan
    e = R.from_quat(np.roll(q, -1, axis=1)).as_euler("zxz", degrees=True)
    u8 = np.round(pats * 255).astype(np.uint8)
    got, _ = tm.master_from_patterns(u8, e, DetectorGeometry(**geom), size=65, device="cpu")
    want, _ = jm.master_from_patterns(u8, e, JGeom(**geom), size=65)
    np.testing.assert_allclose(got, want, atol=LEARN_ATOL, rtol=0)


def test_master_from_patterns_validation(scan):
    q, pats, geom = scan
    g = DetectorGeometry(**geom)
    with pytest.raises(ValueError, match="orientations"):
        tm.master_from_patterns(pats, q[:-1], g, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        tm.master_from_patterns(pats[:, :32], q, g, device="cpu")
    with pytest.raises(ValueError, match="point group"):
        tm.master_from_patterns(pats, q, g, group="999", device="cpu")
    with pytest.raises(ValueError, match="size"):
        tm.master_from_patterns(pats, q, g, size=2, device="cpu")


def test_device_defaults_to_cuda(master, scan):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    q, pats, geom = scan
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.render_from_master(master, q[:2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.master_from_patterns(pats, q, DetectorGeometry(**geom))
