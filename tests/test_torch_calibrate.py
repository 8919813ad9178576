"""The port's pattern-center calibration against latice_tpu.sim.calibrate, on
the CPU, on fcc renders (max_hkl 2) at known pattern centers.

* The differentiable pixel directions: within 1e-6 of the host
  `pixel_directions` and of the JAX package's `_pixel_directions_jax`.
* Shared and affine fits from starts off the optimum (the nominal PC and
  orientations turned 1 degree): PCs within `PC_ATOL` of JAX's, gradients
  (times the scan span) within `PC_ATOL`, orientations within `ORIENT_DEG`
  and the mean NCC within `NCC_ATOL`. Measured after 60-300 steps: PCs
  1e-7 apart, orientations 6e-8 apart in components.
* Adam normalizes each step by the gradient's size, so at the optimum
  roundoff-sized gradients become lr-sized steps that differ between the
  two (`tests/test_torch_refine.py`): from the exact start the PCs are
  held within `AT_OPTIMUM_PC` of JAX's, the JAX test's own bound, and the
  NCC within `AT_OPTIMUM_NCC` (measured 1.5e-5 apart).
* The port is also held to tests/sim/test_calibrate.py's bounds on the
  metrological (pinned) fits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu import sim as jsim
from latice_tpu.sim.calibrate import _pixel_directions_jax
from latice_tpu_torch import sim as tsim
from latice_tpu_torch.sim.calibrate import _pixel_directions

PC_ATOL = 1e-5
ORIENT_DEG = 1e-4
NCC_ATOL = 1e-5
AT_OPTIMUM_PC = 2e-3
AT_OPTIMUM_NCC = 1e-4
PC0_TRUE = np.array([0.52, 0.47, 0.68])
G_TRUE = np.array([[-0.03 / 120.0, 0.0], [0.0, 0.02 / 90.0], [0.0, 0.01 / 90.0]])
SPAN = np.array([120.0, 90.0])


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _mis_deg(a, b):
    ra, rb = (R.from_quat(np.roll(np.asarray(q, np.float64), -1, axis=-1)) for q in (a, b))
    return np.degrees((ra.inv() * rb).magnitude())


def _geoms(size, pc=(0.5, 0.5, 0.7)):
    kw = dict(shape=(size, size), pcx=pc[0], pcy=pc[1], dd=pc[2])
    return jsim.DetectorGeometry(**kw), tsim.DetectorGeometry(**kw)


def test_pixel_directions_match():
    g = tsim.DetectorGeometry(shape=(48, 40), pcx=0.43, pcy=0.58, dd=0.66, tilt=7.0)
    pc = torch.tensor([g.pcx, g.pcy, g.dd], dtype=torch.float32)
    tilt = torch.tensor(np.radians(g.tilt), dtype=torch.float32)
    got = _pixel_directions(g.shape, pc, tilt).numpy()
    np.testing.assert_allclose(got, tsim.pixel_directions(g).reshape(-1, 3), atol=1e-6)
    want = np.asarray(_pixel_directions_jax(g.shape, jnp.float32(g.pcx), jnp.float32(g.pcy),
                                            jnp.float32(g.dd), jnp.float32(np.radians(g.tilt))))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # A stack of pattern centers gives each its own directions.
    both = _pixel_directions(g.shape, torch.stack([pc, pc + 0.01]), tilt)
    assert both.shape == (2, 48 * 40, 3)
    np.testing.assert_array_equal(both[0].numpy(), got)


@pytest.fixture(scope="module")
def shared():
    """tests/sim/test_calibrate.py::TestCalibrate's inputs, drawn from its
    seed: 12 renders at PC (0.52, 0.47, 0.68) and starts turned 1 degree."""
    rng = np.random.default_rng(0)
    truth = R.random(12, random_state=rng)
    tq = np.roll(truth.as_quat(), 1, axis=1).astype(np.float32)
    jg, _ = _geoms(64, PC0_TRUE)
    refl = (jsim.cubic_reflectors("fcc", max_hkl=2, min_d=1.0),
            tsim.cubic_reflectors("fcc", max_hkl=2, min_d=1.0))
    patterns = jsim.simulate_patterns(tq, jg, refl[0])
    axes = rng.normal(size=(len(tq), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    init = np.roll((R.from_rotvec(np.radians(1.0) * axes) * truth).as_quat(), 1,
                   axis=1).astype(np.float32)
    return refl, truth, tq, patterns, init


def _fit_both(fn, args, refl, size=64, pc=(0.5, 0.5, 0.7), **kw):
    jg, tg = _geoms(size, pc)
    want = getattr(jsim, fn)(*args, jg, refl[0], **kw)
    got = getattr(tsim, fn)(*args, tg, refl[1], device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("case", ["joint", "pinned", "exact"])
def test_shared_fit_matches_jax(shared, case):
    refl, truth, tq, patterns, init = shared
    if case == "exact":  # tests/sim/test_calibrate.py::test_exact_start_stays
        (fit, q, ncc), (jfit, jq, jncc) = _fit_both("calibrate_geometry", (patterns, tq), refl,
                                                     pc=PC0_TRUE, steps=40)
        got, want = (np.array([f.pcx, f.pcy, f.dd]) for f in (fit, jfit))
        np.testing.assert_allclose(got, want, atol=AT_OPTIMUM_PC, rtol=0)
        assert abs(fit.pcx - PC0_TRUE[0]) < 2e-3 and abs(fit.dd - PC0_TRUE[2]) < 3e-3
        assert ncc > 0.99 and abs(ncc - jncc) < AT_OPTIMUM_NCC
        return
    pinned = case == "pinned"
    (fit, q, ncc), (jfit, jq, jncc) = _fit_both(
        "calibrate_geometry", (patterns, tq if pinned else init), refl, steps=300, lr_pc=4e-3,
        lr_orientation=0.0 if pinned else 2e-3)
    assert isinstance(fit, tsim.DetectorGeometry) and fit.shape == (64, 64)
    got, want = (np.array([f.pcx, f.pcy, f.dd]) for f in (fit, jfit))
    np.testing.assert_allclose(got, want, atol=PC_ATOL, rtol=0)
    assert q.shape == (12, 4) and q.dtype == np.float32
    assert _mis_deg(q, jq).max() < ORIENT_DEG and abs(ncc - jncc) < NCC_ATOL
    err = np.abs(got - PC0_TRUE)
    if pinned:  # test_known_crystal_pins_pc_tightly
        assert err[0] < 2e-3 and err[1] < 2e-3 and err[2] < 3e-3
        np.testing.assert_allclose(q, tq, atol=1e-6)
    else:  # test_recovers_pattern_center
        assert err[0] < 6e-3 and err[1] < 6e-3 and err[2] < 5e-3 and ncc > 0.99
        assert np.median(_mis_deg(q, tq)) < 1.0


@pytest.fixture(scope="module")
def scan():
    """tests/sim/test_calibrate.py::TestScanCalibrate's affine model over a
    4x3 scan, rendered pattern by pattern at 32x32."""
    rng = np.random.default_rng(0)
    refl = (jsim.cubic_reflectors("fcc", max_hkl=2, min_d=1.0),
            tsim.cubic_reflectors("fcc", max_hkl=2, min_d=1.0))
    scan_xy = np.array([(x, y) for y in np.linspace(0, 90, 3) for x in np.linspace(0, 120, 4)])
    truth = R.random(len(scan_xy), random_state=rng)
    tq = np.roll(truth.as_quat(), 1, axis=1).astype(np.float32)
    pats = []
    for i, xy in enumerate(scan_xy):
        pc = PC0_TRUE + G_TRUE @ xy
        pats.append(jsim.simulate_patterns(tq[i:i + 1], _geoms(32, pc)[0], refl[0])[0])
    axes = rng.normal(size=(len(tq), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    init = np.roll((R.from_rotvec(np.radians(1.0) * axes) * truth).as_quat(), 1,
                   axis=1).astype(np.float32)
    return refl, scan_xy, tq, np.stack(pats), init


@pytest.mark.parametrize("case", ["joint", "pinned", "line"])
def test_scan_fit_matches_jax(scan, case):
    refl, scan_xy, tq, patterns, init = scan
    xy = scan_xy.copy()
    if case == "line":  # a constant scan axis (test_constant_axis_is_conditioned)
        xy[:, 1] = 7.0
    kw = dict(steps=120, lr_orientation=0.0 if case == "pinned" else 2e-3)
    (fit, q, ncc), (jfit, jq, jncc) = _fit_both(
        "calibrate_scan_geometry", (patterns, tq if case == "pinned" else init, xy), refl,
        size=32, **kw)
    assert isinstance(fit, tsim.ScanCalibration) and fit.shape == (32, 32)
    np.testing.assert_allclose(fit.pc0, jfit.pc0, atol=PC_ATOL, rtol=0)
    np.testing.assert_allclose(fit.gradient * SPAN, jfit.gradient * SPAN, atol=PC_ATOL, rtol=0)
    assert _mis_deg(q, jq).max() < ORIENT_DEG and abs(ncc - jncc) < NCC_ATOL
    assert np.isfinite(fit.pc0).all() and np.isfinite(fit.gradient).all()
    if case == "pinned":
        np.testing.assert_allclose(q, tq, atol=1e-6)
        assert np.abs(fit.pc0 - PC0_TRUE).max() < 2e-3


def test_scan_model_and_validation(scan):
    refl, scan_xy, tq, patterns, _ = scan
    fit = tsim.ScanCalibration(pc0=PC0_TRUE, gradient=G_TRUE, shape=(32, 32), tilt=0.0)
    xy = np.array([60.0, 45.0])
    np.testing.assert_allclose(fit.pc_at(xy), PC0_TRUE + G_TRUE @ xy)
    assert fit.pc_at(np.stack([xy, xy, xy])).shape == (3, 3)
    geom = fit.geometry_at(xy)
    assert isinstance(geom, tsim.DetectorGeometry) and geom.shape == (32, 32)
    np.testing.assert_allclose([geom.pcx, geom.pcy, geom.dd], PC0_TRUE + G_TRUE @ xy)
    g = tsim.DetectorGeometry(shape=(32, 32))
    with pytest.raises(ValueError, match="scan_xy"):
        tsim.calibrate_scan_geometry(patterns, tq, scan_xy[:3], g, refl[1], device="cpu")
    with pytest.raises(ValueError, match="init_quats"):
        tsim.calibrate_scan_geometry(patterns, tq[:3], scan_xy, g, refl[1], device="cpu")
    with pytest.raises(ValueError, match="patterns"):
        tsim.calibrate_geometry(patterns[:, :16, :16], tq, g, refl[1], device="cpu")
    with pytest.raises(ValueError, match="init_quats"):
        tsim.calibrate_geometry(patterns, tq[:3], g, refl[1], device="cpu")
