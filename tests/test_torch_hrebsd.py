"""The port's HR-EBSD plane (`latice_tpu_torch.hrebsd`) against the JAX
package's on the same seeded numpy inputs, on the CPU.

Most cases run at a 128x128 detector with 32x32 ROIs (the 21-ROI default
layout), eight patterns in one chunk: four small deformations and four
lattice rotations of 2-3 degrees, where the remap pass matters. JAX's results
are computed once per module. Tolerances: shifts within `SHIFT_ATOL` px,
``a`` within `A_ATOL`, stress within `STRESS_RTOL` of its largest entry. The
remap pass's per-pattern acceptance (``rms2 < rms``) is compared on inputs
whose two residuals differ by far more than the residual tolerance.

The JAX suite's two accuracy anchors run on the port alone at their own
256x256 settings (64x64 ROIs, upsample 50), held to the truth at 1e-4:
`tests/test_hrebsd.py::TestDeformationRecovery::test_rotation_only` and
`::TestIterativeRemapping::test_three_degree_rotation_recovers_strain`.
They run one pattern per chunk: the default chunk pads it with copies of
itself, which changes no result.

Synthetic oracle (tests/test_hrebsd.py's): patterns are a smooth function of
the unit scattering direction, so a deformed pattern is rendered exactly at
the back-deformed directions ``normalize((I+A)^{-1} r)``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import latice_tpu.hrebsd as jh
from latice_tpu.crystal.elastic import CUBIC_STIFFNESS, cubic_stiffness
from latice_tpu.sim.calibrate import ScanCalibration as JaxCalibration
from latice_tpu.sim.geometry import DetectorGeometry
import latice_tpu_torch.hrebsd as th
from latice_tpu_torch.sim import ScanCalibration
from latice_tpu_torch.sim import DetectorGeometry as PortGeometry

SHIFT_ATOL = 1e-3  # px
A_ATOL = 1e-6
STRESS_RTOL = 1e-4
QUALITY_ATOL = 1e-5
RESIDUAL_ATOL = 1e-5  # px
ROI = 32
GEOM = DetectorGeometry(shape=(128, 128))
PGEOM = PortGeometry(shape=(128, 128))
ANCHOR = DetectorGeometry(shape=(256, 256))
PANCHOR = PortGeometry(shape=(256, 256))


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _band_function(seed: int, n_waves: int = 60):
    """A broadband sum of 3-D cosine waves of the unit direction
    (tests/test_hrebsd.py's oracle)."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(n_waves, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    mag = rng.uniform(100.0, 500.0, size=(n_waves, 1))
    k *= mag
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    amp = mag[:, 0] ** -0.5

    def f(u):
        return (amp * np.cos(u @ k.T + phase)).sum(axis=-1)

    return f


def _render(f, geometry, a=None, pc=None):
    """Pattern under deformation gradient ``I + a`` at pattern center ``pc``
    (the geometry's by default)."""
    h, w = geometry.shape
    pcx, pcy, dd = (geometry.pcx, geometry.pcy, geometry.dd) if pc is None else pc
    x = (np.arange(w) + 0.5) / w - pcx
    y = (h - (np.arange(h) + 0.5)) / w - pcy
    r = np.stack(
        [np.broadcast_to(x[None, :], (h, w)), np.broadcast_to(y[:, None], (h, w)),
         np.full((h, w), dd)],
        axis=-1,
    )
    if a is not None:
        r = r @ np.linalg.inv(np.eye(3) + a).T
    u = r / np.linalg.norm(r, axis=-1, keepdims=True)
    return f(u).astype(np.float32)


def _make_a(strain_xx, strain_yy, strain_xy, rot_vec):
    eps = np.array([[strain_xx, strain_xy, 0.0], [strain_xy, strain_yy, 0.0], [0.0, 0.0, 0.0]])
    wx, wy, wz = rot_vec
    return eps + np.array([[0.0, -wz, wy], [wz, 0.0, -wx], [-wy, wx, 0.0]])


def _rotated(theta_deg, axis, eps):
    """``R(I + eps) - I`` in the solve's ``a33 = 0`` gauge."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    rot = R.from_rotvec(np.radians(theta_deg) * axis).as_matrix()
    a = rot @ (np.eye(3) + eps) - np.eye(3)
    return a - a[2, 2] * np.eye(3)


def _u8(img):
    lo, hi = img.min(), img.max()
    return np.clip((img - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def case():
    """Eight 128x128 patterns of one grain and JAX's results on them."""
    f = _band_function(9)
    ref = _render(f, GEOM)
    rng = np.random.default_rng(2)
    a_true = []
    for i in range(8):
        eps = _make_a(*rng.uniform(-2e-3, 2e-3, 3), (0.0, 0.0, 0.0))
        if i < 4:
            a_true.append(eps + _make_a(0, 0, 0, rng.uniform(-2e-3, 2e-3, 3)))
        else:
            a_true.append(_rotated(rng.uniform(2.0, 3.0), rng.normal(size=3), eps))
    a_true = np.stack(a_true)
    pats = np.stack([_render(f, GEOM, a) for a in a_true])
    centers = jh.default_roi_centers(GEOM, roi_size=ROI)
    quats = np.roll(R.random(8, random_state=4).as_quat(), 1, axis=1).astype(np.float32)
    kw = dict(centers=centers, roi_size=ROI, chunk=8)
    jax = {
        "remap0": jh.hrebsd_map(pats, ref, GEOM, remap_iterations=0, **kw),
        "remap1": jh.hrebsd_map(pats, ref, GEOM, remap_iterations=1, **kw),
        "stiffness": jh.hrebsd_map(pats, ref, GEOM, stiffness=cubic_stiffness(
            *CUBIC_STIFFNESS["ni"]), **kw),
        "orientations": jh.hrebsd_map(pats, ref, GEOM, stiffness=cubic_stiffness(
            *CUBIC_STIFFNESS["cu"]), orientations=quats, **kw),
    }
    return dict(ref=ref, pats=pats, a_true=a_true, centers=centers, quats=quats, kw=kw,
                jax=jax)


def _hold(got, want):
    np.testing.assert_allclose(got.shifts_px, want.shifts_px, atol=SHIFT_ATOL, rtol=0)
    np.testing.assert_allclose(got.a, want.a, atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got.strain, want.strain, atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got.rotation, want.rotation, atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got.quality, want.quality, atol=QUALITY_ATOL, rtol=0)
    np.testing.assert_allclose(got.residual_px, want.residual_px, atol=RESIDUAL_ATOL, rtol=0)
    assert (got.stress is None) == (want.stress is None)
    if want.stress is not None:
        scale = np.abs(want.stress).max()
        np.testing.assert_allclose(got.stress, want.stress, atol=STRESS_RTOL * scale, rtol=0)


def test_remap_core_matches_jax(case):
    x = case["pats"]
    f = (np.eye(3) + case["a_true"]).astype(np.float32)
    base = th._pixel_screen_vectors(PGEOM)
    np.testing.assert_array_equal(base, jh._pixel_screen_vectors(GEOM))
    pc = np.tile(np.asarray([0.51, 0.48, 0.69], np.float32), (len(x), 1))
    # The sample points agree to f32 roundoff of a 128-px coordinate
    # (~1e-5 px); times the oracle's steepest slope (~3 per px) that is
    # ~1e-4 of the pattern's range.
    for arr in (x, _u8(x)):
        want = np.asarray(jh._remap_core(jnp.asarray(arr), jnp.asarray(f), jnp.asarray(base),
                                         jnp.asarray(pc)))
        got = th._remap_core(*(torch.from_numpy(np.ascontiguousarray(v))
                               for v in (arr, f, base, pc))).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * np.ptp(want), rtol=0)
    got = th.remap_patterns(x, case["a_true"], PGEOM, chunk=3, device="cpu")
    want = jh.remap_patterns(x, case["a_true"], GEOM, chunk=3)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.ptp(want), rtol=0)


@pytest.mark.parametrize("mode", ["f32", "uint8", "deformation"])
def test_measure_roi_shifts_matches_jax(case, mode):
    ref, pats, centers = case["ref"], case["pats"], case["centers"]
    kw = dict(roi_size=ROI, chunk=5)  # 8 patterns: the second chunk is padded
    if mode == "uint8":
        ref, pats = _u8(ref), _u8(pats)
    if mode == "deformation":
        kw.update(deformation=case["a_true"] * 0.9, pc=np.tile([0.5, 0.5, 0.7], (8, 1)))
    want_s, want_q = jh.measure_roi_shifts(ref, pats, centers, geometry=GEOM, **kw)
    got_s, got_q = th.measure_roi_shifts(ref, pats, centers, geometry=PGEOM, device="cpu", **kw)
    assert got_s.dtype == np.float64 and got_s.shape == (8, len(centers), 2)
    np.testing.assert_allclose(got_s, want_s, atol=SHIFT_ATOL, rtol=0)
    np.testing.assert_allclose(got_q, want_q, atol=QUALITY_ATOL, rtol=0)
    if mode == "uint8":  # uint8 widens on the device: the same as widened f32
        f_s, f_q = th.measure_roi_shifts(ref.astype(np.float32), pats.astype(np.float32),
                                         centers, device="cpu", **kw)
        np.testing.assert_array_equal(got_s, f_s)
        np.testing.assert_array_equal(got_q, f_q)


def test_solve_deformation_matches_jax(case):
    """With a per-pattern PC field and ROIs dropped by ``min_quality``."""
    centers = case["centers"]
    shifts, quality = case["jax"]["remap0"].shifts_px, case["jax"]["remap0"].quality.copy()
    quality[:, 3] = 0.05
    pc = np.asarray([0.5, 0.5, 0.7]) + np.random.default_rng(5).uniform(-2e-3, 2e-3, (8, 3))
    want_a, want_rms = jh.solve_deformation(shifts, quality, GEOM, centers, 0.1, pc=pc)
    got_a, got_rms = th.solve_deformation(shifts, quality, PGEOM, centers, 0.1, pc=pc,
                                          device="cpu")
    np.testing.assert_allclose(got_a, want_a, atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got_rms, want_rms, atol=RESIDUAL_ATOL / 128, rtol=0)
    assert np.all(got_a[:, 2, 2] == 0.0)


def test_traction_free_matches_jax(case):
    from latice_tpu.crystal.quaternion import quat_to_matrix as jax_q2m

    rng = np.random.default_rng(6)
    a_gauge = rng.uniform(-3e-3, 3e-3, (8, 3, 3)).astype(np.float32)
    a_gauge[:, 2, 2] = 0.0
    c0 = jh._stiffness_tensor(cubic_stiffness(*CUBIC_STIFFNESS["fe-alpha"])).astype(np.float32)
    g = np.array(jax_q2m(jnp.asarray(case["quats"])))
    c4 = np.array(jnp.einsum("bia,bjc,bkd,ble,acde->bijkl", g, g, g, g, c0,
                             precision="highest"))
    got_c4 = th._rotate_stiffness(torch.from_numpy(g), torch.from_numpy(c0)).numpy()
    np.testing.assert_allclose(got_c4, c4, atol=1e-4 * np.abs(c4).max(), rtol=0)
    t = np.radians(20.0)
    normal = np.asarray([0.0, -np.sin(t), np.cos(t)], np.float32)
    want = [np.asarray(v) for v in jh._traction_free(jnp.asarray(a_gauge), jnp.asarray(c4),
                                                     jnp.asarray(normal))]
    got = [v.numpy() for v in th._traction_free(*(torch.from_numpy(v)
                                                  for v in (a_gauge, c4, normal)))]
    np.testing.assert_allclose(got[0], want[0], atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=STRESS_RTOL * np.abs(want[2]).max(), rtol=0)
    # sigma_nn vanishes: the closure's condition.
    snn = np.einsum("i,bij,j->b", normal, got[2], normal)
    assert np.abs(snn).max() < 1e-4 * np.abs(got[2]).max()


@pytest.mark.parametrize("mode", ["remap0", "remap1", "stiffness", "orientations"])
def test_hrebsd_map_matches_jax(case, mode):
    kw = dict(case["kw"], device="cpu")
    if mode == "remap0":
        kw["remap_iterations"] = 0
    elif mode == "stiffness":
        kw["stiffness"] = cubic_stiffness(*CUBIC_STIFFNESS["ni"])
    elif mode == "orientations":
        kw.update(stiffness=cubic_stiffness(*CUBIC_STIFFNESS["cu"]), orientations=case["quats"])
    got = th.hrebsd_map(case["pats"], case["ref"], PGEOM, **kw)
    _hold(got, case["jax"][mode])


def test_remap_acceptance_matches_jax(case):
    """``rms2 < rms`` per pattern, on inputs where the two residuals of
    every pattern differ by more than 50x the residual tolerance."""
    j0, j1 = case["jax"]["remap0"], case["jax"]["remap1"]
    centers = case["centers"]
    s2, q2 = jh.measure_roi_shifts(case["ref"], case["pats"], centers, roi_size=ROI, chunk=8,
                                   deformation=j0.a, geometry=GEOM)  # hrebsd_map's remap pass
    _, rms2 = jh.solve_deformation(s2, q2, GEOM, centers, min_quality=0.1)
    margin = np.abs(rms2 * 128 - j0.residual_px)
    assert margin.min() > 50 * RESIDUAL_ATOL
    want_accept = rms2 * 128 < j0.residual_px
    p0 = th.hrebsd_map(case["pats"], case["ref"], PGEOM, remap_iterations=0, device="cpu",
                       **case["kw"])
    p1 = th.hrebsd_map(case["pats"], case["ref"], PGEOM, remap_iterations=1, device="cpu",
                       **case["kw"])
    got_accept = p1.residual_px < p0.residual_px
    np.testing.assert_array_equal(got_accept, want_accept)
    np.testing.assert_array_equal(want_accept, j1.residual_px < j0.residual_px)
    # The large rotations take the remap and land nearer the truth.
    assert want_accept[4:].all()
    err0 = np.abs(p0.a - case["a_true"])[4:].max()
    err1 = np.abs(p1.a - case["a_true"])[4:].max()
    assert err1 < err0


def test_calibration_matches_jax():
    """A scan-varying PC field: patterns rendered at their own PCs, the
    second also deformed; the map through `ScanCalibration` and ``scan_xy``
    against JAX's."""
    f = _band_function(73)
    pc0 = np.array([0.5, 0.5, 0.7])
    grad = np.array([[2e-3, 0.0], [0.0, -1.5e-3], [1e-3, 0.0]])
    scan_xy = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 0.0], [0.0, 2.0]])
    jcal = JaxCalibration(pc0=pc0, gradient=grad, shape=GEOM.shape, tilt=0.0)
    pcal = ScanCalibration(pc0=pc0, gradient=grad, shape=GEOM.shape, tilt=0.0)
    a_true = _make_a(2e-3, -1e-3, 5e-4, (1e-3, -5e-4, 1e-3))
    pats = np.stack([_render(f, GEOM, a_true if i % 2 else None, pc)
                     for i, pc in enumerate(jcal.pc_at(scan_xy))])
    kw = dict(roi_size=ROI, chunk=4, remap_iterations=1, scan_xy=scan_xy)
    want = jh.hrebsd_map(pats, pats[0], jcal.geometry_at(scan_xy[0]), calibration=jcal, **kw)
    got = th.hrebsd_map(pats, pats[0], pcal.geometry_at(scan_xy[0]), calibration=pcal,
                        device="cpu", **kw)
    _hold(got, want)
    with pytest.raises(ValueError, match="scan_xy"):
        th.hrebsd_map(pats, pats[0], PGEOM, calibration=pcal, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        th.hrebsd_map(pats, pats[0], PGEOM, calibration=pcal, scan_xy=scan_xy,
                      pc=np.zeros((4, 3)), device="cpu")
    with pytest.raises(ValueError, match="pc must be"):
        th.hrebsd_map(pats, pats[0], PGEOM, pc=np.zeros((2, 3)), device="cpu")


def test_anchor_rotation_only():
    """tests/test_hrebsd.py::TestDeformationRecovery::test_rotation_only on
    the port."""
    f = _band_function(11)
    ref = _render(f, ANCHOR)
    rot = np.array([1.5e-3, -2.5e-3, 2e-3])
    res = th.hrebsd_map(_render(f, ANCHOR, _make_a(0, 0, 0, rot))[None], ref, PANCHOR,
                        upsample=50, chunk=1, device="cpu")
    assert np.max(np.abs(res.rotation[0] - rot)) < 1e-4
    assert np.max(np.abs(res.strain[0])) < 1e-4
    assert abs(res.rotation_deg[0] - np.degrees(np.linalg.norm(rot))) < 0.005


def test_anchor_three_degree_rotation_recovers_strain():
    """tests/test_hrebsd.py::TestIterativeRemapping::
    test_three_degree_rotation_recovers_strain on the port: the bare solve
    biases A past 4e-4, one remap pass brings it under 1e-4."""
    f = _band_function(57)
    ref = _render(f, ANCHOR)
    eps = np.array([[1e-3, 3e-4, 0.0], [3e-4, -8e-4, 2e-4], [0.0, 2e-4, 0.0]])
    a_true = _rotated(3.0, [0.3, -0.5, 0.8], eps)
    pat = _render(f, ANCHOR, a_true)[None]
    bare = th.hrebsd_map(pat, ref, PANCHOR, upsample=50, remap_iterations=0, chunk=1,
                         device="cpu")
    remapped = th.hrebsd_map(pat, ref, PANCHOR, upsample=50, remap_iterations=1, chunk=1,
                             device="cpu")
    assert np.max(np.abs(bare.a[0] - a_true)) > 4e-4
    assert np.max(np.abs(remapped.a[0] - a_true)) < 1e-4
    assert remapped.residual_px[0] < bare.residual_px[0]
    assert remapped.quality.mean() > bare.quality.mean()


def test_helpers_match_jax():
    for shape, roi in (((128, 128), 32), ((256, 256), 64), ((96, 128), 32)):
        jg, pg = DetectorGeometry(shape=shape, pcx=0.52, pcy=0.47), PortGeometry(
            shape=shape, pcx=0.52, pcy=0.47)
        c = th.default_roi_centers(pg, roi_size=roi)
        np.testing.assert_array_equal(c, jh.default_roi_centers(jg, roi_size=roi))
        np.testing.assert_array_equal(th.roi_position_vectors(pg, c),
                                      jh.roi_position_vectors(jg, c))
        np.testing.assert_array_equal(th._design_matrix(th.roi_position_vectors(pg, c), 0.7),
                                      jh._design_matrix(jh.roi_position_vectors(jg, c), 0.7))
    np.testing.assert_array_equal(th._hann2(32), jh._hann2(32))
    np.testing.assert_array_equal(th._annular_mask(32, 1.5, 12.0), jh._annular_mask(32, 1.5, 12.0))
    e = np.random.default_rng(0).normal(size=(4, 3, 3))
    np.testing.assert_array_equal(th.von_mises_strain(e), jh.von_mises_strain(e))
    v = cubic_stiffness(*CUBIC_STIFFNESS["w"])
    np.testing.assert_array_equal(th._stiffness_tensor(v), jh._stiffness_tensor(v))


def test_validation_and_device():
    centers = th.default_roi_centers(PGEOM, roi_size=ROI)
    z = np.zeros((128, 128), np.float32)
    with pytest.raises(ValueError, match="expected"):
        th.measure_roi_shifts(z, z, centers, roi_size=ROI, device="cpu")
    with pytest.raises(ValueError, match="reference"):
        th.measure_roi_shifts(np.zeros((64, 64), np.float32), z[None], centers, roi_size=ROI,
                              device="cpu")
    with pytest.raises(ValueError, match="outside"):
        th.measure_roi_shifts(z, z[None], np.array([[5.0, 64.0]]), roi_size=ROI, device="cpu")
    with pytest.raises(ValueError, match="requires geometry"):
        th.measure_roi_shifts(z, z[None], centers, roi_size=ROI, deformation=np.zeros((1, 3, 3)),
                              device="cpu")
    with pytest.raises(ValueError, match="expected"):
        th.remap_patterns(np.zeros((4, 4), np.float32), np.eye(3), PGEOM, device="cpu")
    with pytest.raises(ValueError, match="deformation"):
        th.remap_patterns(np.zeros((2, 64, 64), np.float32), np.zeros((3, 3, 3)), PGEOM,
                          device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        th.default_roi_centers(PortGeometry(shape=(64, 64)), roi_size=64)
    # mesh= takes a parallel.Mesh (tests/test_torch_parallel_paths.py runs it).
    with pytest.raises(TypeError, match="Mesh"):
        th.hrebsd_map(z[None], z, PGEOM, roi_size=ROI, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        # Entry points run on cuda unless asked: no silent CPU run.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            th.hrebsd_map(z[None], z, PGEOM, roi_size=ROI)
