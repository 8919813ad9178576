"""The port's Hough indexing against latice_tpu.index.hough_indexing, on the
CPU, on fcc and hcp renders at 64x64 with a 4-degree grid (the JAX tests'
setting).

* `band_plane_normals` is host float64 copied from the JAX package: bitwise.
* `solve_wahba`: the eigh path within `QUAT_ATOL` of JAX's (both take the
  canonical sign), the seeded power path within `QUAT_ATOL` of JAX's and
  within the 5e-5 of `test_power_iteration_matches_eigh` of the port's own
  eigh.
* `_index_bands` on identical inputs: with no refinement round the
  winner's grid candidate and its vote equal JAX's (votes within
  `VOTE_ATOL`); after two rounds the orientations lie within
  `ORIENT_DEG` of JAX's. Ranks are held within `RANK_ATOL` and fits within
  `FIT_ATOL_DEG`: both take arccos of dots near 1, which turns f32 roundoff
  of the dot into ~1e-4 of rank (measured 2e-4). After refinement,
  candidates in one basin reach the same orientation with ranks a few 1e-6
  apart, so which of them wins may differ and the winner's vote is not
  compared.
* `HoughIndexer` and `MultiPhaseHoughIndexer` end to end: orientations
  within `ORIENT_DEG` of JAX's (misorientation of the fundamental-zone
  quaternions, measured 1.5e-5), the same success, matched counts and
  phases, and the JAX tests' accuracy bounds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.crystal.symmetry import ROTATION_GROUPS
from latice_tpu.data.hough import BandDetector as JaxDetector
from latice_tpu.index import hough_indexing as jhi
from latice_tpu.sim import DetectorGeometry, cubic_reflectors, hexagonal_reflectors
from latice_tpu.sim import simulate_patterns
from latice_tpu_torch import sim as tsim
from latice_tpu_torch.data import BandDetector
from latice_tpu_torch.index import hough_indexing as thi

QUAT_ATOL = 1e-5
ORIENT_DEG = 1e-3
VOTE_ATOL = 1e-4
RANK_ATOL = 1e-2
FIT_ATOL_DEG = 1e-2
DET = dict(height=64, width=64, n_theta=90, n_rho=64, k=8, band_width_px=5.0, batch_size=16)
KW = dict(grid_resolution_deg=4.0, n_bands=8, tolerance_deg=4.0, batch_size=16)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _mis_deg(a, b, group):
    """Least misorientation over the group's images, degrees."""
    sym = R.from_quat(np.roll(ROTATION_GROUPS[group], -1, axis=1))
    ra, rb = (R.from_quat(np.roll(np.atleast_2d(q), -1, axis=1)) for q in (a, b))
    return np.array([math.degrees(min(((x * s).inv() * y).magnitude() for s in sym))
                     for x, y in zip(ra, rb)])


def _quat_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.minimum(np.linalg.norm(a - b, axis=-1), np.linalg.norm(a + b, axis=-1))


@pytest.mark.parametrize(
    "geometry",
    [DetectorGeometry(), DetectorGeometry(shape=(96, 128), pcx=0.45, pcy=0.55, dd=0.65),
     DetectorGeometry(pcx=0.4, pcy=0.6, dd=0.8, tilt=10.0)],
    ids=["default", "offset", "tilted"],
)
def test_band_plane_normals_bitwise(geometry):
    rng = np.random.default_rng(0)
    theta, rho = rng.uniform(0, 180, (5, 7)), rng.uniform(-60, 60, (5, 7))
    port_geom = tsim.DetectorGeometry(shape=geometry.shape, pcx=geometry.pcx, pcy=geometry.pcy,
                                      dd=geometry.dd, tilt=geometry.tilt)
    got = thi.band_plane_normals(theta, rho, port_geom)
    want = jhi.band_plane_normals(theta, rho, geometry)
    assert got.shape == (5, 7, 3) and got.tobytes() == want.tobytes()


def _wahba_inputs(n, seed, noise=0.0, masked=0):
    rng = np.random.default_rng(seed)
    rots = R.random(n, random_state=seed + 1)
    c = rng.normal(size=(n, 8, 3))
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    nv = np.einsum("bij,bkj->bki", rots.as_matrix(), c) + rng.normal(scale=noise, size=(n, 8, 3))
    nv /= np.linalg.norm(nv, axis=-1, keepdims=True)
    w = rng.uniform(0.2, 1.0, size=(n, 8))
    if masked:
        w[:, -masked:] = 0.0
    b_mat = np.einsum("bk,bki,bkj->bij", w, nv, c).astype(np.float32)
    pert = R.from_rotvec(rng.normal(scale=np.radians(3.0), size=(n, 3)))
    seed_q = np.roll((rots * pert).as_quat(), 1, axis=1).astype(np.float32)
    return b_mat, seed_q, np.roll(rots.as_quat(), 1, axis=1)


def test_solve_wahba_matches_jax():
    """tests/index/test_hough_indexing.py's exact-recovery and
    power-iteration inputs: eigh and the seeded path, each against JAX's,
    and the seeded path against the port's eigh at 5e-5."""
    b_mat, _, truth = _wahba_inputs(6, 3)
    got = thi.solve_wahba(torch.from_numpy(b_mat)).numpy()
    want = np.asarray(jhi.solve_wahba(jnp.asarray(b_mat)))
    assert (got[:, 0] >= 0).all()
    np.testing.assert_allclose(got, want, atol=QUAT_ATOL, rtol=0)
    assert _quat_err(got, truth).max() < 1e-3

    b_mat, seed_q, _ = _wahba_inputs(64, 5, noise=0.02, masked=2)
    exact = thi.solve_wahba(torch.from_numpy(b_mat)).numpy()
    seeded = thi.solve_wahba(torch.from_numpy(b_mat), init=torch.from_numpy(seed_q)).numpy()
    want = np.asarray(jhi.solve_wahba(jnp.asarray(b_mat), init=jnp.asarray(seed_q)))
    np.testing.assert_allclose(seeded, want, atol=QUAT_ATOL, rtol=0)
    assert _quat_err(seeded, exact).max() < 5e-5
    np.testing.assert_allclose(exact, np.asarray(jhi.solve_wahba(jnp.asarray(b_mat))),
                               atol=QUAT_ATOL, rtol=0)


def test_solve_wahba_zero_matrix_and_outlier():
    seed = np.asarray([[0.9, 0.1, 0.3, -0.2]], np.float32)
    seed /= np.linalg.norm(seed)
    q = thi.solve_wahba(torch.zeros((1, 3, 3)), init=torch.from_numpy(seed)).numpy()
    assert np.isfinite(q).all() and abs(np.linalg.norm(q[0]) - 1.0) < 1e-5
    rng = np.random.default_rng(4)
    rot = R.random(1, random_state=2)
    c = rng.normal(size=(8, 3))
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    n_bad = c @ rot.as_matrix()[0].T
    n_bad[7] = -n_bad[7] + 0.5
    w = np.ones(8)
    w[7] = 0.0  # the corrupted row is weighted out
    b_mat = np.einsum("k,ki,kj->ij", w, n_bad, c)[None].astype(np.float32)
    q = thi.solve_wahba(torch.from_numpy(b_mat)).numpy()
    assert _quat_err(q, np.roll(rot.as_quat(), 1, axis=1)).max() < 1e-3


def _both_index_bands(nrm, wts, grid, refl, refl_i, m_valid, **kw):
    """`_index_bands` of both packages on the same f32 inputs, as host arrays."""
    grid_q = jnp.asarray(grid, jnp.float32)
    chunk = kw.pop("grid_chunk")
    want = jhi._index_bands(
        jnp.asarray(nrm, jnp.float32), jnp.asarray(wts, jnp.float32), grid_q,
        jhi._rotate(grid_q, jnp.asarray(refl, jnp.float32)).reshape(-1, chunk, len(refl), 3),
        jnp.asarray(refl, jnp.float32), jnp.asarray(refl_i, jnp.float32), m_valid=m_valid, **kw)
    tgrid = torch.as_tensor(grid, dtype=torch.float32)
    trefl = torch.as_tensor(refl, dtype=torch.float32)
    got = thi._index_bands(
        torch.as_tensor(nrm, dtype=torch.float32), torch.as_tensor(wts, dtype=torch.float32),
        tgrid, tsim.kinematical._quat_rotate(tgrid, trefl), trefl,
        torch.as_tensor(refl_i, dtype=torch.float32), m_valid=m_valid, grid_chunk=chunk, **kw)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


def test_pad_rows_are_masked_as_in_jax():
    """tests/index/test_hough_indexing.py::TestGridPadMasking's crafted
    case: decoys give grid[0] the top raw vote, the truth sits in grid[1]'s
    basin, and two pad copies of grid[0] fill the chunk; with top_p=2 the
    pads must not crowd grid[1] out."""
    refl = np.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1]])
    refl /= np.linalg.norm(refl, axis=-1, keepdims=True)
    q1 = R.from_rotvec(np.radians(30.0) * np.array([1, 1, 1]) / math.sqrt(3))
    q_true = q1 * R.from_rotvec(np.radians(1.0) * np.array([1, 0, 0]))

    def sf(r):
        return np.roll(np.atleast_2d(r.as_quat()), 1, axis=1)

    grid = np.concatenate([sf(R.identity()), sf(q1), sf(R.identity()), sf(R.identity())])
    true_bands = refl @ q_true.as_matrix().T
    axes = np.eye(3)[[2, 0, 1]]
    decoys = np.stack([R.from_rotvec(np.radians(2.5) * ax).apply(n)
                       for n, ax in zip(refl[:3], axes)])
    nrm = np.concatenate([true_bands, decoys])[None]
    wts = np.array([[1.0] * 5 + [2.0] * 3])
    got, want = _both_index_bands(
        nrm, wts, grid, refl, np.ones(5), 2, tol_rad=math.radians(3.0),
        vote_tol_rad=math.radians(6.0), refine_iters=2, top_p=2, i_weight=0.5, grid_chunk=4)
    assert int(got[2][0]) == int(want[2][0]) == 5
    dot = abs(float(np.dot(got[0][0], sf(q_true)[0])))
    assert math.degrees(2.0 * math.acos(min(dot, 1.0))) < 0.5
    assert _mis_deg(got[0], want[0], "432").max() < ORIENT_DEG


@pytest.fixture(scope="module")
def fcc():
    """14 fcc renders at known orientations (the JAX tests' e2e fixture) and
    both indexers over them."""
    geometry = DetectorGeometry(shape=(64, 64), pcx=0.5, pcy=0.5, dd=0.7)
    reflectors = cubic_reflectors("fcc", a=3.52, kv=20.0)
    quats = np.roll(R.random(14, random_state=11).as_quat(), 1, axis=1)
    patterns = simulate_patterns(quats, geometry, reflectors, chunk=16)
    jax_ix = jhi.HoughIndexer(reflectors, geometry, group="432", detector=JaxDetector(**DET),
                              **KW)
    port_ix = thi.HoughIndexer(tsim.cubic_reflectors("fcc", a=3.52, kv=20.0),
                               tsim.DetectorGeometry(shape=(64, 64)), group="432",
                               detector=BandDetector(device="cpu", **DET), **KW)
    return jax_ix, port_ix, patterns, quats


@pytest.mark.parametrize("refine_iters", [0, 2])
def test_index_bands_matches_jax(fcc, refine_iters):
    """Votes and candidates (no refinement round), then refined orientations."""
    jax_ix, port_ix, patterns, _ = fcc
    _, normals, weights = jax_ix.detect_bands(patterns)
    refl = port_ix._refl.numpy()
    got, want = _both_index_bands(
        normals[:8], weights[:8], port_ix._grid_q.numpy(), refl, port_ix._refl_i.numpy(),
        port_ix.m_valid, tol_rad=port_ix.tol_rad, vote_tol_rad=port_ix.vote_tol_rad,
        refine_iters=refine_iters, top_p=16, i_weight=0.5, grid_chunk=256)
    q, fit, nm, vote, rank = got
    assert q.shape == (8, 4) and nm.dtype == np.int64
    np.testing.assert_array_equal(nm, want[2])
    if refine_iters == 0:
        np.testing.assert_array_equal(q, want[0])  # the same grid rows won
        np.testing.assert_allclose(vote, want[3], atol=VOTE_ATOL, rtol=0)
    else:
        assert _mis_deg(q, want[0], "432").max() < ORIENT_DEG
    np.testing.assert_allclose(rank, want[4], atol=RANK_ATOL, rtol=0)
    np.testing.assert_allclose(np.degrees(fit), np.degrees(want[1]), atol=FIT_ATOL_DEG, rtol=0)


def test_indexer_matches_jax_and_its_bounds(fcc):
    jax_ix, port_ix, patterns, truth = fcc
    got, want = port_ix(patterns), jax_ix(patterns)
    assert got.quaternions.shape == (14, 4) and got.eulers_deg.shape == (14, 3)
    assert _mis_deg(got.quaternions, want.quaternions, "432").max() < ORIENT_DEG
    np.testing.assert_array_equal(got.success, want.success)
    np.testing.assert_array_equal(got.n_matched, want.n_matched)
    np.testing.assert_allclose(got.fit_deg, want.fit_deg, atol=FIT_ATOL_DEG, rtol=0)
    np.testing.assert_allclose(got.band_score, want.band_score, atol=RANK_ATOL, rtol=0)
    np.testing.assert_allclose(got.bands.iq, want.bands.iq, atol=1e-5, rtol=0)
    # Fundamental-zone representatives and [0, 360) Euler angles, as JAX's.
    assert (got.quaternions[:, 0] >= 0).all()
    assert ((got.eulers_deg >= 0) & (got.eulers_deg < 360)).all()
    back = np.roll(R.from_euler("zxz", got.eulers_deg, degrees=True).as_quat(), 1, axis=1)
    np.testing.assert_allclose(np.abs((back * got.quaternions).sum(1)), 1.0, atol=1e-9)
    # tests/index/test_hough_indexing.py::test_orientations_recovered
    err = _mis_deg(got.quaternions, truth, "432")
    assert got.success.all() and np.median(err) < 1.5 and err.max() < 4.0
    assert got.fit_deg.max() < 3.0 and (got.n_matched >= 5).all()
    # A padded last batch gives the full run's rows.
    part = port_ix(patterns[:5])
    np.testing.assert_allclose(part.quaternions, got.quaternions[:5], atol=1e-6)
    # Noise: finite, whatever it matches.
    noise = port_ix(np.random.default_rng(0).random((2, 64, 64)).astype(np.float32))
    assert np.isfinite(noise.quaternions).all() and np.isfinite(noise.fit_deg).all()


def test_multiphase_matches_jax():
    """fcc (Ni) and hcp (Ti) renders on one detector (the JAX tests'
    two_phase fixture): every pattern lands in its true phase on both
    sides, and the orientations agree through the winner's symmetry."""
    geometry = DetectorGeometry(shape=(64, 64), pcx=0.5, pcy=0.5, dd=0.7)
    phases = {
        "jax": [(cubic_reflectors("fcc", a=3.52, kv=20.0), "432"),
                (hexagonal_reflectors(a=2.95, c=4.68, kv=20.0, max_hkl=3, min_d=1.0), "622")],
        "port": [(tsim.cubic_reflectors("fcc", a=3.52, kv=20.0), "432"),
                 (tsim.hexagonal_reflectors(a=2.95, c=4.68, kv=20.0, max_hkl=3, min_d=1.0),
                  "622")],
    }
    q_fcc = np.roll(R.random(8, random_state=5).as_quat(), 1, axis=1)
    q_hcp = np.roll(R.random(8, random_state=6).as_quat(), 1, axis=1)
    patterns = np.concatenate([simulate_patterns(q_fcc, geometry, phases["jax"][0][0], chunk=16),
                               simulate_patterns(q_hcp, geometry, phases["jax"][1][0], chunk=16)])
    truth_phase, q_true = np.array([0] * 8 + [1] * 8), np.concatenate([q_fcc, q_hcp])
    want = jhi.MultiPhaseHoughIndexer(phases["jax"], geometry, detector=JaxDetector(**DET),
                                      **KW)(patterns)
    port = thi.MultiPhaseHoughIndexer(phases["port"], tsim.DetectorGeometry(shape=(64, 64)),
                                      detector=BandDetector(device="cpu", **DET), **KW)
    assert port.groups == ["432", "622"]
    assert port.indexers[0].detector is port.indexers[1].detector
    got = port(patterns)
    np.testing.assert_array_equal(got.phase, truth_phase)
    np.testing.assert_array_equal(got.phase, want.phase)
    np.testing.assert_array_equal(got.success, want.success)
    np.testing.assert_array_equal(got.n_matched, want.n_matched)
    assert len(got.per_phase) == 2
    for pid, group in ((0, "432"), (1, "622")):
        m = truth_phase == pid
        assert _mis_deg(got.quaternions[m], want.quaternions[m], group).max() < ORIENT_DEG
        err = _mis_deg(got.quaternions[m], q_true[m], group)
        assert np.median(err) < 1.5 and err.max() < 4.0
        np.testing.assert_array_equal(got.quaternions[m], got.per_phase[pid].quaternions[m])
    with pytest.raises(ValueError, match="at least one"):
        thi.MultiPhaseHoughIndexer([], tsim.DetectorGeometry(shape=(64, 64)))


def test_validation_and_mesh_refused():
    refl = tsim.cubic_reflectors("fcc")
    det = BandDetector(device="cpu", **DET)
    geom = tsim.DetectorGeometry(shape=(64, 64))
    with pytest.raises(ValueError, match="min_intensity"):
        thi.HoughIndexer(refl, geom, min_intensity=10.0, detector=det)
    with pytest.raises(ValueError, match="shape"):
        thi.HoughIndexer(refl, tsim.DetectorGeometry(), detector=det)
    with pytest.raises(ValueError, match="bands"):
        thi.HoughIndexer(refl, geom, n_bands=12, detector=det)
    # mesh= takes a parallel.Mesh (tests/test_torch_parallel_paths.py runs it).
    with pytest.raises(TypeError, match="Mesh"):
        thi.HoughIndexer(refl, geom, detector=det, mesh=object())
