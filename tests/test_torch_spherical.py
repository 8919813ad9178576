"""The port's spherical-harmonic indexer (`latice_tpu_torch.index.spherical`)
against latice_tpu.index.spherical on the same seeded renders, on the CPU
(float32 tables and true float32 products on both sides), at L=16 over
64x64 patterns from a 257 master, chunks of 8 (12 patterns: the tail is
padded), and L=24 for the two-phase case, as tests/index/test_spherical.py.

* `master_sph_coefficients` and `projection_tables`: host float64, within
  float64 roundoff.
* `_correlation_volume`: the volume and the float32 W rows within
  `VOLUME_ATOL` (measured 7e-8 on peaks ~0.2: products in another order).
* `index_patterns` in the grid and parabolic modes: orientations within
  `ORIENT_DEG` of JAX's (misorientation of the fundamental-zone
  quaternions: a grid cell tied with its symmetric image may be the other
  one) and scores within `SCORE_ATOL`. Under Newton within `NEWTON_DEG`
  (measured 2.7e-3 degrees): 8 float32 steps on a flat maximum, where
  gradients summed in another order and the best-seen choice between two
  near-equal iterates move the point by ~1e-5 rad. Newton never scores
  below the grid.
* `ambiguity`: JAX's γ-first ranking reproduced: the same rivals, gaps
  within `SCORE_ATOL`, angles within `ORIENT_DEG`; the top cells carry
  JAX's scores rank by rank, one cell per (β, α), though exactly tied
  symmetric images may be listed in another order.
* `MultiPhaseSphericalIndexer`: JAX's phases and per-phase scores.
* Everything runs on ``cuda`` unless given ``device="cpu"``; ``mesh=``
  takes a `parallel.Mesh` (tests/test_torch_parallel_paths.py runs it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.crystal import ROTATION_GROUPS
from latice_tpu.index import spherical as js
from latice_tpu.sim import DetectorGeometry as JGeom
from latice_tpu.sim import hexagonal_reflectors as j_hex
from latice_tpu.sim import make_kinematical_master, render_from_master
from latice_tpu_torch.index import spherical as ts
from latice_tpu_torch.sim import DetectorGeometry

VOLUME_ATOL = 1e-6
SCORE_ATOL = 1e-6
ORIENT_DEG = 1e-3
NEWTON_DEG = 1e-2
L, CHUNK, N = 16, 8, 12


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _mis_deg(a, b, group="432"):
    """Least misorientation over the group's images, degrees."""
    sym = R.from_quat(np.roll(ROTATION_GROUPS[group], -1, axis=1))
    ra, rb = (R.from_quat(np.roll(np.asarray(q, np.float64), -1, axis=1)) for q in (a, b))
    return np.array([np.degrees(min(((x * s).inv() * y).magnitude() for s in sym))
                     for x, y in zip(ra, rb)])


@pytest.fixture(scope="module")
def setup():
    master = make_kinematical_master(size=257)
    q = np.roll(R.random(N, random_state=0).as_quat(), 1, axis=1)
    patterns = render_from_master(master, q, JGeom(shape=(64, 64)))
    tgeom = DetectorGeometry(shape=(64, 64))
    jcfg = js.SphericalIndexerConfig(bandwidth=L, chunk=CHUNK)
    tcfg = ts.SphericalIndexerConfig(bandwidth=L, chunk=CHUNK)
    jtab = js.projection_tables(L, JGeom(shape=(64, 64)), 2)
    ttab = ts.projection_tables(L, tgeom, 2)
    jax_ix, port_ix = {}, {}
    for mode in ("newton", "parabolic", False):
        jax_ix[mode] = js.SphericalIndexer(master, JGeom(shape=(64, 64)),
                                           dataclasses.replace(jcfg, refine=mode), tables=jtab)
        port_ix[mode] = ts.SphericalIndexer(master, tgeom, dataclasses.replace(tcfg, refine=mode),
                                            tables=ttab, device="cpu")
    return dict(master=master, q=q, patterns=patterns, tgeom=tgeom, tcfg=tcfg, jtab=jtab,
                ttab=ttab, jax=jax_ix, port=port_ix)


def test_master_coefficients_match_jax(setup):
    got = ts.master_sph_coefficients(setup["master"], L)
    np.testing.assert_allclose(got, js.master_sph_coefficients(setup["master"], L),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.sqrt(np.sum(np.abs(got) ** 2)), 1.0, rtol=1e-12)
    with pytest.raises(ValueError, match="harmonic content"):
        ts.master_sph_coefficients(np.ones((65, 65), np.float32), 8)


def test_projection_tables_match_jax(setup):
    got, want = setup["ttab"], setup["jtab"]
    assert got.keys() == want.keys() and got["bin_shape"] == want["bin_shape"] == (32, 32)
    for key in ("omega", "yr", "yi", "betas", "d"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-13)


def test_kept_degrees_match_jax(setup):
    got, want = setup["port"]["newton"]._l_keep, setup["jax"]["newton"]._l_keep
    np.testing.assert_array_equal(got, want)
    assert np.all(got % 2 == 0) and 0 not in got


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_correlation_volume_matches_jax(setup, dtype):
    x = setup["patterns"][:CHUNK]
    if dtype == "uint8":
        x = np.round(x * 255).astype(np.uint8)
    want, wr, wi = js._correlation_volume(jnp.asarray(x), bin_factor=2,
                                          **setup["jax"]["newton"]._dev)
    port = setup["port"]["newton"]
    got, w = ts._correlation_volume(torch.from_numpy(x), port._dev, 2, True, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VOLUME_ATOL, rtol=0)
    k_n = port._dev["k_n"]
    rows = w.view(2, L, CHUNK, k_n, -1).permute(0, 2, 3, 1, 4).numpy()  # (2, b, k, m, ν)
    np.testing.assert_allclose(rows[0], np.asarray(wr), atol=VOLUME_ATOL, rtol=0)
    np.testing.assert_allclose(rows[1], np.asarray(wi), atol=VOLUME_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["newton", "parabolic", False], ids=["newton", "parabolic",
                                                                        "grid"])
def test_index_patterns_matches_jax(setup, mode):
    got = setup["port"][mode].index_patterns(setup["patterns"])
    want = setup["jax"][mode].index_patterns(setup["patterns"])
    assert len(got) == N and got.eulers_deg.shape == (N, 3)
    assert got.quaternions.dtype == np.float32 and got.scores.dtype == np.float32
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_ATOL, rtol=0)
    tol = NEWTON_DEG if mode == "newton" else ORIENT_DEG
    assert _mis_deg(got.quaternions, want.quaternions).max() < tol
    # tests/index/test_spherical.py's accuracy at L=32 over 128x128 does
    # not hold at this size; each pattern lies within a grid cell (11.25°).
    assert _mis_deg(got.quaternions, setup["q"]).max() < 180.0 / L * 2


def test_newton_never_below_grid_score(setup):
    newton = setup["port"]["newton"].index_patterns(setup["patterns"][:6]).scores
    grid = setup["port"][False].index_patterns(setup["patterns"][:6]).scores
    assert np.all(newton >= grid - 1e-6), (newton, grid)


def test_newton_derivatives_match_autograd():
    """The written-out gradient and Hessian of the trig series equal
    autograd's of its value (float64)."""
    gen = torch.Generator().manual_seed(0)
    w5 = torch.randn((3, 5, 2 * 6 * 11), generator=gen, dtype=torch.float64)
    consts = ts._series_consts(6, "cpu", torch.float64)
    p = torch.tensor([[0.3, 0.7, -1.1], [-1.2, 2.0, 0.4], [1.9, -0.5, 3.0]], dtype=torch.float64)
    _, grad, hess = ts._series(p, w5, consts)

    def value(row, i):
        return ts._series(row[None], w5[i:i + 1], consts)[0][0]

    for i in range(3):
        g = torch.autograd.functional.jacobian(lambda r: value(r, i), p[i])
        h = torch.autograd.functional.hessian(lambda r: value(r, i), p[i])
        torch.testing.assert_close(grad[i], g, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(hess[i], h, rtol=1e-10, atol=1e-10)


def test_uint8_and_single_pattern(setup):
    """uint8 is divided by 255 on the device: JAX's result on the same
    values in float32; one 2-D pattern is a batch of one (padded)."""
    ix = setup["port"][False]
    u8 = np.round(setup["patterns"][:4] * 255).astype(np.uint8)
    got = ix.index_patterns(u8)
    want = setup["jax"][False].index_patterns(u8.astype(np.float32) / 255.0)
    assert _mis_deg(got.quaternions, want.quaternions).max() < ORIENT_DEG
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_ATOL, rtol=0)
    one = ix.index_patterns(setup["patterns"][3])
    full = ix.index_patterns(setup["patterns"])
    assert len(one) == 1
    assert _mis_deg(one.quaternions, full.quaternions[3:4]).max() < ORIENT_DEG


def test_ambiguity_matches_jax(setup):
    got = setup["port"]["newton"].ambiguity(setup["patterns"])
    want = setup["jax"]["newton"].ambiguity(setup["patterns"])
    np.testing.assert_array_equal(got.has_rival, want.has_rival)
    assert got.has_rival.any()
    np.testing.assert_allclose(got.score_gap, want.score_gap, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got.angle_deg, want.angle_deg, atol=ORIENT_DEG, rtol=0)
    with pytest.raises(ValueError, match="n_cells"):
        setup["port"]["newton"].ambiguity(setup["patterns"], n_cells=1)


def test_top_cells_rank_as_lax_top_k(setup):
    """`_top_cells_chunk`'s γ-first ranking: JAX's scores rank by rank, each
    cell's own score in JAX's volume, and one cell per (β, α)."""
    x = setup["patterns"][:CHUNK]
    jdev = setup["jax"]["newton"]._dev
    want = js._top_cells_chunk(jnp.asarray(x), bin_factor=2, n_cells=32, **jdev)
    vol = np.asarray(js._correlation_volume(jnp.asarray(x), bin_factor=2, **jdev)[0])
    vals, k, a, g = (t.numpy() for t in ts._top_cells_chunk(
        torch.from_numpy(x), setup["port"]["newton"]._dev, 2, 32))
    np.testing.assert_allclose(vals, np.asarray(want[0]), atol=SCORE_ATOL, rtol=0)
    rows = np.arange(CHUNK)[:, None]
    np.testing.assert_allclose(vol[rows, k, a, g], vals, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(vol.max(axis=3)[rows, k, a], vals, atol=SCORE_ATOL, rtol=0)
    a_n = vol.shape[2]
    assert all(len(set(row)) == 32 for row in k * a_n + a)


def test_multiphase_matches_jax():
    m_fcc = make_kinematical_master(size=257)
    m_hcp = make_kinematical_master(size=257, reflectors=j_hex())
    jg = JGeom(shape=(64, 64))
    q_f = np.roll(R.random(4, random_state=1).as_quat(), 1, axis=1)
    q_h = np.roll(R.random(4, random_state=2).as_quat(), 1, axis=1)
    pats = np.concatenate([render_from_master(m_fcc, q_f, jg), render_from_master(m_hcp, q_h, jg)])
    want = js.MultiPhaseSphericalIndexer([m_fcc, m_hcp], jg,
                                         js.SphericalIndexerConfig(bandwidth=24, chunk=4),
                                         symmetries=["432", "622"]).index_patterns(pats)
    got = ts.MultiPhaseSphericalIndexer([m_fcc, m_hcp], DetectorGeometry(shape=(64, 64)),
                                        ts.SphericalIndexerConfig(bandwidth=24, chunk=4),
                                        symmetries=["432", "622"],
                                        device="cpu").index_patterns(pats)
    np.testing.assert_array_equal(got.phase, want.phase)
    np.testing.assert_array_equal(got.phase, [0] * 4 + [1] * 4)
    np.testing.assert_allclose(got.phase_scores, want.phase_scores, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got.scores, got.phase_scores.max(axis=1), rtol=1e-6)
    assert _mis_deg(got.quaternions[:4], want.quaternions[:4], "432").max() < NEWTON_DEG
    assert _mis_deg(got.quaternions[4:], want.quaternions[4:], "622").max() < NEWTON_DEG


def test_multiphase_single_phase_and_shared_tables(setup):
    """One master is the single-phase indexer; given tables are used as
    they are, and tables of another configuration are refused."""
    ix = setup["port"]["newton"]
    multi = ts.MultiPhaseSphericalIndexer([setup["master"]], setup["tgeom"], setup["tcfg"],
                                          tables=setup["ttab"], device="cpu")
    a = ix.index_patterns(setup["patterns"][:4])
    b = multi.index_patterns(setup["patterns"][:4])
    np.testing.assert_array_equal(a.quaternions, b.quaternions)
    np.testing.assert_array_equal(b.phase, 0)
    with pytest.raises(ValueError, match="at least one"):
        ts.MultiPhaseSphericalIndexer([], setup["tgeom"], setup["tcfg"], device="cpu")
    with pytest.raises(ValueError, match="symmetries"):
        ts.MultiPhaseSphericalIndexer([setup["master"]] * 2, setup["tgeom"], setup["tcfg"],
                                      symmetries=["432"] * 3, device="cpu")
    wrong = ts.projection_tables(8, setup["tgeom"], 2)
    with pytest.raises(ValueError, match="do not match"):
        ts.SphericalIndexer(setup["master"], setup["tgeom"], setup["tcfg"], tables=wrong,
                            device="cpu")


def test_validation_and_refusals(setup):
    ix = setup["port"]["newton"]
    with pytest.raises(ValueError, match="expected"):
        ix.index_patterns(setup["patterns"][:, :32, :32])
    with pytest.raises(ValueError, match="does not divide"):
        ts.SphericalIndexer(setup["master"], DetectorGeometry(shape=(62, 62)),
                            ts.SphericalIndexerConfig(bandwidth=8, detector_bin=4), device="cpu")
    with pytest.raises(ValueError, match="bandwidth"):
        ts.SphericalIndexerConfig(bandwidth=2)
    with pytest.raises(ValueError, match="point group"):
        ts.SphericalIndexerConfig(symmetry="999")
    with pytest.raises(ValueError, match="refine"):
        ts.SphericalIndexerConfig(refine="cubic")
    with pytest.raises(TypeError, match="Mesh"):
        ts.SphericalIndexer(setup["master"], setup["tgeom"], setup["tcfg"], mesh=object(),
                            tables=setup["ttab"], device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ts.MultiPhaseSphericalIndexer([setup["master"]], setup["tgeom"], setup["tcfg"],
                                      mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.SphericalIndexer(setup["master"], setup["tgeom"], setup["tcfg"],
                                tables=setup["ttab"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.MultiPhaseSphericalIndexer([setup["master"]], setup["tgeom"], setup["tcfg"],
                                          tables=setup["ttab"])
