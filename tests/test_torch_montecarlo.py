"""The port's Monte-Carlo backscatter simulation
(`latice_tpu_torch.sim.montecarlo`) against the JAX package's, on the CPU.

The walkers draw from a ``torch.Generator``, not ``jax.random``, so the
port is held by statistics: the JAX suite's literature anchors
(tests/sim/test_montecarlo.py at its ``FAST`` settings, 20,000 walkers),
and the JAX package's own yield at the same settings within `SIGMAS`
standard errors of the difference of two binomial estimates (measured at
tilt 70: 0.5574 against JAX's 0.5545, 0.6 of one). What needs no draws is
held exactly:
`effective_medium` bitwise, and `mc_weighted_master_pattern` fed the JAX
package's `MonteCarloBSE` against JAX's own within `MASTER_ATOL` of the
normalized image (measured: 9.7e-6 at 21 px).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import latice_tpu.sim as jsim
import latice_tpu.sim.montecarlo as jmc
import latice_tpu_torch.sim as psim
import latice_tpu_torch.sim.montecarlo as pmc
from latice_tpu_torch.sim.montecarlo import fold_energy_bins

FAST = dict(n_electrons=20_000, n_steps=250, chunk=20_000)
SIGMAS = 4.0
MASTER_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _ni(sim=psim):
    return sim.cubic_structure("fcc", "ni", 3.52)


@pytest.fixture(scope="module")
def runs():
    """The port's runs at FAST, each once per module."""
    mc = lambda **kw: psim.simulate_bse_monte_carlo(device="cpu", **FAST, **kw)  # noqa: E731
    return {
        "ni0": mc(structure=_ni(), kv=20.0, tilt_deg=0.0),
        "ni70": mc(structure=_ni(), kv=20.0, tilt_deg=70.0, energy_bins=6, depth_bins=24),
        "al": mc(kv=20.0, tilt_deg=0.0, z=13, a=26.982, density_g_cm3=2.70),
        "au": mc(kv=20.0, tilt_deg=0.0, z=79, a=196.967, density_g_cm3=19.3),
    }


@pytest.mark.parametrize("structure", [
    lambda m: m.cubic_structure("fcc", "ni", 3.52),
    lambda m: m.zincblende_structure(),
    lambda m: m.CrystalStructure(3.0, 3.0, 3.0, sites=(m.AtomSite(26, (0, 0, 0)),)),
    lambda m: m.wurtzite_structure(),
])
def test_effective_medium_bitwise(structure):
    assert psim.effective_medium(structure(psim)) == jsim.effective_medium(structure(jsim))
    assert pmc.ELEMENT_A == jmc.ELEMENT_A


def test_nickel_normal_incidence(runs):
    assert 0.20 < runs["ni0"].bse_yield < 0.38, runs["ni0"].bse_yield


def test_tilt_raises_yield(runs):
    assert runs["ni70"].bse_yield > runs["ni0"].bse_yield + 0.15
    assert 0.45 < runs["ni70"].bse_yield < 0.75, runs["ni70"].bse_yield


def test_yield_increases_with_z(runs):
    assert runs["au"].bse_yield > runs["al"].bse_yield + 0.15


def test_depth_scale_sane(runs):
    p50, p99 = np.percentile(runs["ni70"].max_depth_nm, [50, 99])
    assert 5.0 < p50 < 150.0, p50
    assert p99 < 1000.0, p99


def test_yield_matches_jax_statistically(runs):
    want = jsim.simulate_bse_monte_carlo(_ni(jsim), kv=20.0, tilt_deg=70.0, energy_bins=6,
                                         depth_bins=24, **FAST).bse_yield
    got = runs["ni70"].bse_yield
    n = FAST["n_electrons"]
    sd = np.sqrt(got * (1 - got) / n + want * (1 - want) / n)
    assert abs(got - want) <= SIGMAS * sd, (got, want, sd)


def test_invariants(runs):
    mc = runs["ni70"]
    np.testing.assert_allclose(mc.energy_weights.sum(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(mc.depth_weights.sum(axis=1), np.ones(6), rtol=1e-12)
    assert mc.energy_weights.shape == (6,) and mc.depth_weights.shape == (6, 24)
    assert np.all(np.diff(mc.depth_centers_nm) > 0)
    assert np.all(mc.exit_energy_kev >= 2.0 - 1e-6)  # e_min = kv/10
    assert np.all(mc.exit_energy_kev <= 20.0 + 1e-6)
    assert mc.exit_energy_kev.dtype == np.float32
    assert mc.energy_centers_kev.shape == (6,)
    assert mc.energy_weights[-1] > mc.energy_weights[0]


def test_deterministic_for_a_seed():
    kw = dict(kv=20.0, n_electrons=4096, n_steps=60, chunk=1024, device="cpu")
    a = psim.simulate_bse_monte_carlo(_ni(), seed=3, **kw)
    b = psim.simulate_bse_monte_carlo(_ni(), seed=3, **kw)
    c = psim.simulate_bse_monte_carlo(_ni(), seed=4, **kw)
    np.testing.assert_array_equal(a.exit_energy_kev, b.exit_energy_kev)
    np.testing.assert_array_equal(a.max_depth_nm, b.max_depth_nm)
    assert not np.array_equal(a.max_depth_nm, c.max_depth_nm)


def test_validation():
    with pytest.raises(ValueError, match="z/a/density"):
        psim.simulate_bse_monte_carlo(kv=20.0, z=28, device="cpu", **FAST)
    with pytest.raises(ValueError, match="tilt_deg"):
        psim.simulate_bse_monte_carlo(_ni(), tilt_deg=95.0, device="cpu", **FAST)
    with pytest.raises(ValueError, match="backscattered"):
        psim.simulate_bse_monte_carlo(_ni(), kv=20.0, e_min_kev=19.999, n_electrons=512,
                                      n_steps=4, chunk=512, device="cpu")
    # mesh= takes a parallel.Mesh (tests/test_torch_parallel_paths.py runs it).
    with pytest.raises(TypeError, match="Mesh"):
        psim.simulate_bse_monte_carlo(_ni(), mesh=object(), device="cpu", **FAST)
    with pytest.raises(ValueError, match="unknown element"):
        psim.effective_medium(psim.CrystalStructure(
            3.0, 3.0, 3.0, sites=(psim.AtomSite("xx", (0, 0, 0)),)))


@pytest.mark.parametrize("name,n_beams", [("fcc", 16), ("zincblende", 14)])
def test_quadrature_matches_exponential_closed_form(name, n_beams):
    structure = _ni() if name == "fcc" else psim.zincblende_structure()
    beams = psim.dynamical_beams(structure, kv=20.0, n_beams=n_beams, max_hkl=2)
    z0 = 50.0 if name == "fcc" else 40.0
    zc = (np.arange(4000) + 0.5) * (20.0 * z0 / 4000)
    zw = np.exp(-zc / z0)
    d = np.random.default_rng(0).normal(size=(32, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    ref = psim.channeling_intensities(d, beams, depth_nm=z0, chunk=32, device="cpu")
    quad = psim.channeling_intensities(d, beams, chunk=32, depth_centers_nm=zc,
                                       depth_weights=zw, device="cpu")
    assert np.abs(quad - ref).max() / np.abs(ref).max() < 2e-3


@pytest.fixture(scope="module")
def jax_mc():
    return jsim.simulate_bse_monte_carlo(_ni(jsim), kv=20.0, tilt_deg=70.0, energy_bins=5,
                                         n_electrons=8192, n_steps=250, chunk=8192)


def _as_port(mc) -> psim.MonteCarloBSE:
    return psim.MonteCarloBSE(**{f: getattr(mc, f) for f in mc.__dataclass_fields__})


@pytest.mark.parametrize("min_bin_weight", [0.02, 0.2])
def test_weighted_master_fed_jax_mc_matches_jax(jax_mc, min_bin_weight):
    kw = dict(size=21, n_beams=16, max_hkl=2, chunk=441, min_bin_weight=min_bin_weight)
    want = jsim.mc_weighted_master_pattern(_ni(jsim), jax_mc, **kw)
    got = psim.mc_weighted_master_pattern(_ni(), _as_port(jax_mc), device="cpu", **kw)
    assert got.shape == (21, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MASTER_ATOL)


def test_bin_folding_keeps_total_weight(jax_mc):
    """``min_bin_weight=1.0`` folds every bin into the heaviest: the master
    is then one solve at that bin's center (tests/sim/test_montecarlo.py)."""
    mc = _as_port(jax_mc)
    kept, weights = fold_energy_bins(mc.energy_weights, 1.0)
    b = int(np.argmax(mc.energy_weights))
    assert kept == [b] and weights[b] == pytest.approx(1.0) and weights.sum() == pytest.approx(1.0)
    img = psim.mc_weighted_master_pattern(_ni(), mc, size=21, n_beams=16, max_hkl=2, chunk=441,
                                          min_bin_weight=1.0, normalize=False, device="cpu")
    beams = psim.dynamical_beams(_ni(), kv=float(mc.energy_centers_kev[b]), n_beams=16,
                                 max_hkl=2)
    half = (21 - 1) / 2.0
    ij = (np.arange(21, dtype=np.float64) - half) / half
    x, y = np.meshgrid(ij, -ij, indexing="xy")
    d = psim.lambert_to_directions(np.stack([x, y], axis=-1) * np.sqrt(2.0))
    expect = psim.channeling_intensities(d, beams, chunk=441, depth_centers_nm=mc.depth_centers_nm,
                                         depth_weights=mc.depth_weights[b], device="cpu")
    np.testing.assert_allclose(img, expect, rtol=1e-5, atol=1e-7)


def test_entry_points_default_to_cuda(jax_mc):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psim.simulate_bse_monte_carlo(_ni(), **FAST)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psim.mc_weighted_master_pattern(_ni(), _as_port(jax_mc), size=5)
