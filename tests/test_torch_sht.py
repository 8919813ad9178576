"""The port's spherical-harmonic tables (`latice_tpu_torch.sim.sht`) against
latice_tpu.sim.sht: host float64 copies, so every table agrees to float64
roundoff (`RTOL`/`ATOL`, well above the few ulps two BLAS paths may differ
by). The port's Wigner disk cache is value-transparent: float64, keyed by
(L, β grid), read from its own environment variable and its own file names,
never from the JAX package's cache files.
"""

import numpy as np
import pytest
import torch

from latice_tpu.sim import sht as jsht
from latice_tpu_torch.sim import sht as tsht

RTOL, ATOL = 1e-12, 1e-13


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("bandwidth", [1, 5, 16])
def test_legendre_table(bandwidth):
    x = np.random.default_rng(bandwidth).uniform(-1, 1, 40)
    np.testing.assert_allclose(tsht.legendre_table(bandwidth, x),
                               jsht.legendre_table(bandwidth, x), rtol=RTOL, atol=ATOL)


def test_legendre_validation():
    for mod in (jsht, tsht):
        with pytest.raises(ValueError, match="bandwidth"):
            mod.legendre_table(0, np.zeros(2))
        with pytest.raises(ValueError, match=r"\[-1, 1\]"):
            mod.legendre_table(4, np.array([1.5]))


@pytest.mark.parametrize("ell, m", [(0, 0), (3, -2), (7, 7)])
def test_dense_index(ell, m):
    assert tsht.dense_index(ell, m, 8) == jsht.dense_index(ell, m, 8)
    with pytest.raises(ValueError, match="outside bandwidth"):
        tsht.dense_index(8, 0, 8)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_sph_matrix_dense(weighted):
    dirs = _unit_dirs(50, 1) * 3.0  # unnormalized on purpose: both normalize
    w = np.random.default_rng(2).uniform(0.1, 1.0, 50) if weighted else None
    for got, want in zip(tsht.sph_matrix_dense(12, dirs, w), jsht.sph_matrix_dense(12, dirs, w)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_lat, n_lon", [(None, None), (9, 20)])
def test_gauss_legendre_ring_grid(n_lat, n_lon):
    got, want = (m.gauss_legendre_ring_grid(8, n_lat, n_lon) for m in (tsht, jsht))
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert abs(got[1].sum() - 4 * np.pi) < 1e-12


def test_sph_coeffs_dense():
    dirs, w = tsht.gauss_legendre_ring_grid(10)
    vals = np.random.default_rng(3).normal(size=len(dirs))
    np.testing.assert_allclose(tsht.sph_coeffs_dense(vals, dirs, w, 10),
                               jsht.sph_coeffs_dense(vals, dirs, w, 10), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bandwidth", [2, 9, 16])
def test_wigner_d_table(bandwidth):
    betas = np.random.default_rng(bandwidth).uniform(0, np.pi, 7)
    got = tsht.wigner_d_table(bandwidth, betas, cache_dir="")
    want = jsht.wigner_d_table(bandwidth, betas, cache_dir="")
    assert got.dtype == np.float64 and got.shape == (7, bandwidth, 2 * bandwidth - 1,
                                                     2 * bandwidth - 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


def test_wigner_cache_is_value_transparent_and_its_own(tmp_path, monkeypatch):
    betas = (np.arange(12) + 0.5) * (np.pi / 12)
    fresh = tsht.wigner_d_table(6, betas, cache_dir="")
    # A JAX-package cache file for the same key holds garbage: never read.
    jsht.wigner_d_table(6, betas, cache_dir=str(tmp_path))
    (jax_file,) = tmp_path.glob("wigner_*")
    np.savez(jax_file, d=np.zeros_like(fresh), betas=betas)
    monkeypatch.setenv("LATICE_TPU_SHT_CACHE", str(tmp_path / "jax_only"))
    monkeypatch.setenv("LATICE_TPU_TORCH_SHT_CACHE", str(tmp_path))
    first = tsht.wigner_d_table(6, betas)
    (port_file,) = tmp_path.glob("port_wigner_*")
    assert port_file.name.startswith("port_wigner_L6_K12_") and port_file.name.endswith("_f64.npz")
    assert not (tmp_path / "jax_only").exists()
    with np.load(port_file) as z:
        assert z["d"].dtype == np.float64
    cached = tsht.wigner_d_table(6, betas)
    np.testing.assert_array_equal(first, fresh)
    np.testing.assert_array_equal(cached, fresh)
    # Another β grid is another key.
    other = tsht.wigner_d_table(6, betas[:-1])
    assert len(list(tmp_path.glob("port_wigner_*"))) == 2 and other.shape[0] == 11
