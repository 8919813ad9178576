"""The port's NLPAR denoising against latice_tpu's on the same seeded numpy
scans, on the CPU: `nlpar_denoise` and `estimate_noise_sigma` within a
relative 1e-5 of the JAX outputs (the largest difference over the largest
|value|) at r = 1 and 2, with slabs shorter than the scan and a short
tail, a 1x1 scan, hot-pixel repair, uint8 input, and the same validation
errors."""

import numpy as np
import pytest
import torch

from latice_tpu.data import nlpar as jnl
from latice_tpu_torch.data import nlpar as tnl

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _scan(rows=5, cols=6, hw=12, noise=0.08, seed=0, boundary_col=3):
    """Two grains (shared base patterns) split at ``boundary_col``, plus
    Gaussian noise: both the averaging and the boundary cut-off act."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(0.2, 0.8, size=(2, hw, hw)).astype(np.float32)
    truth = np.empty((rows, cols, hw, hw), np.float32)
    truth[:, :boundary_col], truth[:, boundary_col:] = a, b
    return truth + rng.normal(size=truth.shape).astype(np.float32) * noise


def _close(got, want, rtol=RTOL):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


@pytest.mark.parametrize(
    "radius, h, chunk_rows",
    [(1, 1.0, None), (1, 2.5, 2), (2, 2.0, None), (2, 1.5, 3)],
    ids=["r1", "r1-slabs2", "r2", "r2-slabs3"],
)
def test_denoise_matches_jax(radius, h, chunk_rows):
    """chunk_rows 2 and 3 over 5 rows leave a 1- and a 2-row tail slab."""
    x = _scan()
    got = tnl.nlpar_denoise(x, search_radius=radius, h=h, chunk_rows=chunk_rows, device="cpu")
    _close(got, jnl.nlpar_denoise(x, search_radius=radius, h=h, chunk_rows=chunk_rows))
    # The slabs do not change the result.
    _close(got, tnl.nlpar_denoise(x, search_radius=radius, h=h, device="cpu"))


def test_noise_sigma_matches_jax():
    x = _scan(rows=4, cols=7, seed=1)
    got = tnl.estimate_noise_sigma(x, device="cpu")
    _close(got, jnl.estimate_noise_sigma(x))
    assert got.shape == (4, 7)


def test_single_point_scan_keeps_its_pattern():
    """A 1x1 scan has no neighbour: sigma² is 0 and the pattern stays."""
    x = _scan(rows=1, cols=1, seed=2, boundary_col=1)
    got = tnl.nlpar_denoise(x, device="cpu")
    _close(got, jnl.nlpar_denoise(x))
    np.testing.assert_array_equal(got, x)
    assert tnl.estimate_noise_sigma(x, device="cpu").tolist() == [[0.0]]


def test_hot_pixels_repaired_before_averaging():
    x = _scan(seed=3)
    rng = np.random.default_rng(4)
    flat = x.reshape(-1, x.shape[-1] * x.shape[-2])
    for row in flat:
        row[rng.integers(0, row.size, 3)] = 4.0
    got = tnl.nlpar_denoise(x, h=2.0, chunk_rows=2, hot_pixel_threshold=5.0, device="cpu")
    want = jnl.nlpar_denoise(x, h=2.0, chunk_rows=2, hot_pixel_threshold=5.0)
    _close(got, want)
    assert got.max() < 2.0  # the spikes did not reach the average


def test_uint8_scan():
    """Integers are computed as float32 and not rescaled, on both sides."""
    x = np.clip(np.round(_scan(seed=5) * 255.0), 0, 255).astype(np.uint8)
    got = tnl.nlpar_denoise(x, h=1.5, device="cpu")
    _close(got, jnl.nlpar_denoise(x, h=1.5))
    assert got.max() > 1.0


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(patterns=np.zeros((4, 8, 8), np.float32)), "R, C, H, W"),
        (dict(search_radius=0), "search_radius"),
        (dict(h=0.0), "h must be positive"),
    ],
    ids=["3d", "radius0", "h0"],
)
def test_validation_errors(kw, match):
    kw = dict(dict(patterns=_scan(rows=2, cols=2)), **kw)
    for fn, extra in ((tnl.nlpar_denoise, dict(device="cpu")), (jnl.nlpar_denoise, {})):
        with pytest.raises(ValueError, match=match):
            fn(**kw, **extra)
    with pytest.raises(ValueError, match="R, C, H, W"):
        tnl.estimate_noise_sigma(np.zeros((4, 8, 8)), device="cpu")
