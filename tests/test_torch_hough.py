"""The port's Radon band detector against latice_tpu.data.hough, on the CPU.

* `radon_matrix` and `butterfly_kernel` are host numpy copied from the JAX
  package: held bitwise.
* `BandDetector` on the same frames (64x64 and 32x32 renders and synthetic
  bands, float32 and uint8, padded batches): theta equal and rho within
  1e-5 px (one f32 ulp of the pixel scale: XLA fuses the multiply-add) at
  every slot whose strength is more than `TIE` away from its neighbours'
  (near-tied peaks may swap order); strengths within `STRENGTH_ATOL`, IQ
  within `IQ_ATOL` and band counts equal. The sinogram's products are
  exact on both sides (bf16 operands, f32 accumulation), so what differs is
  the order of f32 sums: measured at 1e-6 on the renders.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.data import hough as jhough
from latice_tpu.sim import DetectorGeometry, cubic_reflectors, simulate_patterns
from latice_tpu_torch.data import hough as though

STRENGTH_ATOL = 1e-5
IQ_ATOL = 1e-5
RHO_ATOL = 1e-5
TIE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _bands(bands, h, w, width=6.0, noise=0.0, seed=0):
    """Gaussian-profile bright bands at (theta_deg, rho_px), as
    tests/data/test_hough.py draws them."""
    rng = np.random.default_rng(seed)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows, cols = np.mgrid[0:h, 0:w]
    x, y = cols - cx, cy - rows
    img = np.zeros((h, w))
    for theta_deg, rho in bands:
        th = np.radians(theta_deg)
        d = x * np.cos(th) + y * np.sin(th) - rho
        img += np.exp(-(d**2) / (2.0 * (width / 2.0) ** 2))
    img += rng.normal(scale=noise, size=img.shape)
    return img.astype(np.float32)


def _renders(n, size, seed):
    g = DetectorGeometry(shape=(size, size))
    q = np.roll(R.random(n, random_state=seed).as_quat(), 1, axis=1)
    return simulate_patterns(q, g, cubic_reflectors("fcc", a=3.52, kv=20.0), chunk=16)


def _assert_same(got, want):
    assert got.theta_deg.shape == want.theta_deg.shape
    for name in ("theta_deg", "rho_px", "strength", "iq"):
        assert getattr(got, name).dtype == np.float64, name
    assert got.band_count.dtype == np.int64
    s = want.strength
    gaps = np.abs(np.diff(s, axis=1))
    tied = np.zeros(s.shape, bool)
    tied[:, 1:] |= gaps < TIE
    tied[:, :-1] |= gaps < TIE
    np.testing.assert_array_equal(got.theta_deg[~tied], want.theta_deg[~tied])
    np.testing.assert_allclose(got.rho_px[~tied], want.rho_px[~tied], atol=RHO_ATOL, rtol=0)
    np.testing.assert_allclose(got.strength, want.strength, atol=STRENGTH_ATOL, rtol=0)
    np.testing.assert_allclose(got.iq, want.iq, atol=IQ_ATOL, rtol=0)
    np.testing.assert_array_equal(got.band_count, want.band_count)


@pytest.mark.parametrize("shape", [(32, 32, 45, 48), (48, 64, 90, 64), (64, 64, 90, 96)])
def test_radon_matrix_bitwise(shape):
    a, mask = though.radon_matrix(*shape)
    ja, jmask = jhough.radon_matrix(*shape)
    assert a.dtype == ja.dtype == np.float32 and a.shape == ja.shape
    assert a.tobytes() == ja.tobytes()
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("width", [1, 2, 5, 6, 9])
def test_butterfly_kernel_bitwise(width):
    k, jk = though.butterfly_kernel(width), jhough.butterfly_kernel(width)
    assert k.tobytes() == jk.tobytes()
    with pytest.raises(ValueError, match="width"):
        though.butterfly_kernel(0)


def test_butterfly_is_the_jax_convolution():
    """The banded product equals the zero-padded cross-correlation."""
    kern = though.butterfly_kernel(5)
    s = np.random.default_rng(0).normal(size=(3, 20)).astype(np.float64)
    want = np.stack([np.correlate(np.pad(r, len(kern) // 2), kern, mode="valid") for r in s])
    np.testing.assert_allclose(s @ though._banded(kern, 20), want, atol=1e-6)


DETECTORS = {
    "render64": dict(height=64, width=64, n_theta=90, n_rho=64, k=8, band_width_px=5.0,
                     batch_size=4),
    "render32": dict(height=32, width=32, n_theta=45, n_rho=32, k=6, band_width_px=4.0,
                     batch_size=16),
    "bands64": dict(height=64, width=64, n_theta=90, n_rho=64, k=6, band_width_px=6.0,
                    batch_size=4),
}


def _frames(case):
    if case == "render64":
        return _renders(7, 64, 11)  # 7 over batches of 4: a padded tail
    if case == "render32":
        return _renders(5, 32, 3)
    # Bands at the theta wrap, three bands in noise, one band, and a flat
    # frame (every cell a plateau peak: the top-k's tie order decides).
    return np.stack([
        _bands([(1.0, 12.0)], 64, 64),
        _bands([(179.0, 12.0)], 64, 64),
        _bands([(20.0, -15.0), (75.0, 5.0), (130.0, 22.0)], 64, 64, noise=0.02),
        _bands([(40.0, 10.0)], 64, 64),
        np.zeros((64, 64), np.float32),
    ])


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("case", sorted(DETECTORS))
def test_detector_matches_jax(case, dtype):
    x = _frames(case)
    if dtype == "uint8":
        lo, hi = x.min(), x.max()
        x = np.round((x - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    kw = DETECTORS[case]
    got = though.BandDetector(device="cpu", **kw)(x)
    want = jhough.BandDetector(**kw)(x)
    _assert_same(got, want)
    if case == "bands64":
        # The wrapped bands: (theta, rho) and (theta +- 180, -rho) name one line.
        for i, theta in ((0, 1.0), (1, 179.0)):
            t, r = got.theta_deg[i, 0], got.rho_px[i, 0]
            assert any(abs(t - (theta + dt)) <= 2.0 and abs(r - sr * 12.0) <= 2.0
                       for dt, sr in ((0.0, 1.0), (180.0, -1.0), (-180.0, -1.0)))


def test_fewer_peaks_than_k_and_channel_axis():
    """k past the number of local maxima: the top-k takes -inf slots, which
    come out as strength 0 at the positions JAX's top-k picks; a trailing
    channel axis is dropped."""
    kw = dict(height=32, width=32, n_theta=16, n_rho=16, k=60, band_width_px=4.0, batch_size=2)
    x = np.stack([_bands([(30.0, 4.0)], 32, 32, width=4.0), _bands([(100.0, -3.0)], 32, 32)])
    got = though.BandDetector(device="cpu", **kw)(x[..., None])
    want = jhough.BandDetector(**kw)(x[..., None])
    assert (want.strength == 0).any(axis=1).all()
    _assert_same(got, want)


def test_shape_validation():
    det = though.BandDetector(height=32, width=32, n_theta=16, n_rho=16, k=4, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        det(np.zeros((2, 16, 16), np.float32))
