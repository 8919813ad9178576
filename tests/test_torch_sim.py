"""The port's orientation sampling, detector geometry, reflector tables and
kinematical renderer against latice_tpu's, on the CPU:

* fundamental-zone grids equal for groups 432, 622 and 23, and the
  anglefiles byte-equal;
* reflector tables (fcc, bcc, sc, hcp, `reflectors_from_cell`) equal;
* `pixel_directions` within 1e-7, with and without tilt;
* `simulate_patterns` from quaternions and from Euler degrees: float32
  within 1e-5 absolute (2.7e-6 measured); uint8 differing by at most 1
  level in at most 0.1% of pixels: values half-way between two levels,
  which roundoff puts on either side (measured: at most 2 of 38,016
  pixels, 0.005%, here; 73 of 4.2M, 0.0017%, over 256 patterns at
  128x128);
* the render's products stay full float32 under
  ``torch.set_float32_matmul_precision("high")``, and the caller's setting
  comes back.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.crystal import sampling as jsamp
from latice_tpu.sim import geometry as jgeo
from latice_tpu.sim import kinematical as jkin
from latice_tpu_torch.crystal import sampling as tsamp
from latice_tpu_torch.device import full_f32_matmul
from latice_tpu_torch.sim import geometry as tgeo
from latice_tpu_torch.sim import kinematical as tkin

F32_ATOL = 1e-5
UINT8_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.mark.parametrize("group, resolution", [("432", 8.0), ("622", 12.0), ("23", 15.0)])
def test_fundamental_zone_and_anglefile_match_jax(group, resolution, tmp_path):
    got = tsamp.sample_fundamental_zone(group, resolution)
    want = jsamp.sample_fundamental_zone(group, resolution)
    assert got.shape == want.shape and len(got) > 50
    np.testing.assert_array_equal(got, want)
    eulers = R.from_quat(np.roll(got, -1, axis=1)).as_euler("zxz", degrees=True)
    tsamp.write_anglefile(str(tmp_path / "port.txt"), eulers)
    jsamp.write_anglefile(str(tmp_path / "jax.txt"), eulers)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    np.testing.assert_array_equal(tsamp.euler_grid(30.0), jsamp.euler_grid(30.0))
    with pytest.raises(ValueError, match="unknown point group"):
        tsamp.sample_fundamental_zone("999", resolution)
    with pytest.raises(ValueError, match="max_samples"):
        tsamp.sample_fundamental_zone(group, 0.1, max_samples=10)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.cubic_reflectors("fcc"),
        lambda m: m.cubic_reflectors("bcc", a=2.87, kv=15.0),
        lambda m: m.cubic_reflectors("sc", max_hkl=2, min_d=0.9),
        lambda m: m.hexagonal_reflectors(),
        lambda m: m.reflectors_from_cell(4.0, 5.0, 6.0, 90.0, 100.0, 90.0, kv=25.0),
    ],
    ids=["fcc", "bcc", "sc", "hcp", "monoclinic-cell"],
)
def test_reflector_tables_match_jax(make):
    got, want = make(tkin), make(jkin)
    assert len(got) == len(want) > 5
    for field in ("normals", "sin_theta", "intensity"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert tkin.electron_wavelength(20.0) == jkin.electron_wavelength(20.0)
    assert len(tkin.cubic_reflectors()) == 41


@pytest.mark.parametrize("tilt", [0.0, 12.5])
def test_pixel_directions_match_jax(tilt):
    kw = dict(shape=(24, 40), pcx=0.45, pcy=0.6, dd=0.65, tilt=tilt)
    got = tgeo.pixel_directions(tgeo.DetectorGeometry(**kw))
    want = jgeo.pixel_directions(jgeo.DetectorGeometry(**kw))
    assert got.dtype == np.float32 and got.shape == (24, 40, 3)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    with pytest.raises(ValueError, match="dd must be positive"):
        tgeo.DetectorGeometry(dd=0.0)


def _orientations(kind, n=24, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "euler":
        return rng.uniform([0, 0, 0], [360, 180, 360], size=(n, 3))
    q = rng.normal(size=(n, 4))
    return q  # normalized by both renderers


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("structure", ["fcc", "hcp"])
def test_simulate_matches_jax(kind, structure):
    o = _orientations(kind)
    kw = dict(shape=(36, 44), pcx=0.48, pcy=0.55, dd=0.6, tilt=5.0)
    make = (lambda m: m.hexagonal_reflectors()) if structure == "hcp" else (
        lambda m: m.cubic_reflectors())
    args = dict(angles_in_degrees=kind == "euler", chunk=10)
    got = tkin.simulate_patterns(o, tgeo.DetectorGeometry(**kw), make(tkin), device="cpu", **args)
    want = jkin.simulate_patterns(o, jgeo.DetectorGeometry(**kw), make(jkin), **args)
    assert got.shape == want.shape == (len(o), 36, 44) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    got8 = tkin.simulate_patterns(o, tgeo.DetectorGeometry(**kw), make(tkin), device="cpu",
                                  dtype=np.uint8, **args)
    want8 = jkin.simulate_patterns(o, jgeo.DetectorGeometry(**kw), make(jkin), dtype=np.uint8,
                                   **args)
    assert got8.dtype == np.uint8
    diff = np.abs(got8.astype(np.int16) - want8.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= UINT8_SHARE


def test_simulate_validates_its_input():
    with pytest.raises(ValueError, match="dtype"):
        tkin.simulate_patterns(np.zeros((1, 4)), dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 4\) quats"):
        tkin.simulate_patterns(np.zeros((2, 5)), device="cpu")


def test_render_precision_is_scoped():
    """Inside the scope the precision is "highest", and the caller's "high"
    comes back; at the default nothing is touched. The render equals itself
    under "high" (TF32 has no effect on the CPU, so this pins the plumbing;
    `chip_smoke.py` holds it on the card)."""
    saved = torch.get_float32_matmul_precision()
    o = _orientations("quat", n=6)
    geom = tgeo.DetectorGeometry(shape=(16, 16))
    base = tkin.simulate_patterns(o, geom, device="cpu")
    try:
        torch.set_float32_matmul_precision("high")
        with full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
        np.testing.assert_array_equal(tkin.simulate_patterns(o, geom, device="cpu"), base)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    with full_f32_matmul():
        assert torch.get_float32_matmul_precision() == saved
