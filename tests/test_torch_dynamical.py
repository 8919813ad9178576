"""The port's dynamical master (`latice_tpu_torch.sim.dynamical`) against the
JAX package's on the same seeded inputs, on the CPU.

* Host float64 parts (structures, potentials, `DynamicalBeams`): bitwise.
* `channeling_intensities` on the real path, the 2N embedding and the
  measured-depth quadrature, 15-27 beams, 64 seeded generic directions:
  within `CHANNEL_RTOL` relative (measured: at most 1.14e-5; eigenvectors
  differ by f32 roundoff between LAPACK builds, the intensities are
  invariant under each eigenspace's basis).
* The JAX suite's analytic checks on the port alone, at its tolerances:
  the two-beam closed forms (real 2e-4, complex 3e-4), the forced
  embedding (2e-4), cubic, zincblende and wurtzite invariance (5e-3).
* A 33 px fcc and a 17 px zincblende master against JAX's: largest
  difference of the normalized images within `MASTER_ATOL` (measured:
  7.5e-6 at 33 px, 6.8e-6 at 17 px).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import latice_tpu.sim.dynamical as jd
import latice_tpu_torch.sim.dynamical as pd
from latice_tpu.crystal import ROTATION_GROUPS

CHANNEL_RTOL = 2e-4
MASTER_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


STRUCTURES = {
    "fcc": lambda m: m.cubic_structure("fcc", "ni", 3.52),
    "bcc": lambda m: m.cubic_structure("bcc", "fe", 2.87),
    "sc": lambda m: m.cubic_structure("sc", 29, 3.0),
    "hcp": lambda m: m.hexagonal_structure(),
    "zincblende": lambda m: m.zincblende_structure(),
    "wurtzite": lambda m: m.wurtzite_structure("zn", "o", 3.25, 5.207, 0.382),
}


def _dirs(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_structures_and_potentials_bitwise(name):
    js, ps = STRUCTURES[name](jd), STRUCTURES[name](pd)
    _same(js.direct_basis, ps.direct_basis)
    _same(js.reciprocal_basis, ps.reciprocal_basis)
    assert js.volume == ps.volume
    assert [s.z for s in js.sites] == [s.z for s in ps.sites]
    hkl = np.stack(np.meshgrid(*[np.arange(-3, 4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    _same(jd.fourier_potential_complex(js, hkl, 20.0), pd.fourier_potential_complex(ps, hkl, 20.0))
    _same(jd.fourier_potential(js, hkl, 15.0), pd.fourier_potential(ps, hkl, 15.0))
    try:
        jc = js.centered_sites()
    except NotImplementedError:
        with pytest.raises(NotImplementedError, match="inversion center"):
            ps.centered_sites()
    else:
        assert [s.frac for s in jc.sites] == [s.frac for s in ps.centered_sites().sites]
    s = np.linspace(0.0, 3.0, 31)
    for z in (6, 28, 79):
        _same(jd.wentzel_form_factor(z)(s), pd.wentzel_form_factor(z)(s))


@pytest.mark.parametrize("name", list(STRUCTURES))
@pytest.mark.parametrize("n_beams,max_hkl", [(15, 2), (27, 3)])
def test_dynamical_beams_bitwise(name, n_beams, max_hkl):
    jb = jd.dynamical_beams(STRUCTURES[name](jd), kv=20.0, n_beams=n_beams, max_hkl=max_hkl)
    pb = pd.dynamical_beams(STRUCTURES[name](pd), kv=20.0, n_beams=n_beams, max_hkl=max_hkl)
    for field in dataclasses.fields(jb):
        want, got = getattr(jb, field.name), getattr(pb, field.name)
        if isinstance(want, float):
            assert want == got, field.name
        else:
            _same(want, got)
    assert pb.is_centrosymmetric == jb.is_centrosymmetric


def test_host_errors_match_jax():
    for mod in (jd, pd):
        with pytest.raises(ValueError, match="unknown element 'xx'"):
            _ = mod.AtomSite("xx", (0, 0, 0)).z
        with pytest.raises(ValueError, match="at least one atom site"):
            mod.CrystalStructure(3.0, 3.0, 3.0)
        with pytest.raises(ValueError, match="unknown centering"):
            mod.cubic_structure("hex")
        with pytest.raises(ValueError, match="raise n_beams"):
            mod.dynamical_beams(mod.cubic_structure(), n_beams=1, max_hkl=2)
        with pytest.raises(ValueError, match="atomic number must be positive"):
            mod.wentzel_form_factor(0)


# (structure, beams, max_hkl, quadrature)
CHANNEL_CASES = {
    "real": ("fcc", 27, 2, False),
    "real_hcp": ("hcp", 21, 2, False),
    "hermitian_zincblende": ("zincblende", 21, 2, False),
    "hermitian_wurtzite": ("wurtzite", 15, 2, False),
    "quad_real": ("fcc", 16, 2, True),
    "quad_hermitian": ("zincblende", 14, 2, True),
}


@pytest.fixture(scope="module")
def channel_results():
    """Both packages' intensities per case at 64 seeded generic directions
    (chunk 48: two chunks, the second padded)."""
    d = _dirs(64, 1)
    zc = (np.arange(40) + 0.5) * 10.0
    zw = np.exp(-zc / 50.0)
    out = {}
    for case, (name, n, max_hkl, quad) in CHANNEL_CASES.items():
        kw = dict(depth_centers_nm=zc, depth_weights=zw) if quad else {}
        jb = jd.dynamical_beams(STRUCTURES[name](jd), n_beams=n, max_hkl=max_hkl)
        pb = pd.dynamical_beams(STRUCTURES[name](pd), n_beams=n, max_hkl=max_hkl)
        out[case] = (jd.channeling_intensities(d, jb, chunk=48, **kw),
                     pd.channeling_intensities(d, pb, chunk=48, device="cpu", **kw))
    return out


@pytest.mark.parametrize("case", list(CHANNEL_CASES))
def test_channeling_matches_jax(channel_results, case):
    want, got = channel_results[case]
    assert got.dtype == np.float32 and got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=CHANNEL_RTOL, atol=0)


def test_channeling_keeps_leading_shape_and_corners():
    beams = pd.dynamical_beams(pd.cubic_structure(), n_beams=9, max_hkl=1)
    d = _dirs(12, 2).reshape(3, 4, 3)
    d[0, 0] = 0.0  # a Lambert corner: mapped to the pole, not NaN
    got = pd.channeling_intensities(d, beams, chunk=5, device="cpu")
    assert got.shape == (3, 4) and np.all(np.isfinite(got))
    pole = pd.channeling_intensities(np.array([[0.0, 0.0, 1.0]]), beams, chunk=5, device="cpu")
    np.testing.assert_allclose(got[0, 0], pole[0], rtol=1e-6)


def _two_beam(complex_: bool):
    """The JAX suite's hand-built two-beam systems
    (tests/sim/test_dynamical.py::TestTwoBeamClosedForm::test_matches_analytic
    and TestHermitianPath::test_two_beam_complex_closed_form), evaluated by
    the port and by an independent numpy derivation."""
    a_lat, kv = (5.65 if complex_ else 3.52), 20.0
    k = 1.0 / pd.electron_wavelength(kv)
    g = np.array([[0.0, 0.0, 0.0], [1 / a_lat, 1 / a_lat, 1 / a_lat]])
    w = 1.8e-3 + 1.1e-3j if complex_ else 2.6e-3
    b_off = 0.3 + 0.2j if complex_ else 0.4
    kw = {}
    if complex_:
        kw = dict(coupling_imag=np.array([[0, w.imag], [-w.imag, 0]], np.float32),
                  backscatter_imag=np.array([[0, b_off.imag], [-b_off.imag, 0]], np.float32))
    beams = pd.DynamicalBeams(
        hkl=np.array([[0, 0, 0], [1, 1, 1]], np.int32), g=g.astype(np.float32),
        coupling=np.array([[0, np.real(w)], [np.real(w), 0]], np.float32),
        backscatter=np.array([[1, np.real(b_off)], [np.real(b_off), 1]], np.float32),
        k_int=k, u0=0.05, **kw,
    )
    depth_nm, kappa = 40.0, 0.1
    q_scale, z0 = kappa * beams.u0 / (2 * k), depth_nm * 10.0
    gn = g[1] / np.linalg.norm(g[1])
    t = np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0)
    thetas = np.linspace(-0.06, 0.06, 41)
    dirs = np.cos(thetas)[:, None] * t + np.sin(thetas)[:, None] * gn
    got = pd.channeling_intensities(dirs, beams, depth_nm=depth_nm, absorption_ratio=kappa,
                                    chunk=41, device="cpu")
    bmat = np.array([[1.0, b_off], [np.conj(b_off), 1.0]])
    want = np.empty_like(got)
    for i, d in enumerate(dirs):
        s = float(d @ g[1] - g[1] @ g[1] / (2 * k))
        _, vecs = np.linalg.eigh(np.array([[0.0, w], [np.conj(w), s]]))
        total = 0.0
        for j in range(2):
            v = vecs[:, j]
            sigma = float(np.real(v.conj() @ bmat @ v))
            total += abs(v[0]) ** 2 * sigma / (1 + 2 * np.pi * q_scale * z0 * sigma)
        want[i] = total
    return got, want


@pytest.mark.parametrize("complex_,rtol", [(False, 2e-4), (True, 3e-4)])
def test_two_beam_closed_form(complex_, rtol):
    got, want = _two_beam(complex_)
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_forced_embedding_matches_real_path():
    beams = pd.dynamical_beams(pd.cubic_structure(), n_beams=15, max_hkl=2)
    d = _dirs(16, 3)
    base = pd.channeling_intensities(d, beams, chunk=16, device="cpu")
    zeros = np.zeros_like(beams.coupling)
    forced = dataclasses.replace(beams, coupling_imag=zeros, backscatter_imag=zeros)
    assert not forced.is_centrosymmetric
    emb = pd.channeling_intensities(d, forced, chunk=16, device="cpu")
    np.testing.assert_allclose(emb, base, rtol=2e-4, atol=1e-6)


def _rotations(group: str) -> np.ndarray:
    quats = np.asarray(ROTATION_GROUPS[group])  # scalar-first
    return R.from_quat(np.roll(quats, -1, axis=1)).as_matrix()


@pytest.mark.parametrize("name,group,n,seed", [
    ("fcc", "432", 27, 7), ("zincblende", "23", 27, 11),
])
def test_point_group_invariance(name, group, n, seed):
    beams = pd.dynamical_beams(STRUCTURES[name](pd), n_beams=n, max_hkl=2)
    d = _dirs(12, seed)
    mats = _rotations(group)
    rotated = np.concatenate([d @ rot.T for rot in mats])
    got = pd.channeling_intensities(rotated, beams, chunk=len(rotated), device="cpu")
    base = got[: len(d)]
    np.testing.assert_allclose(got.reshape(len(mats), len(d)), np.tile(base, (len(mats), 1)),
                               rtol=5e-3, atol=1e-6)


def test_wurtzite_sixfold_invariance():
    beams = pd.dynamical_beams(pd.wurtzite_structure(), n_beams=15, max_hkl=2)
    assert not beams.is_centrosymmetric
    d = _dirs(8, 5)
    rot = R.from_rotvec([0, 0, math.radians(60.0)]).as_matrix()
    base = pd.channeling_intensities(d, beams, chunk=8, device="cpu")
    got = pd.channeling_intensities(d @ rot.T, beams, chunk=8, device="cpu")
    np.testing.assert_allclose(got, base, rtol=5e-3, atol=1e-6)


@pytest.mark.parametrize("name,size,n_beams", [("fcc", 33, 15), ("zincblende", 17, 14)])
def test_master_matches_jax(name, size, n_beams):
    kw = dict(size=size, n_beams=n_beams, max_hkl=2, chunk=128)
    want = jd.dynamical_master_pattern(STRUCTURES[name](jd), **kw)
    got = pd.dynamical_master_pattern(STRUCTURES[name](pd), device="cpu", **kw)
    assert got.shape == (size, size) and got.dtype == np.float32
    assert got.min() == 0.0 and got.max() == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=MASTER_ATOL)


def test_validation_and_refusals():
    beams = pd.dynamical_beams(pd.cubic_structure(), n_beams=9, max_hkl=1)
    d = _dirs(4, 4)
    with pytest.raises(ValueError, match="together"):
        pd.channeling_intensities(d, beams, depth_centers_nm=np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="matching"):
        pd.channeling_intensities(d, beams, depth_centers_nm=np.ones(3),
                                  depth_weights=np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="positive mass"):
        pd.channeling_intensities(d, beams, depth_centers_nm=np.ones(3),
                                  depth_weights=np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="master size must be >= 3"):
        pd.dynamical_master_pattern(pd.cubic_structure(), size=2, device="cpu")
    # mesh= takes a parallel.Mesh (tests/test_torch_parallel_paths.py runs it).
    with pytest.raises(TypeError, match="Mesh"):
        pd.channeling_intensities(d, beams, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        pd.dynamical_master_pattern(pd.cubic_structure(), mesh=object(), device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    beams = pd.dynamical_beams(pd.cubic_structure(), n_beams=9, max_hkl=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pd.channeling_intensities(_dirs(4, 4), beams)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pd.dynamical_master_pattern(pd.cubic_structure(), size=5, beams=beams)
