"""The port's band fit to a master (`latice_tpu_torch.sim.master_fit`)
against latice_tpu.sim.master_fit on the same kinematical masters: one
float64 host ridge solve in each, so the fitted weights and the fit NCC
agree within `WEIGHT_ATOL` and `NCC_ATOL` (two LAPACK solves of the same
system), the kept bands are the same ones in the same order, and
`kinematical_master_ncc` agrees within `NCC_ATOL`.
"""

import numpy as np
import pytest
import torch

from latice_tpu.sim import cubic_reflectors as j_cubic
from latice_tpu.sim import hexagonal_reflectors as j_hex
from latice_tpu.sim import make_kinematical_master as j_master
from latice_tpu.sim import master_fit as jfit
from latice_tpu_torch.sim import Reflectors
from latice_tpu_torch.sim import cubic_reflectors, hexagonal_reflectors
from latice_tpu_torch.sim import master_fit as tfit

WEIGHT_ATOL, NCC_ATOL = 1e-6, 1e-9


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def masters():
    return {
        "fcc": (j_master(size=129, reflectors=j_cubic("fcc", max_hkl=3)),
                cubic_reflectors("fcc", max_hkl=4, min_d=0.6), j_cubic("fcc", max_hkl=4, min_d=0.6)),
        "hcp": (j_master(size=129, reflectors=j_hex(a=2.95, c=4.68)),
                hexagonal_reflectors(a=2.95, c=4.68, max_hkl=3, min_d=0.6),
                j_hex(a=2.95, c=4.68, max_hkl=3, min_d=0.6)),
    }


@pytest.mark.parametrize("phase", ["fcc", "hcp"])
@pytest.mark.parametrize("kw", [{}, {"allow_negative": False}, {"max_bands": 12}],
                         ids=["signed", "nonnegative", "truncated"])
def test_fit_matches_jax(masters, phase, kw):
    img, t_cand, j_cand = masters[phase]
    got, got_ncc = tfit.fit_reflectors_to_master(img, t_cand, **kw)
    want, want_ncc = jfit.fit_reflectors_to_master(img, j_cand, **kw)
    assert abs(got_ncc - want_ncc) < NCC_ATOL and got_ncc > 0.9
    np.testing.assert_array_equal(got.normals, want.normals)
    np.testing.assert_array_equal(got.sin_theta, want.sin_theta)
    np.testing.assert_allclose(got.intensity, want.intensity, atol=WEIGHT_ATOL, rtol=0)
    if "max_bands" in kw:
        assert len(got) == kw["max_bands"]


@pytest.mark.parametrize("phase", ["fcc", "hcp"])
def test_kinematical_master_ncc_matches_jax(masters, phase):
    img, t_cand, j_cand = masters[phase]
    got = tfit.kinematical_master_ncc(img, t_cand)
    want = jfit.kinematical_master_ncc(img, j_cand)
    assert abs(got - want) < NCC_ATOL


def test_validation(masters):
    img, t_cand, _ = masters["fcc"]
    with pytest.raises(ValueError, match="square"):
        tfit.fit_reflectors_to_master(img[:, :-1], t_cand)
    empty = Reflectors(normals=np.zeros((0, 3), np.float32), sin_theta=np.zeros(0, np.float32),
                       intensity=np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="empty"):
        tfit.fit_reflectors_to_master(img, empty)
