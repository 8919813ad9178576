"""The port's orientation-map plane against the JAX package's on the same
seeded maps: misorientation fields (single- and multi-phase), KAM, boundary
masks and angles, grain labels, cleanup, grain statistics and the Mackenzie
baseline, on the CPU.

Tolerances: an angle field agrees through cos(θ/2) within 1e-6 (one f32
ulp of a dot moves a near-zero angle by up to 0.04°, so degrees are not
compared directly); labels, masks and counts are equal, the maps being
built so that no edge lies within that tolerance of the 5° threshold;
what is copied host numpy is equal on equal inputs.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import latice_tpu.crystal.maps as jm
from latice_tpu_torch.crystal import maps as tm

COS_ATOL = 1e-6
THRESHOLD = 5.0


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def voronoi_map(h, w, n_grains, noise_deg, seed):
    """``(h, w, 3)`` zxz Euler degrees: a seeded Voronoi map of
    ``n_grains`` random orientations, each pixel turned by ~``noise_deg``."""
    rng = np.random.default_rng(seed)
    seeds = rng.uniform(0, 1, (n_grains, 2)) * [h, w]
    yy, xx = np.mgrid[0:h, 0:w]
    owner = ((yy[..., None] - seeds[:, 0]) ** 2 + (xx[..., None] - seeds[:, 1]) ** 2).argmin(-1)
    grains = R.random(n_grains, random_state=rng)
    noise = R.from_rotvec(rng.normal(scale=np.radians(noise_deg), size=(h * w, 3)))
    return (grains[owner.ravel()] * noise).as_euler("zxz", degrees=True).reshape(h, w, 3)


def hold_angles(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.cos(np.radians(got) / 2), np.cos(np.radians(want) / 2),
                               atol=COS_ATOL)


def _clear_of_threshold(maps):
    for f in (maps.east[:, :-1], maps.south[:-1, :]):
        assert not np.any(np.abs(f - THRESHOLD) < 0.5), "an edge lies near the threshold"


@pytest.fixture(scope="module")
def grid():
    euler = voronoi_map(24, 32, 12, 0.3, seed=3)
    _clear_of_threshold(jm.misorientation_maps(euler))
    return euler


@pytest.fixture(scope="module")
def phases():
    ph = np.zeros((24, 32), np.int64)
    ph[:, 16:] = 1
    ph[5, 3] = -1
    return ph


@pytest.fixture(scope="module")
def fields(grid):
    return tm.misorientation_maps(grid, device="cpu"), jm.misorientation_maps(grid)


@pytest.mark.parametrize("group", ["432", "622"])
def test_misorientation_maps_match_jax(grid, group):
    got = tm.misorientation_maps(grid, group=group, device="cpu")
    want = jm.misorientation_maps(grid, group=group)
    assert got.east.dtype == np.float32 and got.east.shape == (24, 32)
    hold_angles(got.east, want.east)
    hold_angles(got.south, want.south)
    assert (got.east[:, -1] == 0).all() and (got.south[-1] == 0).all()


def test_multiphase_fields_match_jax(grid, phases):
    got = tm.misorientation_maps_multiphase(grid, phases, ["432", "622"], device="cpu")
    want = jm.misorientation_maps_multiphase(grid, phases, ["432", "622"])
    hold_angles(got.east, want.east)
    hold_angles(got.south, want.south)
    assert (got.east == tm.PHASE_BOUNDARY_DEG).sum() == (want.east == jm.PHASE_BOUNDARY_DEG).sum()
    with pytest.raises(ValueError, match="only 1 groups"):
        tm.misorientation_maps_multiphase(grid, phases, ["432"], device="cpu")


def test_labels_masks_and_kam_match_jax(fields):
    got, want = fields
    labels, n = tm.label_grains(got, THRESHOLD)
    want_labels, want_n = jm.label_grains(want, THRESHOLD)
    assert n == want_n == 12
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(tm.grain_boundary_mask(got, THRESHOLD),
                                  jm.grain_boundary_mask(want, THRESHOLD))
    # KAM averages sub-threshold angles: held in degrees at the small-angle
    # rule (0.05° under 1°), the count of neighbours equal.
    np.testing.assert_allclose(tm.kernel_average_misorientation(got, THRESHOLD),
                               jm.kernel_average_misorientation(want, THRESHOLD), atol=0.05)
    hold_angles(np.sort(tm.boundary_disorientation_angles(got, THRESHOLD)),
                np.sort(jm.boundary_disorientation_angles(want, THRESHOLD)))


@pytest.mark.parametrize("fn", ["label_grains", "kernel_average_misorientation",
                                "grain_boundary_mask", "boundary_disorientation_angles"])
def test_host_parts_equal_jax_bitwise(fields, fn):
    """The copied host numpy gives the JAX package's answer bit for bit on
    the same fields."""
    _, want = fields
    got, ref = getattr(tm, fn)(want, THRESHOLD), getattr(jm, fn)(want, THRESHOLD)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_array_equal(a, b)


def _disorientation_deg(a, b):
    from latice_tpu_torch.crystal import from_euler_zxz_deg, symmetry_reduced_misorientation

    qa, qb = (from_euler_zxz_deg(torch.as_tensor(np.asarray(x, np.float64))) for x in (a, b))
    return np.degrees(symmetry_reduced_misorientation(qa, qb).numpy())


def test_grain_statistics_match_jax(grid, fields):
    labels, _ = jm.label_grains(fields[1], THRESHOLD)
    got = tm.grain_statistics(grid, labels, device="cpu")
    want = jm.grain_statistics(grid, labels)
    np.testing.assert_array_equal(got.sizes_px, want.sizes_px)
    np.testing.assert_array_equal(got.equivalent_diameter_px, want.equivalent_diameter_px)
    assert _disorientation_deg(got.mean_orientation, want.mean_orientation).max() < 1e-3
    # GOS: a mean of ~0.3° angles, each held at the small-angle rule.
    np.testing.assert_allclose(got.gos_deg, want.gos_deg, atol=0.05)
    assert 0.1 < got.gos_deg.mean() < 1.0
    with pytest.raises(ValueError, match="do not match"):
        tm.grain_statistics(grid, labels[:-1], device="cpu")


def test_clean_orientation_map_matches_jax(grid, phases):
    euler = grid.copy()
    euler[3, 4] = [150.0, 90.0, 10.0]  # a one-pixel speckle
    bad = np.zeros((24, 32), bool)
    bad[10, 10:12] = True
    got = tm.clean_orientation_map(euler, bad=bad, min_grain_px=2, device="cpu")
    want = jm.clean_orientation_map(euler, bad=bad, min_grain_px=2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].sum() == 3 and got[2] is None
    got = tm.clean_orientation_map(euler, phases=phases, groups=["432", "622"], device="cpu")
    want = jm.clean_orientation_map(euler, phases=phases, groups=["432", "622"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="without per-phase groups"):
        tm.clean_orientation_map(euler, phases=phases, device="cpu")


@pytest.mark.parametrize("group", ["432", "622"])
def test_random_disorientation_angles_match_jax(group):
    got = tm.random_disorientation_angles(group, n=2000, seed=1, device="cpu")
    hold_angles(got, jm.random_disorientation_angles(group, n=2000, seed=1))
    if group == "432":
        assert got.max() < 62.9  # the Mackenzie cutoff


def test_input_checks():
    with pytest.raises(ValueError, match="at least 2x2"):
        tm.misorientation_maps(np.zeros((1, 4, 3)), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tm.misorientation_maps(np.zeros((4, 4)), device="cpu")
