"""The port's boundary-character, texture and micromechanics modules against
the JAX package's on the same seeded inputs, on the CPU: CSL labels and
orbits, texture components, the ODF (values, texture index, sections),
Schmid and Taylor factors, the IPF color key and pole figures; and each
tiled device stage forced into small tiles against one tile.

Tolerances: labels (CSL, components) are equal, the maps built so that no
deviation lies near a Brandon limit or the component radius; deviations
agree through cos(θ/2) within 1e-6; ODF values, the texture index and
Schmid factors within 1e-4 relative; host numpy copied from the JAX
package (orbits, slip systems, Taylor, colors, pole figures) is equal,
except the E and F component orbits, whose float32 Euler conversion
differs from XLA's by one ulp (held at 1e-7).
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import latice_tpu.crystal as jc
import latice_tpu.utils as ju
from latice_tpu_torch import crystal as tc
from latice_tpu_torch import utils as tu

COS_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def hold_angles(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.cos(np.radians(got) / 2), np.cos(np.radians(want) / 2),
                               atol=COS_ATOL)


@pytest.fixture(scope="module")
def twin_map():
    """A 16x20 map of 4x5 blocks: random grains, a Σ3 twin of its left
    neighbour in every other block, and ~0.2° of noise per pixel."""
    rng = np.random.default_rng(11)
    blocks = R.random(20, random_state=rng)
    s3 = R.from_quat(np.roll(jc.csl_rotation("3"), -1))
    qs = [blocks[0]]
    for i in range(1, 20):
        qs.append(qs[i - 1] * s3 if i % 2 else blocks[i])
    grid = np.repeat(np.repeat(np.arange(20).reshape(4, 5), 4, 0), 4, 1)
    noise = R.from_rotvec(rng.normal(scale=np.radians(0.2), size=(grid.size, 3)))
    rot = R.from_quat(np.stack([qs[i].as_quat() for i in grid.ravel()])) * noise
    return rot.as_euler("zxz", degrees=True).reshape(16, 20, 3)


@pytest.fixture(scope="module")
def textured():
    """96 orientations: a third near Cube, a third near Goss (8° spread),
    the rest random."""
    rng = np.random.default_rng(5)
    spread = R.from_rotvec(rng.normal(scale=np.radians(4.0), size=(64, 3)))
    cube = spread[:32] * R.from_euler("zxz", jc.TEXTURE_COMPONENTS["cube"], degrees=True)
    goss = spread[32:] * R.from_euler("zxz", jc.TEXTURE_COMPONENTS["goss"], degrees=True)
    rand = R.random(32, random_state=rng)
    return np.concatenate([r.as_euler("zxz", degrees=True) for r in (cube, goss, rand)])


def test_csl_orbits_and_table_equal_jax():
    for sigma in ["3", "9", "27b"]:
        np.testing.assert_array_equal(tc.csl_orbit(tc.csl_rotation(sigma)),
                                      jc.csl_orbit(jc.csl_rotation(sigma)))
    np.testing.assert_array_equal(tc.csl_orbit(np.asarray([1.0, 0, 0, 0]), "622"),
                                  jc.csl_orbit(np.asarray([1.0, 0, 0, 0]), "622"))
    assert tc.CSL_CUBIC == jc.CSL_CUBIC
    assert [tc.sigma_value(s) for s in tc.CSL_CUBIC] == [jc.sigma_value(s) for s in jc.CSL_CUBIC]
    assert tc.brandon_tolerance_deg("3") == jc.brandon_tolerance_deg("3")
    axis, angle = tc.csl_axis_angle("3")
    assert axis.tolist() == [1, 1, 1] and angle == pytest.approx(60.0)


def test_csl_labels_match_jax(twin_map):
    from latice_tpu.crystal.csl import _deviation_fields as jax_fields
    from latice_tpu_torch.crystal.csl import _deviation_fields as port_fields

    got = tc.classify_csl_boundaries(twin_map, device="cpu")
    want = jc.classify_csl_boundaries(twin_map)
    np.testing.assert_array_equal(got.east, want.east)
    np.testing.assert_array_equal(got.south, want.south)
    assert got.sigmas == want.sigmas
    frac = tc.csl_fractions(got)
    assert frac == jc.csl_fractions(want) and frac["3"] > 0.2
    # The deviations behind the labels, and the boundary field (Σ1 row).
    orbits = [jc.csl_orbit(np.asarray([1.0, 0, 0, 0]))] + [
        jc.csl_orbit(jc.csl_rotation(s)) for s in ("3", "9")]
    packed = np.zeros((3, max(map(len, orbits)), 4), np.float32)
    valid = np.zeros(packed.shape[:2], bool)
    for i, o in enumerate(orbits):
        packed[i, : len(o)], valid[i, : len(o)] = o, True
    e32 = twin_map.astype(np.float32)
    mine = port_fields(torch.as_tensor(e32), torch.as_tensor(packed), torch.as_tensor(valid))
    ref = jax_fields(e32, packed, valid)
    for a, b in zip(mine, ref):
        hold_angles(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="cubic"):
        tc.classify_csl_boundaries(twin_map, group="622", device="cpu")
    with pytest.raises(ValueError, match="unknown Σ"):
        tc.classify_csl_boundaries(twin_map, sigmas=["4"], device="cpu")


@pytest.mark.parametrize("name", list(jc.TEXTURE_COMPONENTS))
def test_component_orbits_match_jax(name):
    euler = jc.TEXTURE_COMPONENTS[name]
    for sym in ("orthorhombic", "triclinic"):
        got, want = tc.component_orbit(euler, sample_symmetry=sym), jc.component_orbit(
            euler, sample_symmetry=sym)
        if name in ("e", "f"):  # XLA's f32 sin differs by one ulp at 27.37°
            np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
        else:
            np.testing.assert_array_equal(got, want)


def test_components_match_jax(textured):
    got = tc.texture_component_fractions(textured, device="cpu")
    want = jc.texture_component_fractions(textured)
    assert got.names == want.names
    np.testing.assert_array_equal(got.labels, want.labels)
    hold_angles(got.deviation_deg, want.deviation_deg)
    assert got.fractions == want.fractions
    assert got.fractions["cube"] >= 1 / 3 and got.fractions["goss"] >= 1 / 3
    sub = tc.texture_component_fractions(textured[:8], components={"c": (0, 0, 0)},
                                         sample_symmetry="monoclinic", tolerance_deg=5.0,
                                         device="cpu")
    ref = jc.texture_component_fractions(textured[:8], components={"c": (0, 0, 0)},
                                         sample_symmetry="monoclinic", tolerance_deg=5.0)
    np.testing.assert_array_equal(sub.labels, ref.labels)
    with pytest.raises(ValueError, match="unknown components"):
        tc.texture_component_fractions(textured, components=["bogus"], device="cpu")


@pytest.fixture(scope="module")
def odfs(textured):
    w = np.random.default_rng(2).uniform(0.5, 1.0, len(textured))
    return (tc.make_odf(textured, halfwidth_deg=10.0, weights=w, device="cpu"),
            jc.make_odf(textured, halfwidth_deg=10.0, weights=w))


def test_odf_matches_jax(odfs, textured):
    got, want = odfs
    np.testing.assert_allclose(got.samples, want.samples, atol=2.4e-7)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.kappa == want.kappa
    pts = textured[::4]
    np.testing.assert_allclose(tc.evaluate_odf(got, pts, device="cpu"),
                               jc.evaluate_odf(want, pts), rtol=1e-4, atol=1e-4)
    ti = tc.texture_index(got, n=2048, device="cpu")
    assert ti == pytest.approx(jc.texture_index(want, n=2048), rel=1e-4) and ti > 2.0
    secs, p1, p = tc.odf_sections(got, phi2_deg=(0.0, 45.0), resolution_deg=15.0, device="cpu")
    ref = jc.odf_sections(want, phi2_deg=(0.0, 45.0), resolution_deg=15.0)
    np.testing.assert_allclose(secs, ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(p1, ref[1])
    np.testing.assert_array_equal(p, ref[2])
    assert tc.halfwidth_to_kappa(10.0) == jc.halfwidth_to_kappa(10.0)
    with pytest.raises(ValueError, match="halfwidth"):
        tc.make_odf(textured, halfwidth_deg=0.0, device="cpu")


def test_small_tiles_equal_one_tile(monkeypatch, twin_map, textured, odfs):
    """Every tiled stage forced into tiles of a few rows, points or
    samples: CSL and components per edge or pixel are equal; the ODF's sum
    over samples changes order only."""
    from latice_tpu_torch.crystal import components, csl, odf

    whole = (tc.classify_csl_boundaries(twin_map, device="cpu"),
             tc.texture_component_fractions(textured, device="cpu"),
             tc.evaluate_odf(odfs[0], textured[:20], device="cpu"))
    monkeypatch.setattr(csl, "TILE_BYTES", 20 * 22 * 878 * 4 * 3)  # 3 rows per tile
    monkeypatch.setattr(components, "TILE_BYTES", 1000)
    monkeypatch.setattr(odf, "TILE_BYTES", 24 * 16 * 4 * 3)  # 3 points per tile
    monkeypatch.setattr(odf, "SAMPLE_TILE", 16)
    tiled = (tc.classify_csl_boundaries(twin_map, device="cpu"),
             tc.texture_component_fractions(textured, device="cpu"),
             tc.evaluate_odf(odfs[0], textured[:20], device="cpu"))
    np.testing.assert_array_equal(tiled[0].east, whole[0].east)
    np.testing.assert_array_equal(tiled[0].south, whole[0].south)
    np.testing.assert_array_equal(tiled[1].labels, whole[1].labels)
    np.testing.assert_array_equal(tiled[1].deviation_deg, whole[1].deviation_deg)
    np.testing.assert_allclose(tiled[2], whole[2], rtol=1e-6)


@pytest.mark.parametrize("family", ["fcc", "bcc", "bcc112"])
def test_schmid_and_taylor_match_jax(family, textured):
    for a, b in zip(tc.slip_systems(family), jc.slip_systems(family)):
        np.testing.assert_array_equal(a, b)
    load = (0.2, 0.3, 1.0)
    got = tc.schmid_factors(textured, load, family, device="cpu")
    want = jc.schmid_factors(textured, load, family)
    np.testing.assert_allclose(got.max_factor, want.max_factor, rtol=1e-4)
    # The active system, where the best two systems are not tied.
    m = np.abs(np.einsum("nij,j->ni", R.from_euler("zxz", textured, degrees=True).as_matrix(),
                         np.asarray(load) / np.linalg.norm(load)))
    normals, dirs = jc.slip_systems(family, dtype=np.float64)
    f = np.sort(np.abs((m @ normals.T) * (m @ dirs.T)), axis=1)
    clear = f[:, -1] - f[:, -2] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.system[clear], want.system[clear])
    t_got, t_want = tc.taylor_factors(textured, load, family), jc.taylor_factors(textured, load,
                                                                                  family)
    np.testing.assert_array_equal(t_got.factor, t_want.factor)
    np.testing.assert_array_equal(t_got.vertex, t_want.vertex)
    np.testing.assert_array_equal(tc.bishop_hill_vertices(family), jc.bishop_hill_vertices(family))


def test_schmid_cube_textbook():
    got = tc.schmid_factors(np.zeros((2, 3, 3)), device="cpu")
    assert got.max_factor.shape == (2, 3)
    np.testing.assert_allclose(got.max_factor, 1 / np.sqrt(6), rtol=1e-6)
    with pytest.raises(ValueError, match="nonzero"):
        tc.schmid_factors(np.zeros((2, 3)), load_direction=(0, 0, 0), device="cpu")


@pytest.mark.parametrize("group", ["432", "23", "622", "32", "1"])
def test_color_key_and_pole_figure_equal_jax(group, textured):
    np.testing.assert_array_equal(tu.get_color_key(textured, "ipf_x", group=group),
                                  ju.get_color_key(textured, "ipf_x", group=group))
    assert tu.get_color_key(textured[:3], hex_string=True) == ju.get_color_key(
        textured[:3], hex_string=True)
    np.testing.assert_array_equal(tu.compute_pole_figure(textured, (1, 1, 1), group),
                                  ju.compute_pole_figure(textured, (1, 1, 1), group))


def test_color_key_generator_matches_jax():
    from latice_tpu.utils.colorkey import IPF_SECTORS as want_sectors
    from latice_tpu_torch.utils.colorkey import IPF_SECTORS

    axes = np.random.default_rng(0).normal(size=(50, 3))
    for group in IPF_SECTORS:
        np.testing.assert_array_equal(tu.ColorKeyGenerator(group).generate_ipf_colors(axes),
                                      ju.ColorKeyGenerator(group).generate_ipf_colors(axes))
    assert IPF_SECTORS == want_sectors
    assert tu.ColorKeyGenerator().generate_ipf_color([0, 0, 1]) == [255, 0, 0]
    assert tu.ColorKeyGenerator.drgb(255, [1, 2, 3]) == ju.ColorKeyGenerator.drgb(255, [1, 2, 3])


def test_figures_render(tmp_path, textured, odfs):
    pytest.importorskip("matplotlib")
    fig = tu.plot_pole_figure(textured, pole=(1, 1, 0))
    fig.savefig(tmp_path / "pf.png")
    secs, p1, p = tc.odf_sections(odfs[0], phi2_deg=(0.0,), resolution_deg=15.0, device="cpu")
    arr = tu.figure_to_array(tu.plot_odf_sections(secs, p1, p, (0.0,)))
    assert arr.ndim == 3 and arr.shape[-1] == 4
    assert (tmp_path / "pf.png").stat().st_size > 0
