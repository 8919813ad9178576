"""``python -m latice_tpu_torch.cli.index analyze`` against the JAX package's
``index.py analyze`` on the maps of tests/index/test_cli.py (6x8 two-grain
maps, vendor ``.ang`` files, multi-phase maps, a Σ3 bicrystal, a
martensite map of KS variants), with every flag, on the CPU: the same
files, the same summary keys, the same errors.

Tolerances: labels, masks, counts, CSL and component codes, cleaned
Eulers, parent grains and variants are equal; angle fields, fits and
GOS through cos(θ/2) within 1e-6 (per pixel) or in degrees at 0.05° below
1° (averages); Schmid, Taylor, Young's modulus, GND, texture index and ODF
values within 1e-4 relative; parent orientations within 1e-3° of
misorientation. Figures are written by both and must exist; the IPF map's
pixels are equal.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.cli.index import main as jax_main
from latice_tpu_torch.cli.index import main as port_main

SMALL_ANGLE_DEG = 0.05
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _two_grain(seed, scale=0.1):
    rng = np.random.default_rng(seed)
    euler = np.empty((6, 8, 3))
    euler[:, :4] = [10.0, 20.0, 30.0]
    euler[:, 4:] = [80.0, 60.0, 40.0]
    return euler + rng.normal(scale=scale, size=euler.shape)


def _write_ang(path, euler, success=None, phases=None, groups=None):
    from latice_tpu.data import write_ang
    from latice_tpu.index import DenseIndexResult

    n = euler.shape[0] * euler.shape[1]
    success = np.ones(n, bool) if success is None else success
    res = DenseIndexResult(
        mean_orientation=euler.reshape(-1, 3), best_orientation=euler.reshape(-1, 3),
        success=success, n_similar=np.where(success, 12, 0).astype(np.int64),
        indices=np.tile(np.arange(5), (n, 1)), scores=np.full((n, 5), 0.9), phase=phases)
    write_ang(str(path), res, grid=euler.shape[:2], step=0.5, phase_groups=groups)
    return str(path)


def _twin_map():
    from latice_tpu_torch.crystal import csl_rotation

    qa = R.from_euler("zxz", [10.0, 20.0, 30.0], degrees=True)
    eb = (qa * R.from_quat(np.roll(csl_rotation("3"), -1))).as_euler("zxz", degrees=True)
    euler = np.empty((4, 6, 3))
    euler[:, :3], euler[:, 3:] = [10.0, 20.0, 30.0], eb
    return euler


def _martensite():
    """Two KS parents of three child strips each (tests/index/test_cli.py)."""
    from latice_tpu_torch.crystal import or_rotation, symmetry_quats
    from latice_tpu_torch.crystal.csl import _qmul_np

    rng = np.random.default_rng(0)
    t, sym = or_rotation("ks"), symmetry_quats("432").double().numpy()
    euler = np.empty((4, 12, 3))
    for p, pe in enumerate([[15.0, 30.0, 45.0], [70.0, 55.0, 10.0]]):
        gp = np.roll(R.from_euler("zxz", pe, degrees=True).as_quat(), 1)
        for j, k in enumerate(rng.choice(24, size=3, replace=False)):
            gc = _qmul_np(t, _qmul_np(sym[k], gp))
            strip = (R.from_quat(np.roll(gc, -1)) * R.from_rotvec(
                rng.normal(scale=np.radians(0.05), size=(8, 3)))).as_euler("zxz", degrees=True)
            euler[:, (3 * p + j) * 2:(3 * p + j) * 2 + 2] = strip.reshape(4, 2, 3)
    return euler


def _npy(tmp, name, arr):
    path = tmp / name
    np.save(path, arr)
    return str(path)


def _case(name, tmp):
    """(argv without --out-prefix, figures written) of one case."""
    if name == "every_flag":
        o = _npy(tmp, "o.npy", _two_grain(0).reshape(-1, 3))
        figs = {k: str(tmp / f"{k}.png") for k in ("mdf", "pf", "ipf", "odf")}
        return ["--orientations", o, "--grid", "6", "8", "--grain-stats", "--csl",
                "--csl-sigmas", "3,9,27a", "--brandon", "12", "--schmid", "0", "0.3", "1",
                "--slip-family", "bcc", "--taylor", "--load", "0.1", "0", "1", "--youngs",
                "246.5,147.3,124.7", "--gnd", "0.25", "--step-um", "0.5", "--components",
                "all", "--component-tolerance", "12", "--sample-symmetry", "monoclinic",
                "--texture-index", "--odf-halfwidth", "12", "--clean", "4", "--gb-threshold",
                "4", "--mdf", figs["mdf"], "--pole-figure", figs["pf"], "--pole", "1", "1",
                "1", "--ipf-map", figs["ipf"], "--ipf-mode", "ipf_x", "--odf-sections",
                figs["odf"], "--odf-phi2", "0,45"], figs
    if name == "defaults":
        o = _npy(tmp, "o.npy", _two_grain(1))
        return ["--orientations", o, "--grid", "6", "8", "--grain-stats", "--schmid", "0",
                "0", "1", "--taylor", "--youngs", "ni", "--gnd", "0.25", "--components",
                "cube,goss", "--texture-index"], {}
    if name == "hexagonal":
        o = _npy(tmp, "o.npy", _two_grain(2).reshape(-1, 3))
        ipf = str(tmp / "ipf.png")
        return ["--orientations", o, "--grid", "6", "8", "--group", "622", "--grain-stats",
                "--gnd", "0.3", "--ipf-map", ipf, "--texture-index"], {"ipf": ipf}
    if name == "vendor_phases":
        phases = np.repeat([0, 1], 24)
        a = _write_ang(tmp / "v.ang", _two_grain(5), phases=phases, groups=["432", "622"])
        ipf = str(tmp / "ipf.png")
        return ["--orientations", a, "--phase-groups", "432,622", "--grain-stats",
                "--texture-index", "--odf-phase", "1", "--ipf-map", ipf], {"ipf": ipf}
    if name == "vendor_clean":
        euler = _two_grain(8, 0.05)
        euler[1, 6] = [150.0, 90.0, 10.0]
        success = np.ones(48, bool)
        success[10] = False
        a = _write_ang(tmp / "d.ang", euler, success=success)
        return ["--orientations", a, "--clean", "2", "--grain-stats"], {}
    if name == "vendor_unindexed":
        success = np.ones(48, bool)
        success[[3, 4, 11, 12]] = False
        a = _write_ang(tmp / "u.ang", _two_grain(9), success=success)
        return ["--orientations", a, "--csl", "--gnd", "0.25"], {}
    if name == "multiphase":
        o = _npy(tmp, "o.npy", np.tile([10.0, 30.0, 50.0], (24, 1)))
        ph = np.zeros((4, 6), np.int64)
        ph[:, 3:] = 1
        ph[0, 0] = -1
        p = _npy(tmp, "p.npy", ph.ravel())
        odf = str(tmp / "odf.png")
        return ["--orientations", o, "--grid", "4", "6", "--phases", p, "--phase-groups",
                "432,622", "--grain-stats", "--clean", "--odf-sections", odf, "--odf-phase",
                "1"], {"odf": odf}
    if name == "twin":
        o = _npy(tmp, "o.npy", _twin_map().reshape(-1, 3))
        return ["--orientations", o, "--grid", "4", "6", "--csl"], {}
    if name == "parent":
        o = _npy(tmp, "o.npy", _martensite().reshape(-1, 3))
        return ["--orientations", o, "--grid", "4", "12", "--parent", "ks", "--parent-group",
                "432", "--parent-tolerance", "2.5", "--grain-stats"], {}
    raise KeyError(name)


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_run(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["index.py"] + argv)
    capsys.readouterr()
    jax_main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _cos_half(deg):
    return np.cos(np.radians(np.asarray(deg, np.float64)) / 2)


def _misorientation_deg(a, b, group="432"):
    from latice_tpu_torch.crystal import from_euler_zxz_deg, symmetry_reduced_misorientation
    from latice_tpu_torch.crystal.symmetry import symmetry_quats

    qa, qb = (from_euler_zxz_deg(torch.as_tensor(np.asarray(x, np.float64).reshape(-1, 3)))
              for x in (a, b))
    sym = symmetry_quats(group, dtype=torch.float64)
    return np.degrees(symmetry_reduced_misorientation(qa, qb, sym=sym, compose="sample").numpy())


def _hold_array(name, got, want):
    if name in ("grains", "boundaries", "csl_east", "csl_south", "components", "cleaned",
                "parent_grains", "variants"):
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif name == "kam":
        np.testing.assert_allclose(got, want, atol=SMALL_ANGLE_DEG, err_msg=name)
    elif name in ("gnd", "nye"):
        scale = np.nanmedian(np.abs(want)) if np.isfinite(want).any() else 1.0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)
    elif name == "parent_orientations":
        assert _misorientation_deg(got, want).max() < 1e-3
    elif name == "schmid_system":
        assert (got == want).mean() > 0.9  # ties between systems aside
    else:  # schmid, taylor, youngs
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)


def _hold_npz(name, got, want):
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        if key in ("mean_orientation", "parent_orientation"):
            assert _misorientation_deg(got[key], want[key]).max() < 1e-3, key
        elif key in ("gos_deg", "fit_deg"):
            np.testing.assert_allclose(_cos_half(got[key]), _cos_half(want[key]), atol=1e-6)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}:{key}")


SUMMARY_ANGLES = ("mean_kam_deg", "mean_gos_deg", "mean_parent_fit_deg",
                  "mean_boundary_disorientation_deg")


def _hold_summary(got, want, jax_dir, port_dir):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, str):
            assert g == w.replace(jax_dir, port_dir), key
        elif isinstance(w, list):
            assert g == [x.replace(jax_dir, port_dir) if isinstance(x, str) else x for x in w]
        elif isinstance(w, dict):
            assert g.keys() == w.keys(), key
            for k in w:  # fractions, rounded to 4 places
                assert abs(g[k] - w[k]) <= 1e-4 + 1e-12, (key, k)
        elif isinstance(w, bool) or isinstance(w, int):
            assert g == w, key
        elif key in SUMMARY_ANGLES:
            assert abs(g - w) <= SMALL_ANGLE_DEG, key
        elif w is None:
            assert g is None, key
        else:  # moduli, factors, texture index, ECD, fractions (rounded by the CLI)
            assert g == pytest.approx(w, rel=RTOL, abs=1e-4), key


CASES = ["every_flag", "defaults", "hexagonal", "vendor_phases", "vendor_clean",
         "vendor_unindexed", "multiphase", "twin", "parent"]


@pytest.mark.parametrize("name", CASES)
def test_analyze_matches_jax(name, tmp_path, capsys, monkeypatch):
    (tmp_path / "in").mkdir()
    argv, figs = _case(name, tmp_path / "in")
    argv = ["analyze"] + argv
    dirs = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        dirs[side] = str(tmp_path / side)
    want = _jax_run(argv + ["--out-prefix", f"{dirs['jax']}/a"], capsys, monkeypatch)
    jax_figs = {k: Path(v).read_bytes() for k, v in figs.items()}
    got = _run(port_main, argv + ["--out-prefix", f"{dirs['port']}/a", "--device", "cpu"], capsys)
    _hold_summary(got, want, dirs["jax"], dirs["port"])
    outputs = list(want["outputs"]) + ([want["cleaned_out"]] if "cleaned_out" in want else [])
    for path in outputs:
        tag = Path(path).stem[2:]
        mine = path.replace(dirs["jax"], dirs["port"])
        if path.endswith(".npz"):
            with np.load(path) as w, np.load(mine) as g:
                _hold_npz(tag, g, w)
        else:
            _hold_array(tag, np.load(mine), np.load(path))
    for key, path in figs.items():
        assert Path(path).stat().st_size > 0 and jax_figs[key]
    if "ipf" in figs:  # IPF colors and boundary masks: equal pixels
        import matplotlib.image as mpimg

        got_img = mpimg.imread(figs["ipf"])
        Path(figs["ipf"]).write_bytes(jax_figs["ipf"])
        np.testing.assert_array_equal(got_img, mpimg.imread(figs["ipf"]))


ERRORS = {
    "no_grid": (lambda t: ["--orientations", _npy(t, "o.npy", np.zeros((12, 3)))], "--grid"),
    "grid_mismatch": (lambda t: ["--orientations", _npy(t, "o.npy", np.zeros((12, 3))),
                                 "--grid", "3", "5"], "does not hold"),
    "mdf_flat": (lambda t: ["--orientations", _npy(t, "o.npy", np.zeros((12, 3))), "--grid",
                            "3", "4", "--mdf", str(t / "m.png")], "no grain-boundary edges"),
    "too_few_groups": (lambda t: ["--orientations", _npy(t, "o.npy", np.zeros((12, 3))),
                                  "--grid", "3", "4", "--phases",
                                  _npy(t, "p.npy", np.repeat([0, 1], 6))], "point groups"),
    "bad_sigma": (lambda t: ["--orientations", _npy(t, "o.npy", _two_grain(0)), "--grid", "6",
                             "8", "--csl", "--csl-sigmas", "3,4"], "unknown Σ"),
    "bad_youngs": (lambda t: ["--orientations", _npy(t, "o.npy", _two_grain(0)), "--grid",
                              "6", "8", "--youngs", "1,x,3"], "C11,C12,C44"),
    "bad_component": (lambda t: ["--orientations", _npy(t, "o.npy", _two_grain(0)), "--grid",
                                 "6", "8", "--components", "nope"], "unknown components"),
    "bad_or": (lambda t: ["--orientations", _npy(t, "o.npy", _two_grain(0)), "--grid", "6",
                          "8", "--parent", "xx"], "unknown OR"),
}
MULTIPHASE_REFUSALS = {
    "csl": ["--csl"], "taylor": ["--taylor"], "youngs": ["--youngs", "ni"],
    "gnd": ["--gnd", "0.25"], "schmid": ["--schmid", "0", "0", "1"],
    "components": ["--components", "all"], "parent": ["--parent", "ks"],
}


@pytest.mark.parametrize("name", list(ERRORS) + [f"multiphase_{k}" for k in MULTIPHASE_REFUSALS])
def test_analyze_errors_match_jax(name, tmp_path, capsys, monkeypatch):
    if name.startswith("multiphase_"):
        argv = ["--orientations", _npy(tmp_path, "o.npy", np.zeros((12, 3))), "--grid", "3",
                "4", "--phases", _npy(tmp_path, "p.npy", np.zeros(12, np.int64))]
        argv += MULTIPHASE_REFUSALS[name.split("_", 1)[1]]
        match = "single-phase|extract"
    else:
        make, match = ERRORS[name]
        argv = make(tmp_path)
    argv = ["analyze"] + argv + ["--out-prefix", str(tmp_path / "e")]
    monkeypatch.setattr(sys, "argv", ["index.py"] + argv)
    with pytest.raises(SystemExit, match=match) as want:
        jax_main()
    with pytest.raises(SystemExit, match=match) as got:
        port_main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
