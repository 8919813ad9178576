"""``python -m latice_tpu_torch.cli.index sphere``, ``simulate --master
[--fit-bands]`` and ``learn-master`` against the JAX package's
``index.py`` on the same arguments and files, on the CPU, at 64x64 from
257 masters.

* sphere, single phase (Newton, ``--ang --ambiguity``): orientations within
  `NEWTON_DEG` of JAX's (`test_torch_spherical.py`'s bound), scores within
  `SCORE_ATOL`, the same ``.ang`` phase and success columns, ambiguity
  rivals and gaps, and the same summary counts; multi-phase (fcc + hcp,
  grid mode, ``--ctf``): the same phases within `ORIENT_DEG`.
* simulate --master: patterns within `RENDER_ATOL` of JAX's
  (`test_torch_master.py`'s bound), circle and square layouts; with
  ``--fit-bands`` the same ``kind: master_fit`` sidecar (bands equal,
  weights within 1e-6), which ``build`` and ``query --refine`` then read.
* learn-master: the learned master within 1e-6 and the same coverage.
* ``master`` (the dynamical master), once refused, runs as JAX's does.
"""

import json
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.cli import index as jax_cli
from latice_tpu.crystal import ROTATION_GROUPS
from latice_tpu.sim import DetectorGeometry, hexagonal_reflectors, make_kinematical_master
from latice_tpu.sim import render_from_master
from latice_tpu_torch.cli import index as port_cli
from latice_tpu_torch.data import read_ang, read_ctf

NEWTON_DEG, ORIENT_DEG = 1e-2, 1e-3
SCORE_ATOL = 1e-6
RENDER_ATOL = 1e-5
SPHERE = ["--bandwidth", "16", "--batch-size", "8"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _run(side, argv, monkeypatch, capsys):
    """One command through either CLI, the port's on the CPU; its JSON
    summary line (None for ``build``, which prints none)."""
    if side == "jax":
        monkeypatch.setattr(sys, "argv", ["index.py"] + argv)
        jax_cli.main()
    else:
        port_cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip()
    return None if argv[0] == "build" else json.loads(out.splitlines()[-1])


def _mis_deg(a, b, group="432"):
    sym = R.from_quat(np.roll(ROTATION_GROUPS[group], -1, axis=1))
    ra, rb = (R.from_euler("zxz", e, degrees=True) for e in (a, b))
    return np.array([np.degrees(min(((x * s).inv() * y).magnitude() for s in sym))
                     for x, y in zip(ra, rb)])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """fcc and hcp kinematical masters (257), 10 fcc renders at 64x64 with
    their anglefile, and 4 fcc + 4 hcp renders."""
    t = tmp_path_factory.mktemp("spherecli")
    fcc = make_kinematical_master(size=257)
    hcp = make_kinematical_master(size=257, reflectors=hexagonal_reflectors())
    np.save(t / "fcc.npy", fcc)
    np.save(t / "hcp.npy", hcp)
    geom = DetectorGeometry(shape=(64, 64))
    e = R.random(10, random_state=5).as_euler("zxz", degrees=True)
    (t / "a.txt").write_text("eu\n10\n" + "".join(f"{a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in e))
    np.save(t / "p.npy", render_from_master(fcc, e, geom))
    qf, qh = (np.roll(R.random(4, random_state=s).as_quat(), 1, axis=1) for s in (6, 7))
    np.save(t / "mixed.npy", np.concatenate([render_from_master(fcc, qf, geom),
                                             render_from_master(hcp, qh, geom)]))
    return t


def test_sphere_single_phase_matches_jax(files, tmp_path, monkeypatch, capsys):
    out = {}
    for side in ("port", "jax"):
        argv = ["sphere", "--patterns", str(files / "p.npy"), "--master", str(files / "fcc.npy"),
                "--out", str(tmp_path / f"{side}.npy"), "--ang", str(tmp_path / f"{side}.ang"),
                "--ambiguity", str(tmp_path / f"{side}_amb.npz"), "--scan-grid", "2", "5"] + SPHERE
        out[side] = _run(side, argv, monkeypatch, capsys)
    ps, js = out["port"], out["jax"]
    for key in ("n_patterns", "n_phases", "bandwidth", "kept_degrees", "ambiguous_frac"):
        assert ps[key] == js[key], key
    assert abs(ps["mean_score"] - js["mean_score"]) <= 1e-4
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == (10, 3) and _mis_deg(got, want).max() < NEWTON_DEG
    pd, jd = np.load(tmp_path / "port_detail.npz"), np.load(tmp_path / "jax_detail.npz")
    assert set(pd.files) == set(jd.files)
    np.testing.assert_allclose(pd["scores"], jd["scores"], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(pd["phase"], jd["phase"])
    pa, ja = read_ang(str(tmp_path / "port.ang")), read_ang(str(tmp_path / "jax.ang"))
    assert pa.grid == ja.grid == (2, 5)
    np.testing.assert_array_equal(pa.success, ja.success)
    np.testing.assert_array_equal(pa.phase, ja.phase)
    pm, jm = np.load(tmp_path / "port_amb.npz"), np.load(tmp_path / "jax_amb.npz")
    np.testing.assert_array_equal(pm["has_rival"], jm["has_rival"])
    np.testing.assert_allclose(pm["score_gap"], jm["score_gap"], atol=SCORE_ATOL, rtol=0)


def test_sphere_multiphase_matches_jax(files, tmp_path, monkeypatch, capsys):
    out = {}
    for side in ("port", "jax"):
        argv = ["sphere", "--patterns", str(files / "mixed.npy"), "--master",
                str(files / "fcc.npy"), "--master", str(files / "hcp.npy"), "--group", "432",
                "--group", "622", "--phase-name", "Ni", "--phase-name", "Ti", "--no-refine",
                "--out", str(tmp_path / f"{side}.npy"),
                "--ctf", str(tmp_path / f"{side}.ctf")] + SPHERE
        out[side] = _run(side, argv, monkeypatch, capsys)
    ps, js = out["port"], out["jax"]
    assert ps["phase_counts"] == js["phase_counts"] and ps["kept_degrees"] == js["kept_degrees"]
    pd, jd = np.load(tmp_path / "port_detail.npz"), np.load(tmp_path / "jax_detail.npz")
    np.testing.assert_array_equal(pd["phase"], jd["phase"])
    np.testing.assert_allclose(pd["phase_scores"], jd["phase_scores"], atol=SCORE_ATOL, rtol=0)
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    for pid, group in enumerate(("432", "622")):
        m = pd["phase"] == pid
        assert _mis_deg(got[m], want[m], group).max(initial=0.0) < ORIENT_DEG
    pc, jc = read_ctf(str(tmp_path / "port.ctf")), read_ctf(str(tmp_path / "jax.ctf"))
    np.testing.assert_array_equal(pc.phase, jc.phase)
    with pytest.raises(SystemExit, match="--group given 3 times"):
        _run("port", ["sphere", "--patterns", str(files / "mixed.npy"), "--master",
                      str(files / "fcc.npy"), "--master", str(files / "hcp.npy")]
             + ["--group", "432"] * 3 + SPHERE, monkeypatch, capsys)


@pytest.mark.parametrize("layout", ["circle", "square"])
def test_simulate_master_fit_bands_matches_jax(files, tmp_path, monkeypatch, capsys, layout):
    master = str(files / "fcc.npy")
    if layout == "square":  # any square image will do: the import resamples it
        master = str(tmp_path / "sq.npy")
        np.save(master, np.load(files / "fcc.npy")[::2, ::2])
    out = {}
    for side in ("port", "jax"):
        argv = ["simulate", "--angles", str(files / "a.txt"), "--master", master,
                "--master-layout", layout, "--fit-bands", "--size", "64", "--max-hkl", "3",
                "--out", str(tmp_path / f"{side}.npy")]
        out[side] = _run(side, argv, monkeypatch, capsys)
    ps, js = out["port"], out["jax"]
    for key in ("n_patterns", "shape", "fit_ncc", "n_fitted_bands", "refine_provenance"):
        assert ps[key] == js[key], key
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"),
                               atol=RENDER_ATOL, rtol=0)
    pm = json.loads((tmp_path / "port.npy.simmeta.json").read_text())
    jm = json.loads((tmp_path / "jax.npy.simmeta.json").read_text())
    assert pm["kind"] == jm["kind"] == "master_fit" and pm["fit_source"] == "cli_args"
    for key in ("normals", "sin_theta"):
        np.testing.assert_array_equal(pm["fitted_bands"][key], jm["fitted_bands"][key])
    np.testing.assert_allclose(pm["fitted_bands"]["intensity"], jm["fitted_bands"]["intensity"],
                               atol=1e-6)


def test_simulate_master_uint8_without_fit(files, tmp_path, monkeypatch, capsys):
    """No --fit-bands and no .mastermeta.json: patterns only, no sidecar."""
    argv = ["simulate", "--angles", str(files / "a.txt"), "--master", str(files / "fcc.npy"),
            "--size", "64", "--uint8", "--out", str(tmp_path / "u8")]
    summary = _run("port", argv, monkeypatch, capsys)
    assert "refine_provenance" not in summary and summary["shape"] == [64, 64]
    pats = np.load(tmp_path / "u8.npy")
    assert pats.dtype == np.uint8 and not (tmp_path / "u8.npy.simmeta.json").exists()


def test_master_fit_dictionary_refines(files, tmp_path, monkeypatch, capsys):
    """``simulate --master --fit-bands`` → ``build`` → ``query --refine``:
    the query rebuilds the fitted band model from the npz's provenance."""
    small = ["--inplanes", "2", "--latent-dim", "8", "--batch-size", "16"]
    _run("port", ["simulate", "--angles", str(files / "a.txt"), "--master",
                  str(files / "fcc.npy"), "--fit-bands", "--out", str(tmp_path / "d.npy")],
         monkeypatch, capsys)
    _run("port", ["build", "--patterns", str(tmp_path / "d.npy"), "--angles",
                  str(files / "a.txt"), "--db", str(tmp_path / "db.npz")] + small,
         monkeypatch, capsys)
    summary = _run("port", ["query", "--patterns", str(tmp_path / "d.npy"), "--db",
                            str(tmp_path / "db.npz"), "--out", str(tmp_path / "o.npy"),
                            "--refine", "3", "--top-n", "2", "--min-matches", "1"] + small,
                   monkeypatch, capsys)
    assert summary["refine_steps"] == 3 and summary["refine_ncc_median"] > 0.5


def test_learn_master_matches_jax(files, tmp_path, monkeypatch, capsys):
    out = {}
    for side in ("port", "jax"):
        argv = ["learn-master", "--patterns", str(files / "p.npy"), "--angles",
                str(files / "a.txt"), "--size", "65", "--out", str(tmp_path / f"{side}.npy")]
        out[side] = _run(side, argv, monkeypatch, capsys)
    assert out["port"]["coverage"] == out["jax"]["coverage"] > 0.5
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"),
                               atol=1e-6, rtol=0)


def test_dynamical_master_waits_for_a_later_slice(tmp_path, monkeypatch, capsys):
    """``master``, once refused here, runs: its master feeds ``simulate
    --master`` as JAX's does (tests/test_torch_master_cli.py holds the
    command itself)."""
    out = {}
    for side in ("port", "jax"):
        path = str(tmp_path / f"{side}.npy")
        out[side] = _run(side, ["master", "--out", path, "--structure", "fcc", "--size", "17",
                                "--beams", "15", "--max-hkl", "2"], monkeypatch, capsys)
        assert out[side]["out"] == path and out[side]["n_beams"] == 15
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"),
                               rtol=0, atol=1e-4)
