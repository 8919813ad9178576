"""``python -m latice_tpu_torch.cli.index quality/hough/calibrate`` and
``query --hough-iq`` against the JAX package's ``index.py`` on the same
arguments and files, on the CPU.

* quality: the IQ map, band counts and thetas as `test_torch_hough.py`
  holds the detector (strengths and IQ within 1e-5); ``--iq-map`` writes
  the PNG, and without matplotlib exits naming it.
* hough: single-phase with ``--ang --refine 3``, multi-phase (fcc + hcp)
  with ``--ctf``: orientations and the ``.ang`` angles within `ORIENT_DEG`
  of JAX's (refinement from the same starts, `test_torch_refine.py`'s
  1e-4 degrees, plus f32 Euler round trips), the same success, matched
  counts, phases and summary counts; the ``.ang`` IQ column is the Hough
  IQ to its 3 decimals.
* query --hough-iq: ``<out>_iq.npy`` (within 1e-5), the ``.ang`` IQ (to
  its 3 decimals) and the ``.ctf`` band counts are the JAX quality
  command's on the same frames (both run the detector at its defaults).
* calibrate: shared (from Euler ``.npy``) and affine (``--scan-grid``)
  fits, pinned, PCs and gradients within 1e-5 of JAX's.

The quality and hough commands pad frames to 128x128, so each builds the
full-width Radon matrix (~4 s per command here).
"""

import json
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.cli import index as jax_cli
from latice_tpu.crystal import ROTATION_GROUPS
from latice_tpu.sim import DetectorGeometry, cubic_reflectors, hexagonal_reflectors
from latice_tpu.sim import simulate_patterns
from latice_tpu_torch.cli import index as port_cli
from latice_tpu_torch.data import read_ang

ORIENT_DEG = 1e-3
IQ_ATOL = 1e-5
ANG_IQ_ATOL = 5e-4  # the .ang IQ column carries 3 decimals
SIM = ["--max-hkl", "2", "--min-d", "1.0"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _run(side, argv, monkeypatch, capsys):
    """One command through either CLI, the port's on the CPU; its JSON
    summary line."""
    if side == "jax":
        monkeypatch.setattr(sys, "argv", ["index.py"] + argv)
        jax_cli.main()
    else:
        port_cli.main(argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _mis_deg(a, b, group="432"):
    sym = R.from_quat(np.roll(ROTATION_GROUPS[group], -1, axis=1))
    ra, rb = (R.from_euler("zxz", e, degrees=True) for e in (a, b))
    return np.array([np.degrees(min(((x * s).inv() * y).magnitude() for s in sym))
                     for x, y in zip(ra, rb)])


def _ang_iq(path):
    return np.loadtxt(path, comments="#")[:, 5]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """8 fcc renders at 128x128 (uint8, as a detector writes them), 6 fcc +
    6 hcp renders, and a 3x4 scan of 64x64 renders under an affine PC."""
    t = tmp_path_factory.mktemp("bandcli")
    fcc = cubic_reflectors("fcc", max_hkl=2, min_d=1.0)
    q = np.roll(R.random(8, random_state=1).as_quat(), 1, axis=1)
    np.save(t / "fcc.npy", np.round(simulate_patterns(q, reflectors=fcc) * 255).astype(np.uint8))
    hcp = hexagonal_reflectors(a=2.95, c=4.68, max_hkl=2, min_d=1.0)
    qf = np.roll(R.random(6, random_state=2).as_quat(), 1, axis=1)
    qh = np.roll(R.random(6, random_state=3).as_quat(), 1, axis=1)
    np.save(t / "mixed.npy", np.concatenate([simulate_patterns(qf, reflectors=fcc),
                                             simulate_patterns(qh, reflectors=hcp)]))
    pc0 = np.array([0.52, 0.47, 0.68])
    g = np.array([[-0.01, 0.0], [0.0, 0.01], [0.0, 0.005]])  # per scan step
    tq = np.roll(R.random(12, random_state=4).as_quat(), 1, axis=1).astype(np.float32)
    rr, cc = np.divmod(np.arange(12), 4)
    pats = [simulate_patterns(tq[i:i + 1], DetectorGeometry(shape=(64, 64),
                              **dict(zip(("pcx", "pcy", "dd"), pc0 + g @ (cc[i], rr[i])))),
                              fcc)[0] for i in range(12)]
    np.save(t / "scan.npy", np.stack(pats))
    np.save(t / "quats.npy", tq)
    np.save(t / "eulers.npy", R.from_quat(np.roll(tq, -1, axis=1)).as_euler("zxz", degrees=True))
    return t


@pytest.fixture(scope="module")
def quality(files):
    """The quality command of both CLIs over the fcc renders as a 2x4 scan."""
    mp = pytest.MonkeyPatch()
    out = {}
    for side in ("jax", "port"):
        argv = ["quality", "--patterns", str(files / "fcc.npy"), "--scan-grid", "2", "4",
                "--out-prefix", str(files / f"q_{side}"), "--batch-size", "4",
                "--iq-map", str(files / f"q_{side}.png")]
        if side == "jax":
            mp.setattr(sys, "argv", ["index.py"] + argv)
            jax_cli.main()
        else:
            port_cli.main(argv + ["--device", "cpu"])
    mp.undo()
    for side in ("jax", "port"):
        out[side] = (np.load(files / f"q_{side}_iq.npy"), dict(np.load(files / f"q_{side}_bands.npz")))
    return out


def test_quality_matches_jax(files, quality):
    (iq, bands), (jiq, jbands) = quality["port"], quality["jax"]
    assert iq.shape == (2, 4)
    np.testing.assert_allclose(iq, jiq, atol=IQ_ATOL, rtol=0)
    np.testing.assert_array_equal(bands["band_count"], jbands["band_count"])
    np.testing.assert_array_equal(bands["theta_deg"], jbands["theta_deg"])
    np.testing.assert_allclose(bands["strength"], jbands["strength"], atol=IQ_ATOL, rtol=0)
    assert bands["theta_deg"].shape == (8, 10)
    assert (files / "q_port.png").stat().st_size > 0


def test_iq_map_without_matplotlib(files, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib.image", None)  # import raises
    with pytest.raises(SystemExit, match="matplotlib"):
        port_cli.main(["quality", "--patterns", str(files / "fcc.npy"), "--scan-grid", "2", "4",
                       "--out-prefix", str(files / "nompl"), "--iq-map",
                       str(files / "nompl.png"), "--device", "cpu"])
    assert not (files / "nompl.png").exists()
    with pytest.raises(SystemExit, match="--scan-grid"):
        port_cli.main(["quality", "--patterns", str(files / "fcc.npy"), "--out-prefix",
                       str(files / "nogrid"), "--iq-map", "x.png", "--device", "cpu"])


def test_hough_single_phase_matches_jax(files, monkeypatch, capsys):
    summaries = {}
    for side in ("jax", "port"):
        summaries[side] = _run(side, [
            "hough", "--patterns", str(files / "fcc.npy"), "--out", str(files / f"h_{side}.npy"),
            "--grid-resolution", "5", "--tolerance", "4", "--batch-size", "8",
            "--ang", str(files / f"h_{side}.ang"), "--scan-grid", "2", "4", "--refine", "3",
        ] + SIM, monkeypatch, capsys)
    ps, js = summaries["port"], summaries["jax"]
    assert set(ps) == set(js)
    for key in ("n_patterns", "success_rate", "mean_bands_matched", "refine_steps"):
        assert ps[key] == js[key], key
    assert abs(ps["mean_fit_deg"] - js["mean_fit_deg"]) <= 2e-3
    assert abs(ps["refine_ncc_median"] - js["refine_ncc_median"]) <= 2e-4
    got, want = np.load(files / "h_port.npy"), np.load(files / "h_jax.npy")
    assert got.shape == (8, 3) and _mis_deg(got, want).max() < ORIENT_DEG
    d, jd = (dict(np.load(files / f"h_{s}_detail.npz")) for s in ("port", "jax"))
    assert set(d) == set(jd)
    for key in ("success", "n_matched"):
        np.testing.assert_array_equal(d[key], jd[key])
    np.testing.assert_allclose(d["iq"], jd["iq"], atol=IQ_ATOL, rtol=0)
    a, b = (read_ang(str(files / f"h_{s}.ang")) for s in ("port", "jax"))
    assert a.grid == b.grid == (2, 4)
    assert _mis_deg(a.eulers, b.eulers).max() < ORIENT_DEG
    np.testing.assert_allclose(_ang_iq(files / "h_port.ang"), d["iq"], atol=ANG_IQ_ATOL)


def test_hough_multiphase_matches_jax(files, monkeypatch, capsys):
    summaries = {}
    for side in ("jax", "port"):
        summaries[side] = _run(side, [
            "hough", "--patterns", str(files / "mixed.npy"), "--out",
            str(files / f"m_{side}.npy"), "--phase", "ni=fcc:3.52", "--phase",
            "ti=hcp:2.95:4.68", "--grid-resolution", "5", "--tolerance", "4", "--bands", "10",
            "--batch-size", "8", "--ctf", str(files / f"m_{side}.ctf"),
        ] + SIM, monkeypatch, capsys)
    ps, js = summaries["port"], summaries["jax"]
    for key in ("n_patterns", "success_rate", "phase_names", "phase_counts"):
        assert ps[key] == js[key], key
    assert ps["phase_counts"] == [6, 6]
    phase = np.load(files / "m_port_phase.npy")
    np.testing.assert_array_equal(phase, np.load(files / "m_jax_phase.npy"))
    got, want = np.load(files / "m_port.npy"), np.load(files / "m_jax.npy")
    for pid, group in ((0, "432"), (1, "622")):
        m = phase == pid
        assert _mis_deg(got[m], want[m], group).max() < ORIENT_DEG
    ctf, jctf = (np.loadtxt(files / f"m_{s}.ctf", skiprows=_ctf_header(files / f"m_{s}.ctf"))
                 for s in ("port", "jax"))
    np.testing.assert_array_equal(ctf[:, 0], jctf[:, 0])  # the phase column


def _ctf_header(path) -> int:
    lines = path.read_text().splitlines()
    return next(i for i, s in enumerate(lines) if s.startswith("Phase\t")) + 1


def test_query_hough_iq_matches_jax_quality(files, quality, monkeypatch, capsys, tmp_path):
    """The port's query --hough-iq measures the Hough IQ of the raw frames:
    the JAX quality command's IQ on the same file."""
    angles = tmp_path / "a.txt"
    angles.write_text("eu\n8\n" + "".join(f"{5 * i} {10 * i} {15 * i}\n" for i in range(8)))
    small = ["--inplanes", "2", "--latent-dim", "4", "--batch-size", "8", "--device", "cpu"]
    db = str(tmp_path / "db.npz")
    with torch.random.fork_rng(devices=[]):
        port_cli.main(["build", "--patterns", str(files / "fcc.npy"), "--angles", str(angles),
                       "--db", db] + small)
        port_cli.main(["query", "--patterns", str(files / "fcc.npy"), "--db", db, "--out",
                       str(tmp_path / "o.npy"), "--top-n", "2", "--min-matches", "1",
                       "--hough-iq", "--ang", str(tmp_path / "o.ang"), "--ctf",
                       str(tmp_path / "o.ctf"), "--scan-grid", "2", "4"] + small)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jiq, jbands = quality["jax"]
    iq = np.load(tmp_path / "o_iq.npy")
    assert summary["hough_iq_out"] == str(tmp_path / "o_iq.npy")
    np.testing.assert_allclose(iq, jiq.ravel(), atol=IQ_ATOL, rtol=0)
    assert abs(summary["mean_iq"] - round(float(jiq.mean()), 4)) <= 1e-4
    np.testing.assert_allclose(_ang_iq(tmp_path / "o.ang"), iq, atol=ANG_IQ_ATOL)
    ctf = np.loadtxt(tmp_path / "o.ctf", skiprows=_ctf_header(tmp_path / "o.ctf"))
    np.testing.assert_array_equal(ctf[:, 3], jbands["band_count"])


@pytest.mark.parametrize("model", ["shared", "affine"])
def test_calibrate_matches_jax(files, monkeypatch, capsys, model):
    extra = (["--orientations", str(files / "eulers.npy"), "--steps", "60"] if model == "shared"
             else ["--orientations", str(files / "quats.npy"), "--scan-grid", "3", "4",
                   "--steps", "150"])
    summaries = {}
    for side in ("jax", "port"):
        summaries[side] = _run(side, ["calibrate", "--patterns", str(files / "scan.npy"),
                                      "--out", str(files / f"c_{side}.npz"), "--pin"]
                               + extra + SIM, monkeypatch, capsys)
    ps, js = summaries["port"], summaries["jax"]
    assert ps["model"] == js["model"] == model and ps["n_used"] == js["n_used"] == 12
    assert abs(ps["mean_ncc"] - js["mean_ncc"]) <= 1e-4
    got, want = (dict(np.load(files / f"c_{s}.npz")) for s in ("port", "jax"))
    assert set(got) == set(want)
    for key in ("pc", "pc0", "gradient"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["pattern_indices"], want["pattern_indices"])
    with pytest.raises(SystemExit, match="does not hold"):
        port_cli.main(["calibrate", "--patterns", str(files / "scan.npy"), "--orientations",
                       str(files / "quats.npy"), "--scan-grid", "5", "5", "--device", "cpu"])


def test_strain_waits_for_a_later_slice(files, capsys):
    """Once refused, ``strain`` now runs (tests/test_torch_strain_cli.py
    holds it against JAX): on the fcc renders against the first, every
    pattern's quality is finite and the reference's own shift is zero."""
    t = files
    port_cli.main(["strain", "--patterns", str(t / "fcc.npy"), "--ref", "0", "--remap", "0",
                   "--out", str(t / "strain.npz"), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = np.load(t / "strain.npz")
    assert summary["n_patterns"] == len(out["a"]) and summary["ref_index"] == 0
    assert np.all(np.isfinite(out["quality"])) and np.abs(out["shifts_px"][0]).max() < 1e-3
