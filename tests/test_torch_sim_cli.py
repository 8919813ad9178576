"""``python -m latice_tpu_torch.cli.index sample/simulate/di`` and ``query
--nlpar/--refine`` against the JAX package's ``index.py`` on the same
arguments and files, on the CPU.

* sample: the anglefile byte-equal and the same summary;
* simulate: float32 patterns within 1e-5, uint8 within 1 level in at most
  0.1% of pixels (`test_torch_sim.py`'s limits), the same sidecar;
* di: orientations and ``.ang`` within 1e-3 degrees (float32 Euler
  round trips), resident, streamed and multi-phase, with the same summary;
* query --nlpar --scan-grid and query --refine 5 --refine-candidates 2 at
  inplanes 2, from the same weights (an orbax checkpoint for JAX, the same
  values as a ``.pt`` for the port; both CLIs run their model in bf16):
  orientations within 1e-3 degrees, the same refine summary within 1e-3.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.cli import index as jax_cli
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.train.checkpoint import save_params
from latice_tpu_torch.cli import index as port_cli
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.data import read_ang
from latice_tpu_torch.models import flax_params_to_state_dict

ORIENT_DEG = 1e-3
SMALL = ["--inplanes", "2", "--latent-dim", "8", "--batch-size", "16"]
SIM = ["--max-hkl", "2", "--min-d", "1.0"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _run(side, argv, monkeypatch, capsys):
    """One command through either CLI; the port's on the CPU. Returns its
    JSON summary line (None for ``build``, which prints none)."""
    if side == "jax":
        monkeypatch.setattr(sys, "argv", ["index.py"] + argv)
        jax_cli.main()
    else:
        port_cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip()
    return None if argv[0] == "build" else json.loads(out.splitlines()[-1])


def _mis_deg(a, b):
    qa, qb = (from_euler_zxz_deg(torch.from_numpy(np.asarray(x, np.float64))) for x in (a, b))
    return np.rad2deg(misorientation_angle(qa, qb).numpy())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 16-degree cubic grid (36 orientations) and its fcc patterns from
    the JAX CLI, float32 and uint8, and a seeded inplanes-2 model saved for
    both CLIs."""
    t = tmp_path_factory.mktemp("simcli")
    mp = pytest.MonkeyPatch()
    for argv in (["sample", "--group", "432", "--resolution", "16", "--out", str(t / "fz.txt")],
                 ["simulate", "--angles", str(t / "fz.txt"), "--out", str(t / "d.npy")] + SIM,
                 ["simulate", "--angles", str(t / "fz.txt"), "--out", str(t / "d8.npy"),
                  "--uint8"] + SIM):
        mp.setattr(sys, "argv", ["index.py"] + argv)
        jax_cli.main()
    mp.undo()
    params = JaxVAE(inplanes=2, latent_dim=8).init(
        {"params": jax.random.key(3)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(4)
    )["params"]
    save_params(t / "ckpt", params)
    torch.save(flax_params_to_state_dict(jax.tree.map(np.asarray, params), 2, 8), t / "vae.pt")
    return t


def test_sample_matches_jax(files, tmp_path, monkeypatch, capsys):
    out = {}
    for side in ("jax", "port"):
        path = tmp_path / f"{side}.txt"
        out[side] = _run(side, ["sample", "--group", "622", "--resolution", "12", "--out",
                                str(path)], monkeypatch, capsys)
        out[side]["out"] = None
    assert out["port"] == out["jax"] and out["port"]["n_orientations"] > 30
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("uint8", [False, True], ids=["float32", "uint8"])
def test_simulate_matches_jax(files, tmp_path, monkeypatch, capsys, uint8):
    extra = ["--uint8"] if uint8 else []
    summaries = {}
    for side in ("jax", "port"):
        summaries[side] = _run(side, ["simulate", "--angles", str(files / "fz.txt"), "--out",
                                      str(tmp_path / f"{side}"), "--tilt", "4", "--pc", "0.48",
                                      "0.52", "0.66"] + SIM + extra, monkeypatch, capsys)
        summaries[side].pop("seconds")
        summaries[side].pop("out")
    assert summaries["port"] == summaries["jax"]
    got, want = (np.load(tmp_path / f"{side}.npy") for side in ("port", "jax"))
    assert got.shape == want.shape == (36, 128, 128) and got.dtype == want.dtype
    if uint8:
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    meta = [json.loads((tmp_path / f"{side}.npy.simmeta.json").read_text())
            for side in ("port", "jax")]
    assert meta[0] == meta[1]


@pytest.mark.parametrize(
    "flags",
    [[], ["--streamed"], ["--search-dtype", "float32", "--weight-power", "4", "--bin", "2"],
     ["--phase-groups", "432,432"]],
    ids=["resident", "streamed", "f32-weighted-binned", "multiphase"],
)
def test_di_matches_jax(files, tmp_path, monkeypatch, capsys, flags):
    t = files
    rng = np.random.default_rng(1)
    scan = np.load(t / "d8.npy").astype(np.float32) / 255.0
    np.save(tmp_path / "scan.npy",
            (scan + rng.normal(size=scan.shape) * 0.05).astype(np.float32))
    dictionary = ["--dict-patterns", str(t / "d8.npy"), "--dict-angles", str(t / "fz.txt")]
    if "--phase-groups" in flags:  # the float32 stack as a second phase
        dictionary += ["--dict-patterns", str(t / "d.npy"), "--dict-angles", str(t / "fz.txt")]
    summaries = {}
    for side in ("jax", "port"):
        summaries[side] = _run(
            side, ["di", *dictionary, "--patterns", str(tmp_path / "scan.npy"),
                   "--out", str(tmp_path / f"{side}.npy"), "--top-n", "4", "--min-matches", "1",
                   "--ang", str(tmp_path / f"{side}.ang"), "--scan-grid", "6", "6"] + flags,
            monkeypatch, capsys)
    js, ps = summaries["jax"], summaries["port"]
    assert set(ps) == set(js)
    for key in ("n_patterns", "n_dictionary", "success_rate", "phase_counts"):
        assert ps.get(key) == js.get(key), key
    assert abs(ps["mean_top_ncc"] - js["mean_top_ncc"]) <= 2e-4
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == (36, 3)
    assert _mis_deg(got, want).max() < ORIENT_DEG
    a, b = read_ang(str(tmp_path / "port.ang")), read_ang(str(tmp_path / "jax.ang"))
    assert _mis_deg(a.eulers, b.eulers).max() < ORIENT_DEG
    np.testing.assert_array_equal(a.phase, b.phase)
    assert a.grid == b.grid == (6, 6)
    if "--phase-groups" in flags:
        np.testing.assert_array_equal(np.load(tmp_path / "port_phase.npy"),
                                      np.load(tmp_path / "jax_phase.npy"))


def _build_both(files, tmp_path, patterns, monkeypatch, capsys):
    for side in ("jax", "port"):
        ckpt = str(files / ("ckpt" if side == "jax" else "vae.pt"))
        _run(side, ["build", "--patterns", str(patterns), "--angles", str(files / "fz.txt"),
                    "--db", str(tmp_path / f"{side}.npz"), "--checkpoint", ckpt] + SMALL,
             monkeypatch, capsys)


def _query_both(files, tmp_path, scan, flags, monkeypatch, capsys):
    out = {}
    for side in ("jax", "port"):
        ckpt = str(files / ("ckpt" if side == "jax" else "vae.pt"))
        out[side] = _run(side, ["query", "--patterns", str(scan), "--db",
                                str(tmp_path / f"{side}.npz"), "--out",
                                str(tmp_path / f"{side}_o.npy"), "--top-n", "3",
                                "--min-matches", "1", "--checkpoint", ckpt] + SMALL + flags,
                         monkeypatch, capsys)
    got, want = np.load(tmp_path / "port_o.npy"), np.load(tmp_path / "jax_o.npy")
    return out["port"], out["jax"], got, want


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_query_nlpar_matches_jax(files, tmp_path, monkeypatch, capsys, dtype):
    """A dictionary of 36 distinct random images; a 6x6 scan of four 3x3
    grains, each grain the noisy copies of one dictionary row. NLPAR
    averages within each grain, and every top-1 is the grain's row on both
    sides (random images leave no near ties for the bf16 models)."""
    rng = np.random.default_rng(2)
    dictionary = rng.uniform(size=(36, 128, 128)).astype(np.float32)
    np.save(tmp_path / "dict.npy", dictionary)
    _build_both(files, tmp_path, tmp_path / "dict.npy", monkeypatch, capsys)
    grain = (np.arange(6)[:, None] // 3) * 2 + np.arange(6)[None, :] // 3  # (6, 6) row ids
    scan = dictionary[grain.ravel()] + rng.normal(size=(36, 128, 128)) * 0.01
    scan = np.clip(scan, 0, 1)
    scan = np.round(scan * 255).astype(np.uint8) if dtype == "uint8" else scan.astype(np.float32)
    np.save(tmp_path / "scan.npy", scan)
    ps, js, got, want = _query_both(
        files, tmp_path, tmp_path / "scan.npy",
        ["--nlpar", "2.0", "--nlpar-radius", "1", "--scan-grid", "6", "6"], monkeypatch, capsys)
    assert ps["input_dtype"] == js["input_dtype"] == "float32"
    assert ps["n_patterns"] == js["n_patterns"] == 36
    assert _mis_deg(got, want).max() < ORIENT_DEG
    own = np.loadtxt(files / "fz.txt", skiprows=2)[grain.ravel()]
    assert _mis_deg(got, own).max() < ORIENT_DEG


def test_query_refine_matches_jax(files, tmp_path, monkeypatch, capsys):
    """The dictionary holds patterns rendered 1 degree off the grid points
    but lists the grid points' angles, and the queries are those patterns:
    each top-1 is its own row on both sides (a random inplanes-2 encoder
    cannot rank other simulated patterns reliably), the refinement starts 1
    degree off the truth, where its gradient stands far above roundoff, and
    the second candidate, another grid point, never wins."""
    rng = np.random.default_rng(3)
    grid = R.from_euler("zxz", np.loadtxt(files / "fz.txt", skiprows=2), degrees=True)
    axes = rng.normal(size=(36, 3))
    truth = R.from_rotvec(np.radians(1.0) * axes / np.linalg.norm(axes, axis=1)[:, None]) * grid
    (tmp_path / "truth.txt").write_text(
        "eu\n36\n" + "".join(f"{a:.6f} {b:.6f} {c:.6f}\n"
                             for a, b, c in truth.as_euler("zxz", degrees=True)))
    scan = tmp_path / "scan.npy"  # simulate writes the provenance sidecar beside it
    _run("jax", ["simulate", "--angles", str(tmp_path / "truth.txt"), "--out", str(scan)] + SIM,
         monkeypatch, capsys)
    _build_both(files, tmp_path, scan, monkeypatch, capsys)
    ps, js, got, want = _query_both(files, tmp_path, scan,
                                    ["--refine", "5", "--refine-candidates", "2"],
                                    monkeypatch, capsys)
    assert ps["refine_steps"] == js["refine_steps"] == 5
    assert ps["refine_reranked_frac"] == js["refine_reranked_frac"] == 0.0
    assert abs(ps["refine_ncc_median"] - js["refine_ncc_median"]) <= 1e-3
    assert _mis_deg(got, want).max() < ORIENT_DEG
    before = _mis_deg(np.loadtxt(files / "fz.txt", skiprows=2), truth.as_euler("zxz", True))
    after = _mis_deg(got, truth.as_euler("zxz", degrees=True))
    assert (after < before).all()  # five steps toward the truth
    # Without candidates: the result itself is refined, the same on both sides.
    ps, js, got, want = _query_both(files, tmp_path, scan, ["--refine", "5"], monkeypatch,
                                    capsys)
    assert "refine_reranked_frac" not in ps and "refine_reranked_frac" not in js
    assert _mis_deg(got, want).max() < ORIENT_DEG


def test_nlpar_and_refine_refusals(files, tmp_path, capsys):
    base = ["query", "--patterns", str(files / "d.npy"), "--db", str(tmp_path / "db.npz"),
            "--device", "cpu"] + SMALL
    port_cli.main(["build", "--patterns", str(files / "d.npy"), "--angles",
                   str(files / "fz.txt"), "--db", str(tmp_path / "db.npz"), "--device",
                   "cpu"] + SMALL)
    with pytest.raises(SystemExit, match="scan-grid"):
        port_cli.main(base + ["--nlpar", "1.0"])
    with pytest.raises(SystemExit, match="does not match"):
        port_cli.main(base + ["--nlpar", "1.0", "--scan-grid", "5", "5"])
    np.save(tmp_path / "plain.npy", np.load(files / "d.npy"))  # no sidecar: no provenance
    port_cli.main(["build", "--patterns", str(tmp_path / "plain.npy"), "--angles",
                   str(files / "fz.txt"), "--db", str(tmp_path / "plain.npz"),
                   "--device", "cpu"] + SMALL)
    with pytest.raises(SystemExit, match="simulation provenance"):
        port_cli.main(["query", "--patterns", str(files / "d.npy"), "--db",
                       str(tmp_path / "plain.npz"), "--refine", "5", "--device", "cpu"] + SMALL)
    capsys.readouterr()
