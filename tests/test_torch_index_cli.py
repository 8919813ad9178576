"""``python -m latice_tpu_torch.cli.index build/export/query`` against the
JAX package's ``index.py`` on the same files and weights.

The JAX CLI reads an orbax checkpoint (`latice_tpu.train.checkpoint.
save_params`), the port a ``.pt`` of the same weights
(`flax_params_to_state_dict`). Both run their model in bf16 (the JAX CLI
builds it with ``dtype=bfloat16``, the port at ``16-mixed``), so dictionary
vectors agree within bf16 tolerance, 3e-2. The queries are the dictionary's
own patterns, distinct random images, so every top-1 is the query's own row
on both sides and the orientations agree to float32 roundoff of the Euler
conversion.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.cli import index as jax_cli
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.train.checkpoint import save_params
from latice_tpu_torch.cli import index as port_cli
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.data import read_ang, read_ctf
from latice_tpu_torch.models import flax_params_to_state_dict

N = 24
SMALL = ["--inplanes", "2", "--latent-dim", "8", "--batch-size", "16"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. The port's CLI
    builds its model inside the library (its constructor's default init
    draws from the global RNG before the checkpoint or the seeded weights
    replace it), and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    np.save(tmp / "dict.npy", rng.uniform(size=(N, 128, 128)).astype(np.float32))
    angles = rng.uniform([0, 20, 0], [340, 140, 340], size=(N, 3))
    (tmp / "dict.txt").write_text(f"eu\n{N}\n" + "".join(f"{a[0]} {a[1]} {a[2]}\n" for a in angles))
    params = JaxVAE(inplanes=2, latent_dim=8).init(
        {"params": jax.random.key(3)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(4)
    )["params"]
    save_params(tmp / "ckpt", params)
    sd = flax_params_to_state_dict(jax.tree.map(np.asarray, params), 2, 8)
    torch.save(sd, tmp / "vae.pt")
    return tmp


def _run_jax(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["index.py"] + argv)
    jax_cli.main()
    return capsys.readouterr().out


def _run_port(argv, capsys):
    port_cli.main(argv)
    return capsys.readouterr().out


def _summary(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_build_export_query_match_jax(files, monkeypatch, capsys):
    t = files
    for side in ("jax", "port"):
        ckpt = ["--checkpoint", str(t / ("ckpt" if side == "jax" else "vae.pt"))]
        extra = ckpt + SMALL + (["--device", "cpu"] if side == "port" else [])
        run = (lambda a: _run_jax(a, monkeypatch, capsys)) if side == "jax" else (
            lambda a: _run_port(a, capsys))
        run(["build", "--patterns", str(t / "dict.npy"), "--angles", str(t / "dict.txt"),
             "--db", str(t / f"{side}.npz")] + extra)
        run(["export", "--patterns", str(t / "dict.npy"), "--angles", str(t / "dict.txt"),
             "--latents-out", str(t / f"{side}_lat.npy"),
             "--angles-out", str(t / f"{side}_ang.npy")] + extra)
        out = run(["query", "--patterns", str(t / "dict.npy"), "--db", str(t / f"{side}.npz"),
                   "--out", str(t / f"{side}_o.npy"), "--top-n", "5", "--min-matches", "1",
                   "--engine", "fused", "--ang", str(t / f"{side}.ang"),
                   "--ctf", str(t / f"{side}.ctf"), "--scan-grid", "4", "6",
                   "--ambiguity", str(t / f"{side}_amb.npz"), "--ambiguity-gap", "0.5"]
                  + extra)
        (t / f"{side}.json").write_text(json.dumps(_summary(out)))

    jdb, pdb = np.load(t / "jax.npz"), np.load(t / "port.npz")
    assert sorted(pdb.files) == sorted(jdb.files)
    np.testing.assert_allclose(pdb["vectors"], jdb["vectors"], atol=3e-2)
    np.testing.assert_array_equal(pdb["orientations"], jdb["orientations"])
    # Raw latents: the same bf16 tolerance, relative to each row's norm (the
    # stored vectors above are these rows normalized).
    got_lat, want_lat = np.load(t / "port_lat.npy"), np.load(t / "jax_lat.npy")
    scale = np.linalg.norm(want_lat, axis=1, keepdims=True)
    assert np.all(np.abs(got_lat - want_lat) <= 3e-2 * scale)
    np.testing.assert_array_equal(np.load(t / "port_ang.npy"), np.load(t / "jax_ang.npy"))

    js, ps = (json.loads((t / f"{s}.json").read_text()) for s in ("jax", "port"))
    assert set(ps) == set(js)
    for key in ("n_patterns", "success_rate", "input_dtype"):
        assert ps[key] == js[key]
    got, want = np.load(t / "port_o.npy"), np.load(t / "jax_o.npy")
    mis = misorientation_angle(from_euler_zxz_deg(torch.from_numpy(got)),
                               from_euler_zxz_deg(torch.from_numpy(want)))
    assert np.rad2deg(mis.numpy()).max() < 1e-3
    # Self-queries: the orientation is the query's own dictionary row.
    own = from_euler_zxz_deg(torch.from_numpy(pdb["orientations"]))
    assert np.rad2deg(misorientation_angle(from_euler_zxz_deg(torch.from_numpy(got)),
                                           own).numpy()).max() < 1e-3

    for reader in (read_ang, read_ctf):
        a, b = reader(str(t / f"port.{reader.__name__[-3:]}")), reader(
            str(t / f"jax.{reader.__name__[-3:]}"))
        np.testing.assert_allclose(a.eulers, b.eulers, atol=1e-3)
        np.testing.assert_array_equal(a.phase, b.phase)
        np.testing.assert_array_equal(a.success, b.success)
        assert a.grid == b.grid == (4, 6)
    ja, pa = np.load(t / "jax_amb.npz"), np.load(t / "port_amb.npz")
    np.testing.assert_array_equal(pa["has_rival"], ja["has_rival"])


@pytest.mark.parametrize(
    "flags, ext",
    [
        (["--preprocess", "static=auto"], ".h5"),
        ([], ".h5"),
        ([], ".up1"),
    ],
)
def test_later_slice_flags_raise(files, tmp_path, capsys, flags, ext):
    """HDF5 and EDAX UP scans (and ``static=auto`` on them), once refused,
    index: streamed in ``--h5-chunk`` slabs, the scan gives the ``.npy``
    stack's orientations (tests/test_torch_scan_io.py holds the readers
    against JAX's)."""
    import h5py

    raw = np.round(np.load(files / "dict.npy") * 255).astype(np.uint8)
    np.save(tmp_path / "scan.npy", raw)
    scan = tmp_path / f"scan{ext}"
    if ext == ".h5":
        with h5py.File(scan, "w") as f:
            f["Scan 1/EBSD/Data/Pattern"] = raw
    else:
        with open(scan, "wb") as f:  # a version-1 header: width, height, offset
            f.write(np.asarray([1, 128, 128, 16], "<u4").tobytes() + raw.tobytes())
    db = str(tmp_path / "db.npz")
    _run_port(["build", "--patterns", str(tmp_path / "scan.npy"), "--angles",
               str(files / "dict.txt"), "--db", db, "--device", "cpu"] + SMALL, capsys)
    got = {}
    for src in ("scan.npy", scan.name):
        out = str(tmp_path / f"{src}.o.npy")
        summary = _summary(_run_port(
            ["query", "--patterns", str(tmp_path / src), "--db", db, "--out", out,
             "--top-n", "3", "--min-matches", "1", "--h5-chunk", "10", "--device", "cpu"]
            + SMALL + flags, capsys))
        assert summary["n_patterns"] == N and summary["input_dtype"] == "uint8"
        got[src] = np.load(out)
    np.testing.assert_allclose(got[scan.name], got["scan.npy"], atol=1e-4)


@pytest.mark.parametrize(
    "flags",
    [["--refine", "10"], ["--nlpar", "2.0", "--scan-grid", "4", "6"], ["--hough-iq"]],
    ids=["refine", "nlpar", "hough_iq"],
)
def test_ported_query_flags_index(files, tmp_path, capsys, flags):
    """``--refine``, ``--nlpar`` and ``--hough-iq``, once refused, index:
    ``--refine`` through the forward model the npz's simulate provenance
    names, ``--hough-iq`` writing the frames' Hough IQ beside the result."""
    meta = {"structure": "fcc", "lattice": 3.52, "lattice_c": None, "kv": 20.0, "size": 128,
            "pc": [0.5, 0.5, 0.7], "tilt": 0.0, "max_hkl": 2, "min_d": 1.0}
    pats = tmp_path / "dict.npy"
    pats.write_bytes((files / "dict.npy").read_bytes())
    (tmp_path / "dict.npy.simmeta.json").write_text(json.dumps(meta))
    db = str(tmp_path / "db.npz")
    _run_port(["build", "--patterns", str(pats), "--angles", str(files / "dict.txt"), "--db", db,
               "--device", "cpu"] + SMALL, capsys)
    out = str(tmp_path / "o.npy")
    summary = _summary(_run_port(["query", "--patterns", str(pats), "--db", db, "--out", out,
                                  "--top-n", "3", "--min-matches", "1", "--device", "cpu"]
                                 + SMALL + flags, capsys))
    assert summary["n_patterns"] == N and np.load(out).shape == (N, 3)
    assert ("refine_steps" in summary) == ("--refine" in flags)
    if "--hough-iq" in flags:
        iq = np.load(summary["hough_iq_out"])
        assert iq.shape == (N,) and np.isfinite(iq).all()


def test_devices_and_engines(files, capsys, monkeypatch, caplog):
    """``--devices 4`` with ``--device cpu`` builds over a mesh of four CPU
    entries, the same dictionary as one device's (to float roundoff); on
    cards, fewer attached than asked for is JAX's warning and one device."""
    from latice_tpu_torch.cli._common import mesh_from_flag

    base = ["build", "--patterns", str(files / "dict.npy"), "--angles",
            str(files / "dict.txt"), "--device", "cpu"] + SMALL
    caplog.set_level("INFO")
    _run_port(base + ["--db", str(files / "dev1.npz")], capsys)
    _run_port(base + ["--db", str(files / "dev.npz"), "--devices", "4"], capsys)
    assert "sharding build encode over 4 devices" in caplog.text
    one, four = np.load(files / "dev1.npz"), np.load(files / "dev.npz")
    np.testing.assert_allclose(four["vectors"], one["vectors"], rtol=0, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_from_flag(4, None, "build encode") is None
    assert "--devices 4 ignored: only 1 attached" in caplog.text
    query = ["query", "--patterns", str(files / "dict.npy"), "--db", str(files / "dev.npz"),
             "--device", "cpu", "--out", str(files / "dev_o.npy")] + SMALL
    for engine in ("int8", "approx"):  # ported: they index
        summary = _summary(_run_port(query + ["--engine", engine, "--top-n", "3",
                                              "--min-matches", "1"], capsys))
        assert summary["n_patterns"] == N
    summary = _summary(_run_port(query + ["--top-n", "3", "--min-matches", "1"], capsys))
    assert summary["n_patterns"] == N and summary["input_dtype"] == "float32"
    assert np.load(files / "dev_o.npy").shape == (N, 3)


def test_default_device_is_cuda(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run_port(["export", "--patterns", str(files / "dict.npy"), "--angles",
                   str(files / "dict.txt")] + SMALL, capsys)
