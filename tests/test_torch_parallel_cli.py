"""The port's multi-device flags on the CPU: ``cli.index build|query|di
--devices N``, ``cli.serve --shard-dictionary``, ``cli.index master
--devices N`` (with ``--mc``) and ``cli.train trainer.devices=2``.

With ``--device cpu``, ``--devices N`` and ``trainer.devices=N`` run over a
mesh of N CPU entries (the counterpart of the JAX package's virtual CPU
devices), so each flag's result is held against the same command on one
device: latents and orientations within 1e-5 (1e-4 degrees), the master
and the Monte Carlo bit for bit, the epoch metrics at rtol 1e-5. The CPU
counts as one device, so ``--shard-dictionary`` logs the JAX CLI's "ignored"
warning and serves unsharded.
"""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from latice_tpu_torch.cli import index as index_cli
from latice_tpu_torch.cli import serve as serve_cli
from latice_tpu_torch.cli.train import main as train_main

ROOT = Path(__file__).resolve().parents[1]
N = 12
SMALL = ["--inplanes", "2", "--latent-dim", "8", "--batch-size", "4", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. The CLIs build
    their models inside the library and the train CLI seeds the global RNG,
    and tests in other files build torch models from it unseeded, so their
    weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pcli")
    rng = np.random.default_rng(0)
    np.save(tmp / "dict.npy", rng.uniform(size=(N, 128, 128)).astype(np.float32))
    angles = rng.uniform([0, 20, 0], [340, 140, 340], size=(N, 3))
    (tmp / "dict.txt").write_text(f"eu\n{N}\n" + "".join(f"{a} {b} {c}\n" for a, b, c in angles))
    return tmp


def _run(argv, capsys):
    index_cli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("devices", ["2", "4"])
def test_build_and_query_devices(files, tmp_path, capsys, caplog, devices):
    caplog.set_level("INFO")
    out = {}
    for tag, flags in (("one", []), ("mesh", ["--devices", devices])):
        db = str(tmp_path / f"{tag}.npz")
        index_cli.main(["build", "--patterns", str(files / "dict.npy"), "--angles",
                        str(files / "dict.txt"), "--db", db] + SMALL + flags)
        o = str(tmp_path / f"{tag}.npy")
        summary = _run(["query", "--patterns", str(files / "dict.npy"), "--db", db, "--out", o,
                        "--top-n", "3", "--min-matches", "1", "--engine", "fused"]
                       + SMALL + flags, capsys)
        assert summary["n_patterns"] == N
        out[tag] = (np.load(db)["vectors"], np.load(o))
    assert f"sharding build encode over {devices} devices" in caplog.text
    assert f"sharding pipeline over {devices} devices" in caplog.text
    np.testing.assert_allclose(out["mesh"][0], out["one"][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["mesh"][1], out["one"][1], rtol=0, atol=1e-4)


def test_di_devices_and_streamed_warning(files, tmp_path, capsys, caplog):
    caplog.set_level("INFO")
    base = ["di", "--dict-patterns", str(files / "dict.npy"), "--dict-angles",
            str(files / "dict.txt"), "--patterns", str(files / "dict.npy"), "--top-n", "3",
            "--min-matches", "1", "--batch-size", "4", "--search-dtype", "float32",
            "--device", "cpu"]
    got = {}
    for tag, flags in (("one", []), ("mesh", ["--devices", "2"]),
                       ("streamed", ["--devices", "2", "--streamed"])):
        o = str(tmp_path / f"{tag}.npy")
        summary = _run(base + ["--out", o] + flags, capsys)
        assert summary["n_patterns"] == N
        got[tag] = np.load(o)
    assert "sharding DI over 2 devices" in caplog.text
    assert "--streamed ignores --devices" in caplog.text
    np.testing.assert_allclose(got["mesh"], got["one"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["streamed"], got["one"], rtol=0, atol=1e-4)


def test_devices_on_cards_fall_back_with_the_jax_warning(monkeypatch, caplog):
    from latice_tpu_torch.cli._common import mesh_from_flag

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_from_flag(2, "cuda", "pipeline") is None
    assert "--devices 2 ignored: only 1 attached" in caplog.text
    assert mesh_from_flag(1, "cpu", "pipeline") is None
    assert mesh_from_flag(None, "cpu", "pipeline") is None
    assert mesh_from_flag(3, "cpu", "pipeline").size == 3


def test_serve_shard_dictionary_on_one_device(files, tmp_path, caplog):
    db = str(tmp_path / "db.npz")
    index_cli.main(["build", "--patterns", str(files / "dict.npy"), "--angles",
                    str(files / "dict.txt"), "--db", db] + SMALL)
    small = ["--inplanes", "2", "--latent-dim", "8", "--batch-size", "4", "--device", "cpu",
             "--db", db]
    sharded = serve_cli.build_service(serve_cli.parse_args(small + ["--shard-dictionary"]))
    assert "--shard-dictionary ignored: one device attached" in caplog.text
    plain = serve_cli.build_service(serve_cli.parse_args(small))
    assert sharded.health()["mesh_devices"] == 0 and sharded.mesh is None
    x = np.load(files / "dict.npy")[:5]
    assert sharded.index(x)["orientations"] == plain.index(x)["orientations"]


def test_master_mc_devices_bitwise(tmp_path, capsys, caplog):
    caplog.set_level("INFO")
    small = ["--size", "9", "--beams", "15", "--max-hkl", "2", "--mc", "--mc-electrons", "3000",
             "--mc-energy-bins", "2", "--device", "cpu"]
    for devices in ("0", "2"):
        index_cli.main(["master", "--devices", devices, "--out",
                        str(tmp_path / f"m{devices}.npy")] + small)
    assert "sharding master generation over 2 devices" in caplog.text
    np.testing.assert_array_equal(np.load(tmp_path / "m2.npy"), np.load(tmp_path / "m0.npy"))
    meta = [json.loads((tmp_path / f"m{d}.npy.mastermeta.json").read_text()) for d in "02"]
    assert meta[0] == meta[1]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """28 seeded 36x36 patterns (center-cropped to 32) and an anglefile."""
    d = tmp_path_factory.mktemp("pcli_train")
    rng = np.random.default_rng(2)
    np.save(d / "patterns.npy", rng.uniform(size=(28, 36, 36)).astype(np.float32))
    with open(d / "angles.txt", "w") as f:
        f.write("eu\n28\n")
        np.savetxt(f, rng.uniform(0, 90, (28, 3)), fmt="%.4f")
    return d / "patterns.npy", d / "angles.txt"


def test_train_devices_two_on_cpu(dataset, tmp_path, caplog):
    caplog.set_level("INFO")
    path, angles = dataset
    rows = {}
    for devices in ("1", "2"):
        out = tmp_path / devices
        train_main(["--device", "cpu", "--config-path", str(ROOT / "conf"),
                    "lightning_module.model.inplanes=2", "lightning_module.model.latent_dim=8",
                    "lightning_module.model.n_stages=3", "data_module.image_size=[32,32]",
                    "data_module.batch_size=8", "trainer.precision=32",
                    f"data_module.path={path}", f"data_module.rot_angles_path={angles}",
                    "trainer.max_epochs=1", f"trainer.checkpoint_dir={out / 'ck'}",
                    f"trainer.logger.save_dir={out / 'logs'}", f"trainer.devices={devices}"])
        with open(out / "logs" / "metrics.csv") as f:
            rows[devices] = list(csv.DictReader(f))[0]
    assert "Data-parallel training over mesh" in caplog.text
    for key in ("Epoch_train_loss", "Epoch_train_kl_loss", "Epoch_train_recon_loss",
                "Epoch_val_loss"):
        np.testing.assert_allclose(float(rows["2"][key]), float(rows["1"][key]), rtol=1e-5,
                                   err_msg=key)
