"""The port's epoch loop, checkpoints, config engine and training CLI, on
the CPU at a small size (inplanes 2, latent 8, 3 stages, 32x32 patterns).

A resumed run must end with the same weights as an uninterrupted one,
bit for bit: the weights are drawn from the seed, the batch order from
(seed, epoch) and the noise from (seed, step), and the checkpoint carries
the optimizer's moments and the step.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from latice_tpu.config import expand_sweeps as jax_expand_sweeps
from latice_tpu.config import load_config as jax_load_config
from latice_tpu_torch.cli.train import main as train_main
from latice_tpu_torch.config import expand_sweeps, instantiate, load_config, port_target
from latice_tpu_torch.data import DPDataModule
from latice_tpu_torch.models import VariationalAutoEncoderRawData, load_checkpoint
from latice_tpu_torch.train import (
    CheckpointManager,
    ReduceLROnPlateau,
    Trainer,
    VAEModule,
    get_learning_rate,
)
from latice_tpu_torch.utils import CSVLogger

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["lightning_module.model.inplanes=2", "lightning_module.model.latent_dim=8",
         "lightning_module.model.n_stages=3", "data_module.image_size=[32,32]",
         "data_module.batch_size=16", "trainer.precision=32"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """44 seeded 36x36 patterns (center-cropped to 32) and an anglefile."""
    d = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(0)
    np.save(d / "patterns.npy", rng.uniform(size=(44, 36, 36)).astype(np.float32))
    with open(d / "angles.txt", "w") as f:
        f.write("eu\n44\n")
        np.savetxt(f, rng.uniform(0, 90, (44, 3)), fmt="%.4f")
    return d / "patterns.npy", d / "angles.txt"


def _fit(dataset, ckpt_dir, max_epochs, resume=False, logger=None, scheduler=None):
    trainer = Trainer(max_epochs=max_epochs, precision="32", checkpoint_dir=ckpt_dir,
                      save_top_k=1, seed=3, device="cpu", logger=logger)
    module = VAEModule(VariationalAutoEncoderRawData(2, 8, n_stages=3), kl_lambda=0.1,
                       lr_scheduler_partial=scheduler)
    dm = DPDataModule(*dataset, image_size=(32, 32), batch_size=16, seed=5)
    model = trainer.fit(module, dm, resume=resume)
    return trainer, module, dm, model


def test_fit_logs_epoch_metrics_and_keeps_top_k(dataset, tmp_path):
    logger = CSVLogger(tmp_path / "logs")
    trainer, module, dm, model = _fit(dataset, tmp_path / "ck", 2, logger=logger)
    assert trainer.steps_run == {"train": 6, "val": 2}  # 40 rows: 16, 16, 8 masked
    with open(tmp_path / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [0, 1]
    for key in ("Epoch_train_loss", "Epoch_train_kl_loss", "Epoch_train_recon_loss",
                "Epoch_val_loss", "Epoch_val_kl_loss", "Epoch_val_recon_loss",
                "learning_rate", "epoch_time_s"):
        assert all(np.isfinite(float(r[key])) for r in rows), key
    # Top-1 by Epoch_val_loss, and the epoch just written is never pruned.
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    best = int(np.argmin([h["Epoch_val_loss"] for h in trainer.history]))
    assert set(manifest) == {str(best), "1"}
    files = {p.name for p in (tmp_path / "ck").iterdir()}
    assert {"last.pt", "last_state.pt", "last_epoch.json", "manifest.json"} <= files
    assert {name for name in files if name.startswith("epoch_")} == {
        f"epoch_{e}.pt" for e in {best, 1}}
    loaded = load_checkpoint(str(tmp_path / "ck" / "last.pt"), 2, 8, n_stages=3, device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    latent = trainer.test(module, dm)
    assert latent.shape == (44, 8) and np.all(np.isfinite(latent))


def test_resume_matches_uninterrupted_run(dataset, tmp_path):
    *_, straight = _fit(dataset, tmp_path / "a", 2)
    _fit(dataset, tmp_path / "b", 1)
    trainer, *_, resumed = _fit(dataset, tmp_path / "b", 2, resume=True)
    assert trainer.start_epoch == 1 and trainer.global_step == 6
    for k, v in straight.state_dict().items():
        torch.testing.assert_close(resumed.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_scheduler_steps_on_val_loss(dataset, tmp_path):
    plateau = ReduceLROnPlateau(factor=0.5, patience=0, threshold=10.0)
    trainer, *_ = _fit(dataset, None, 2, scheduler=plateau)
    assert [h["learning_rate"] for h in trainer.history] == [1e-4, 1e-4]
    assert get_learning_rate(trainer.optimizer) == pytest.approx(5e-5)


def test_checkpoint_manager_prunes_by_monitor(tmp_path):
    mgr = CheckpointManager(tmp_path, save_top_k=2)
    sd = {"w": torch.zeros(2)}
    for epoch, val in enumerate([3.0, 1.0, 2.0, 5.0]):
        mgr.save(epoch, {"w": torch.full((2,), float(epoch))}, {"Epoch_val_loss": val},
                 full_state={"model": sd, "optimizer": {}, "step": epoch})
    kept = sorted(p.name for p in tmp_path.glob("epoch_*.pt"))
    assert kept == ["epoch_1.pt", "epoch_2.pt", "epoch_3.pt"]  # the last save is kept too
    assert mgr.best_epoch() == 1 and float(mgr.load_best()["w"][0]) == 1.0
    assert float(mgr.load_last()["w"][0]) == 3.0 and mgr.last_epoch() == 3
    assert CheckpointManager(tmp_path).best_epoch() == 1  # manifest reloads


def test_trainer_unported_options_raise():
    """``mesh`` takes a `parallel.Mesh` (anything else raises;
    tests/test_torch_parallel_train.py trains over one); ``augment`` (a
    callable or a `data.AugmentConfig`) and ``denoising``, once refused
    here, are taken."""
    from latice_tpu_torch.data import AugmentConfig

    with pytest.raises(TypeError, match="Mesh"):
        Trainer(device="cpu", mesh=object())
    identity = lambda g, b: b  # noqa: E731
    assert Trainer(device="cpu", augment=identity).augment is identity
    assert Trainer(device="cpu", denoising=True).denoising
    assert callable(Trainer(device="cpu", augment=AugmentConfig(noise_std=0.1)).augment)
    with pytest.raises(TypeError, match="AugmentConfig"):
        Trainer(device="cpu", augment="noise")


@pytest.mark.parametrize("overrides", [
    [],
    ["trainer.max_epochs=5", "seed=3", "data_module.batch_size=8"],
    ["trainer=robust", "lightning_module=scaled"],
])
def test_config_matches_jax(overrides):
    ours = load_config(ROOT / "conf", "train.yaml", overrides, runtime_cwd="/work")
    theirs = jax_load_config(ROOT / "conf", "train.yaml", overrides, runtime_cwd="/work")

    def ported(node):
        if isinstance(node, dict):
            return {k: port_target(v) if k == "_target_" else ported(v) for k, v in node.items()}
        if isinstance(node, list):
            return [ported(v) for v in node]
        return node

    assert ported(ours) == ported(theirs)
    assert ours["data_dir"] == "/work/data"
    assert ours["lightning_module"]["kl_lambda"] == 5e-6


def test_instantiate_maps_targets_to_the_port():
    cfg = load_config(ROOT / "conf", "train.yaml", SMALL)
    module = instantiate(cfg["lightning_module"])
    assert isinstance(module, VAEModule)
    assert isinstance(module.model, VariationalAutoEncoderRawData)
    assert module.model.inplanes == 2 and module.scheduler.patience == 10
    opt = module.configure_optimizer()
    assert type(opt).__module__ == "latice_tpu_torch.train.state"
    assert get_learning_rate(opt) == pytest.approx(1e-4) and opt.defaults["amsgrad"]
    from latice_tpu_torch.data import AugmentConfig, StreamedDPDataModule

    aug = instantiate({"_target_": "latice_tpu.data.AugmentConfig", "noise_std": 0.05})
    assert isinstance(aug, AugmentConfig) and aug.noise_std == 0.05
    assert port_target("latice_tpu.data.StreamedDPDataModule") == (
        f"{StreamedDPDataModule.__module__.rsplit('.', 1)[0]}.StreamedDPDataModule")
    # latice_tpu.parallel, the last package without a port, now has one.
    mesh = instantiate({"_target_": "latice_tpu.parallel.make_mesh", "devices": ["cpu"] * 2})
    assert type(mesh).__module__ == "latice_tpu_torch.parallel.mesh" and mesh.size == 2
    with pytest.raises(ImportError, match="port has no"):
        instantiate({"_target_": "latice_tpu.parallel.no_such_helper"})
    assert port_target("latice_tpu.train.trainer.Trainer") == "latice_tpu_torch.train.trainer.Trainer"


def test_expand_sweeps_matches_jax():
    ovs = ["a=1,2", "b=x", "c=3,4,5"]
    assert expand_sweeps(ovs) == jax_expand_sweeps(ovs)


def _cli_args(dataset, tmp_path):
    path, angles = dataset
    return SMALL + [f"data_module.path={path}", f"data_module.rot_angles_path={angles}",
                    "trainer.max_epochs=1", f"trainer.checkpoint_dir={tmp_path / 'ck'}",
                    f"trainer.logger.save_dir={tmp_path / 'logs'}"]


def test_cli_trains_one_epoch_on_cpu(dataset, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "latice_tpu_torch.cli.train", "--device", "cpu",
         "--config-path", str(ROOT / "conf"), *_cli_args(dataset, tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "ck" / "last.pt").exists()
    with open(tmp_path / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["Epoch_val_loss"]))


def test_cli_without_device_needs_cuda(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--config-path", str(ROOT / "conf"), *_cli_args(dataset, tmp_path)])


def test_cli_refuses_several_devices(dataset, tmp_path):
    """``trainer.devices=4`` builds its mesh over the first four cards, so
    a machine without them refuses it; with ``--device cpu`` the mesh is
    four CPU entries (tests/test_torch_parallel_cli.py trains over it)."""
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards are attached; the refusal is for machines without them")
    with pytest.raises(ValueError, match="Requested 4 devices but only"):
        train_main(["--config-path", str(ROOT / "conf"),
                    *_cli_args(dataset, tmp_path), "trainer.devices=4"])
