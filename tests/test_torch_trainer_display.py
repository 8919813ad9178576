"""The trainer's progress bar (``utils.progress``) and reconstruction figure,
on the CPU at a small size (inplanes 2, latent 8, 3 stages, 32x32
patterns), against the JAX package's bar and figure.

The figure of the last validation batch must reach ``logger.log_image``
as the JAX trainer's does: the same name, and the same RGBA array when the
JAX trainer's ``_log_reconstruction`` renders the same batch (byte-equal:
both draw with matplotlib from the same numbers and the same sample draw).
"""

from __future__ import annotations

import contextlib
import io
import logging
import random
import sys

import numpy as np
import pytest
import torch

from latice_tpu.train.trainer import Trainer as JaxTrainer
from latice_tpu.utils.progress import EpochProgressBar as JaxBar
from latice_tpu_torch.data import DPDataModule
from latice_tpu_torch.models import VariationalAutoEncoderRawData
from latice_tpu_torch.train import Trainer, VAEModule
from latice_tpu_torch.utils import progress, viz
from latice_tpu_torch.utils.progress import EpochProgressBar, make_progress_bar


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture
def no_rich(monkeypatch):
    """Import of ``rich`` fails, as on a machine without it."""
    for name in ("rich", "rich.console", "rich.progress"):
        monkeypatch.setitem(sys.modules, name, None)


class _Recorder:
    """A logger that keeps what it is given."""

    def __init__(self) -> None:
        self.images: list[tuple[str, np.ndarray, int]] = []
        self.metrics: list[dict] = []

    def log_metrics(self, metrics, step):
        self.metrics.append(dict(metrics))

    def log_image(self, name, image, step):
        self.images.append((name, image, step))

    def finalize(self):
        pass


def test_plain_bar_writes_to_its_stream(no_rich):
    """Without rich: one carriage-return line per step, the loss readout
    as JAX's, and a closing ``\\r``."""
    lines = {}
    for name, cls in (("port", EpochProgressBar), ("jax", JaxBar)):
        stream = io.StringIO()
        bar = cls(epoch=3, total=2, stream=stream)
        bar.step({"elbo": 1.23456, "train_loss": 9.0})
        bar.step({"train_loss": 2.0})
        bar.set_phase("val")
        bar.step({"val_loss": 0.5})
        bar.close()
        lines[name] = stream.getvalue()
    assert lines["port"] == lines["jax"]
    assert lines["port"].startswith("\repoch 3 train: 1/2 elbo=1.235")
    assert "\repoch 3 val: 1 val_loss=0.5" in lines["port"] and lines["port"].endswith("\r")


def test_rich_bar_and_null_bar():
    bar = EpochProgressBar(0, 4, stream=io.StringIO())
    bar.step({"elbo": 1.0})
    bar.set_phase("val", total=1)
    bar.step()
    bar.close()  # rich, where it imports, renders to the stream and clears it
    enabled = make_progress_bar(True, 0, 4)
    enabled.close()
    assert isinstance(enabled, EpochProgressBar)
    null = make_progress_bar(False, 0, 4)
    assert not isinstance(null, EpochProgressBar)
    null.step({"elbo": 1.0})
    null.set_phase("val")
    null.close()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("display_data")
    rng = np.random.default_rng(0)
    np.save(d / "patterns.npy", rng.uniform(size=(44, 32, 32)).astype(np.float32))
    with open(d / "angles.txt", "w") as f:
        f.write("eu\n44\n")
        np.savetxt(f, rng.uniform(0, 90, (44, 3)), fmt="%.4f")
    return d / "patterns.npy", d / "angles.txt"


def _fit(dataset, logger, **kwargs):
    trainer = Trainer(max_epochs=1, precision="32", seed=3, device="cpu", logger=logger,
                      **kwargs)
    module = VAEModule(VariationalAutoEncoderRawData(2, 8, n_stages=3), kl_lambda=0.1)
    dm = DPDataModule(*dataset, image_size=(32, 32), batch_size=16, seed=5)
    trainer.fit(module, dm)
    return trainer


@pytest.fixture(scope="module")
def fitted(dataset):
    """One epoch with the bar on (plain: no rich) and the figure on: the
    bar's stderr, the recording logger, and the arrays the figure got."""
    seen = []
    plot = viz.plot_detection

    def recording_plot(x, x_hat, *args, **kwargs):
        seen.append((np.asarray(x), np.asarray(x_hat)))
        random.seed(0)
        return plot(x, x_hat, *args, **kwargs)

    log, err = _Recorder(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(err):
        for name in ("rich", "rich.console", "rich.progress"):
            mp.setitem(sys.modules, name, None)
        mp.setattr(viz, "plot_detection", recording_plot)
        _fit(dataset, log, enable_progress_bar=True)
    return err.getvalue(), log, seen


def test_fit_draws_the_bar_on_stderr(fitted):
    err, _, _ = fitted
    assert "\repoch 0 train: 3/3 elbo=" in err and "\repoch 0 val: 1 val_loss=" in err
    assert err.endswith("\r")


def test_reconstruction_figure_equals_jax(fitted):
    """The port's figure of the last validation batch, and the JAX
    trainer's figure of the same batch: same name, step, shape and bytes."""
    _, port_log, seen = fitted
    assert len(port_log.images) == 1 and len(seen) == 1
    name, image, step = port_log.images[0]
    x, x_hat = seen[0]
    assert x.shape == (4, 32, 32, 1) and x_hat.shape == (4, 1, 32, 32)
    assert x_hat.dtype == np.float32

    jax_log = _Recorder()
    stub = type("Stub", (), {"logger": jax_log})()
    random.seed(0)
    JaxTrainer._log_reconstruction(stub, (x, np.moveaxis(x_hat, 1, -1)), 0)
    want_name, want, want_step = jax_log.images[0]
    assert (name, step) == (want_name, want_step) == ("reconstruction/eval_check", 0)
    assert image.shape == want.shape and image.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(image, want)


def test_missing_matplotlib_is_a_warning(dataset, monkeypatch, caplog):
    """As in JAX: the figure fails, a warning is logged, training goes on
    and nothing reaches ``log_image``."""
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    log = _Recorder()
    with caplog.at_level(logging.WARNING, logger="latice_tpu_torch.train.trainer"):
        trainer = _fit(dataset, log, enable_progress_bar=False)
    assert log.images == [] and len(trainer.history) == 1
    assert "Reconstruction figure logging failed" in caplog.text


def test_progress_module_exports():
    assert progress.__all__ == ["EpochProgressBar", "make_progress_bar"]
