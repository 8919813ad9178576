"""Experiment loggers: CSV (always), TensorBoard and W&B (optional).

The port's copy of ``latice_tpu.utils.loggers``. The reference logs
through Lightning's WandbLogger/TensorBoardLogger (conf/trainer/default.yaml:
17-20, utils.py:119-148). Here loggers share one small protocol:
``log_metrics``, ``log_image``, ``finalize``; a MultiLogger fans out to
whichever backends are available. TensorBoard and W&B are used only when
their packages import.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["CSVLogger", "TensorBoardLogger", "WandbLogger", "MultiLogger", "make_default_logger"]


class CSVLogger:
    """Append metrics to ``metrics.csv`` under ``save_dir`` — dependency-free."""

    def __init__(self, save_dir: str | Path, name: str = "metrics.csv") -> None:
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.save_dir / name
        self._fieldnames: list[str] = ["step"]

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        new_fields = [k for k in row if k not in self._fieldnames]
        rewrite = bool(new_fields) and self.path.exists()
        self._fieldnames += new_fields
        if rewrite:
            # Widen the header by rewriting existing rows.
            with open(self.path) as f:
                existing = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                writer.writeheader()
                writer.writerows(existing)
        write_header = not self.path.exists()
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if write_header:
                writer.writeheader()
            writer.writerow(row)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        out = self.save_dir / "images"
        out.mkdir(exist_ok=True)
        try:
            from PIL import Image

            Image.fromarray(image).save(out / f"{name.replace('/', '_')}_{step}.png")
        except ImportError:
            np.save(out / f"{name.replace('/', '_')}_{step}.npy", image)

    def finalize(self) -> None:
        pass


class TensorBoardLogger:
    """tensorboardX-backed logger (the reference's TB path, utils.py:143-145)."""

    def __init__(self, save_dir: str | Path) -> None:
        from tensorboardX import SummaryWriter  # optional dep, fail loudly

        self.writer = SummaryWriter(str(save_dir))

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        for key, value in metrics.items():
            self.writer.add_scalar(key, float(value), step)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        self.writer.add_image(f"{name}_{step}", np.moveaxis(image[:, :, :3], 2, 0))

    def finalize(self) -> None:
        self.writer.close()


class WandbLogger:
    """Weights & Biases logger (reference default, conf/trainer/default.yaml:17).

    Gated: constructing it without the wandb package raises ImportError.
    """

    def __init__(self, save_dir: str | Path = ".", project: str = "VAE_Training", **kwargs) -> None:
        import wandb  # optional dep

        self._wandb = wandb
        self.run = wandb.init(project=project, dir=str(save_dir), **kwargs)

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        self._wandb.log(dict(metrics), step=step)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        self._wandb.log({f"{name}_{step}": [self._wandb.Image(image[:, :, :3])]})

    def finalize(self) -> None:
        self.run.finish()


class MultiLogger:
    """Fan out to several loggers."""

    def __init__(self, loggers: list) -> None:
        self.loggers = loggers

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        for lg in self.loggers:
            lg.log_image(name, image, step)

    def finalize(self) -> None:
        for lg in self.loggers:
            lg.finalize()


def make_default_logger(
    save_dir: str | Path,
    tensorboard: bool = True,
    wandb: bool = False,
    project: str = "VAE_Training",
    **wandb_kwargs,
):
    """CSV always; TensorBoard and W&B by flag (and package availability).

    ``wandb=True, project=...`` mirrors the reference's default logger
    ``WandbLogger(project=VAE_Training)`` (reference
    conf/trainer/default.yaml:17-20); unlike the reference it degrades to the
    local backends instead of failing when the wandb package is absent.
    """
    loggers: list = [CSVLogger(save_dir)]
    if tensorboard:
        try:
            loggers.append(TensorBoardLogger(Path(save_dir) / "tb"))
        except ImportError:
            logger.info("tensorboardX unavailable; skipping TensorBoard logging")
    if wandb:
        try:
            loggers.append(WandbLogger(save_dir, project=project, **wandb_kwargs))
        except ImportError:
            logger.warning("wandb package unavailable; skipping W&B logging")
    return MultiLogger(loggers)
