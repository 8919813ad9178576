"""Checkpoints: top-k on a monitored metric plus always-keep-last.

The port of ``latice_tpu.train.checkpoint``, with torch state dicts in the
reference's layout in place of orbax directories:

    <directory>/epoch_<N>.pt     the model's state dict after epoch N
    <directory>/last.pt          a copy of the most recent epoch
    <directory>/last_state.pt    {"model", "optimizer", "step"} for resume
    <directory>/manifest.json    {epoch: metric} of the kept epochs
    <directory>/last_epoch.json  the epoch ``last_state.pt`` ends

``models.load_checkpoint`` reads ``last.pt`` or any ``epoch_<N>.pt``
directly. Every file is written to a temporary name and renamed, so a run
killed mid-save leaves the previous file whole.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Any

import torch

logger = logging.getLogger(__name__)

__all__ = ["CheckpointManager", "save_params", "load_params"]


def save_params(path: str | Path, obj: Any) -> None:
    """``torch.save`` to ``path`` through a temporary file."""
    path = Path(path)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_params(path: str | Path) -> Any:
    """Load a checkpoint file onto the CPU (tensors only, no code)."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def _cpu_copy(obj: Any) -> Any:
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj


class CheckpointManager:
    """Keep the best ``save_top_k`` epochs by a monitored metric, plus last."""

    def __init__(
        self,
        directory: str | Path,
        save_top_k: int = 5,
        monitor: str = "Epoch_val_loss",
        mode: str = "min",
        save_last: bool = True,
    ) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self._manifest: dict[str, float] = {}
        manifest_path = self.directory / "manifest.json"
        if manifest_path.exists():
            self._manifest = json.loads(manifest_path.read_text())

    def _epoch_path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{epoch}.pt"

    def save(
        self,
        epoch: int,
        params: dict[str, torch.Tensor],
        metrics: dict[str, float],
        full_state: dict[str, Any] | None = None,
    ) -> None:
        """Persist this epoch's model state dict; prune to the top-k.

        ``full_state`` (``{"model", "optimizer", "step"}``), when given, is
        also written to ``last_state.pt`` so training can resume with the
        optimizer's moments intact.
        """
        metric = float(metrics.get(self.monitor, float("inf")))
        params = _cpu_copy(params)
        save_params(self._epoch_path(epoch), params)
        self._manifest[str(epoch)] = metric

        if self.save_last:
            shutil.copyfile(self._epoch_path(epoch), self.directory / "last.pt")
        if full_state is not None:
            save_params(self.directory / "last_state.pt", _cpu_copy(full_state))
            (self.directory / "last_epoch.json").write_text(json.dumps(epoch))

        # Prune beyond top-k (never the one just written: it is also "last").
        if self.save_top_k >= 0:
            sign = 1.0 if self.mode == "min" else -1.0
            ranked = sorted(self._manifest.items(), key=lambda kv: sign * kv[1])
            for key, _ in ranked[self.save_top_k :]:
                if int(key) == epoch:
                    continue
                self._epoch_path(int(key)).unlink(missing_ok=True)
                del self._manifest[key]

        (self.directory / "manifest.json").write_text(json.dumps(self._manifest))

    def best_epoch(self) -> int | None:
        if not self._manifest:
            return None
        sign = 1.0 if self.mode == "min" else -1.0
        return int(min(self._manifest.items(), key=lambda kv: sign * kv[1])[0])

    def best_path(self) -> Path | None:
        epoch = self.best_epoch()
        return None if epoch is None else self._epoch_path(epoch)

    def load_best(self) -> dict[str, torch.Tensor]:
        path = self.best_path()
        if path is None or not path.exists():
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        return load_params(path)

    def load_last(self) -> dict[str, torch.Tensor]:
        last = self.directory / "last.pt"
        if not last.exists():
            raise FileNotFoundError(f"No 'last' checkpoint under {self.directory}")
        return load_params(last)

    def last_epoch(self) -> int:
        path = self.directory / "last_epoch.json"
        if not path.exists():
            raise FileNotFoundError(f"No resume metadata under {self.directory}")
        return int(json.loads(path.read_text()))

    def load_last_state(self) -> dict[str, Any]:
        """``{"model", "optimizer", "step"}`` as the last save wrote them."""
        path = self.directory / "last_state.pt"
        if not path.exists():
            raise FileNotFoundError(f"No 'last_state' checkpoint under {self.directory}")
        return load_params(path)
