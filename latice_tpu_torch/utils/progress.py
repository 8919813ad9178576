"""Training progress bar, the port of ``latice_tpu.utils.progress`` (the
reference's ``RichProgressBar``, conf/trainer/default.yaml:9).

One bar per epoch through ``rich.progress`` when it imports, else a plain
carriage-return line. Display only: it must never affect training, so
every display call is guarded.
"""

from __future__ import annotations

import sys
from typing import Any

__all__ = ["EpochProgressBar", "make_progress_bar"]


class _NullBar:
    """No-op bar for enable_progress_bar=False."""

    def step(self, metrics: dict | None = None, advance: int = 1) -> None: ...

    def set_phase(self, phase: str, total: int | None = None) -> None: ...

    def close(self) -> None: ...


class EpochProgressBar:
    """One epoch's train/val progress with a live loss readout.

    Args:
        epoch: epoch index (display only).
        total: number of train batches, when known.
        stream: output stream; stderr by default, so metric logs on stdout
            stay machine-readable.
    """

    def __init__(self, epoch: int, total: int | None = None, stream: Any = None):
        self.epoch = epoch
        self.total = total
        self.stream = stream if stream is not None else sys.stderr
        self._count = 0
        self._phase = "train"
        self._rich = None
        self._task = None
        try:
            from rich.console import Console
            from rich.progress import (
                BarColumn,
                MofNCompleteColumn,
                Progress,
                TextColumn,
                TimeElapsedColumn,
            )

            self._rich = Progress(
                TextColumn("[bold]epoch {task.fields[epoch]}[/] {task.description}"),
                BarColumn(),
                MofNCompleteColumn(),
                TimeElapsedColumn(),
                TextColumn("{task.fields[readout]}"),
                console=Console(file=self.stream),
                transient=True,
            )
            self._rich.start()
            self._task = self._rich.add_task("train", total=total, epoch=epoch, readout="")
        except Exception:  # no rich, or a broken terminal: the plain line
            self._rich = None

    def set_phase(self, phase: str, total: int | None = None) -> None:
        self._count = 0
        self.total = total
        if self._rich is not None:
            try:
                self._rich.reset(self._task, total=total, description=phase)
                return
            except Exception:
                self._rich = None
        self._phase = phase

    def step(self, metrics: dict | None = None, advance: int = 1) -> None:
        self._count += advance
        readout = ""
        if metrics:
            # "elbo" is the reference's progress-bar loss name
            # (lightning_module.py:266 prog_bar=True).
            for key in ("elbo", "train_loss", "val_loss", "loss"):
                if key in metrics:
                    readout = f"{key}={metrics[key]:.4g}"
                    break
        if self._rich is not None:
            try:
                self._rich.update(self._task, advance=advance, readout=readout)
                return
            except Exception:
                self._rich = None
        total = f"/{self.total}" if self.total else ""
        self.stream.write(f"\repoch {self.epoch} {self._phase}: {self._count}{total} {readout}   ")
        self.stream.flush()

    def close(self) -> None:
        if self._rich is not None:
            try:
                self._rich.stop()
                return
            except Exception:
                self._rich = None
        self.stream.write("\r")
        self.stream.flush()


def make_progress_bar(
    enabled: bool, epoch: int, total: int | None = None
) -> EpochProgressBar | _NullBar:
    """Bar factory honoring the trainer's ``enable_progress_bar`` flag."""
    return EpochProgressBar(epoch, total) if enabled else _NullBar()
