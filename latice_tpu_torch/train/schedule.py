"""Host-side ReduceLROnPlateau with torch-default semantics.

The port's copy of ``latice_tpu.train.schedule``. The reference schedules
per epoch on the validation loss (latice/lightning_module.py:31-35,
359-369; conf/lightning_module/default.yaml: factor=0.1, patience=10).
This small state machine returns the next learning rate, and the trainer
hands it to `train.state.set_learning_rate` between epochs. It is not
``torch.optim.lr_scheduler.ReduceLROnPlateau``, which owns the optimizer:
here the trainer decides when a rate takes effect, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ReduceLROnPlateau"]


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (defaults match).

    Attributes mirror the torch constructor: mode 'min'/'max', multiplicative
    `factor`, `patience` epochs of no improvement, relative/absolute
    `threshold`, `cooldown`, and `min_lr` floor.
    """

    factor: float = 0.1
    patience: int = 10
    mode: str = "min"
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0
    eps: float = 1e-8

    best: float | None = dataclasses.field(default=None, init=False)
    num_bad_epochs: int = dataclasses.field(default=0, init=False)
    cooldown_counter: int = dataclasses.field(default=0, init=False)

    def _is_better(self, current: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < best * (1.0 - self.threshold)
            return current < best - self.threshold
        if self.threshold_mode == "rel":
            return current > best * (1.0 + self.threshold)
        return current > best + self.threshold

    def step(self, metric: float, current_lr: float) -> float:
        """Record an epoch metric; return the (possibly reduced) learning rate."""
        current = float(metric)
        if self.best is None or self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(current_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            if current_lr - new_lr > self.eps:
                return new_lr
        return current_lr
