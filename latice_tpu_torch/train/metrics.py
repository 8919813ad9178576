"""Step-metric accumulation and epoch aggregation.

The port's copy of ``latice_tpu.train.metrics``: per-step ``train_*`` /
``val_*`` names plus epoch means ``Epoch_train_*`` / ``Epoch_val_*``
(latice/lightning_module.py:266-270, 275-294, 306-310, 314-329), without
holding per-step device tensors alive.
"""

from __future__ import annotations

import math
from collections import defaultdict

__all__ = ["EpochAggregator"]


class EpochAggregator:
    """Streaming mean of step metrics; emits reference-named epoch metrics."""

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix  # "train_" or "val_"
        self._sums: dict[str, float] = defaultdict(float)
        self._steps = 0
        self._weight = 0.0

    def update(self, step_metrics: dict, weight: float = 1.0) -> dict[str, float]:
        """Record one step; returns the step metrics with prefixed names.

        ``weight`` is the step's contribution to the epoch mean — pass the
        real (unpadded) sample count so a padded tail batch doesn't count as
        a full batch (its step metrics already exclude the pad rows).
        """
        out = {}
        for key, value in step_metrics.items():
            v = float(value)
            if not math.isfinite(v):
                # Surface NaN/Inf immediately rather than poisoning the mean.
                raise FloatingPointError(
                    f"Non-finite metric {self.prefix}{key}={v} at step {self._steps}"
                )
            self._sums[key] += v * weight
            out[f"{self.prefix}{key}"] = v
        self._steps += 1
        self._weight += weight
        return out

    def epoch_metrics(self) -> dict[str, float]:
        """Weighted mean over the epoch, keyed ``Epoch_<prefix><name>``."""
        if self._weight == 0:
            return {}
        return {
            f"Epoch_{self.prefix}{key}": total / self._weight
            for key, total in self._sums.items()
        }

    def reset(self) -> None:
        self._sums.clear()
        self._steps = 0
        self._weight = 0.0

    def __len__(self) -> int:
        return self._steps
