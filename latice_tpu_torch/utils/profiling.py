"""Profiling hooks, the port of ``latice_tpu.utils.profiling``:
``torch.profiler`` capture around any phase, and a phase timer whose
reports feed the metrics loggers."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

__all__ = ["trace", "PhaseTimer", "device_sync"]


def device_sync() -> None:
    """Block until the work queued on the current CUDA device is done; a
    no-op when CUDA was never initialised (CPU work is synchronous)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path, name: str | None = None):
    """Capture a ``torch.profiler`` trace of the block (host ops, and CUDA
    kernels and copies when CUDA is available) and write it as a Chrome
    trace, ``<log_dir>/<name or "trace">-<ns>.json``, which Perfetto opens
    and `utils.torch_trace.summarize_trace` reads.

    Example::

        with trace("/tmp/traces", "index_batch"):
            pipeline(patterns)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        device_sync()
        prof.__exit__(None, None, None)
        path = log_dir / f"{name or 'trace'}-{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        logger.info(f"Trace '{name or 'phase'}' written to {path}")


class PhaseTimer:
    """Accumulating wall-clock timer for named pipeline phases.

    With ``sync`` the device's queued work is waited for at each phase's
    exit, so the times cover it. ``report()`` gives the total, mean and
    count of each phase, ready for ``logger.log_metrics``.
    """

    def __init__(self, sync: bool = True) -> None:
        self.sync = sync
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                device_sync()
            self._totals[name] += time.perf_counter() - start
            self._counts[name] += 1

    def report(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, total in self._totals.items():
            count = self._counts[name]
            out[f"{name}/total_s"] = total
            out[f"{name}/mean_s"] = total / count
            out[f"{name}/count"] = float(count)
        return out

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()

    def __repr__(self) -> str:
        parts = [f"{k}={self._totals[k]:.3f}s/{self._counts[k]}x" for k in sorted(self._totals)]
        return f"PhaseTimer({', '.join(parts)})"
