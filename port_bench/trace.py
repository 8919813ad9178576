"""Reading a ``torch.profiler`` window: device time by kernel and group, the
busy union, the idle gaps and what the host was inside during each.

A frozen copy, for the benchmark, of the arithmetic of the program's
``utils/torch_trace.py`` (sums of device events by name) and of
``chip_smoke.py``'s kernel grouping; the busy share is the union of the
device's kernel, copy and set intervals inside the window, not their sum.
The window is the host time between `Window.start` and `Window.stop`;
the profiler's timestamps are on the same clock as ``time.time_ns``.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Spans", "Trace", "Window", "annotate", "group_of", "read"]

# Host annotations whose device-side mirrors are not device work.
_ANNOTATION_PREFIXES = ("bench:", "train:", "Optimizer.", "ProfilerStep")


def group_of(name: str) -> str:
    """The group of a device activity, by its name."""
    if "instance_norm_lrelu_bwd" in name:
        return "k2b"
    if "instance_norm_lrelu" in name:
        return "k2f"
    if "topk_partial" in name or "topk_merge" in name:
        return "k1"
    if "Memcpy HtoD" in name:
        return "h2d"
    if "Memcpy DtoH" in name:
        return "d2h"
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    if any(s in name for s in ("xmma", "fft", "conv", "pointwise_mult_and_sum", "gemm",
                               "cutlass", "fprop", "dgrad", "wgrad", "nchwToNhwc",
                               "nhwcToNchw", "winograd")):
        return "convolution"
    if "max_pool" in name:
        return "max_pool"
    if "upsample" in name:
        return "upsample"
    if "multi_tensor_apply" in name or "foreach" in name:
        return "optimizer"
    return "other"


@dataclass
class Trace:
    """What one traced window read."""

    window_s: float
    busy_s: float
    by_name: dict[str, float] = field(default_factory=dict)  # device seconds
    by_group: dict[str, float] = field(default_factory=dict)
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)  # label, seconds

    def device_ops(self, n: int = 10) -> list[list]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged ``(M, 2)`` intervals of ``(N, 2)`` ones."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    starts_new = np.r_[True, iv[1:, 0] > ends[:-1]]
    idx = np.flatnonzero(starts_new)
    return np.stack([iv[idx, 0], np.r_[ends[idx[1:] - 1], ends[-1]]], axis=1)


class Spans:
    """Host spans recorded by the benchmark's wrappers (`annotate`) while a
    window is open, on the profiler's clock (``time.time_ns``)."""

    def __init__(self) -> None:
        self.open = False
        self.items: list[tuple[str, int, int, int]] = []  # label, start, end, thread

    def record(self, label: str, start: int, end: int) -> None:
        if self.open:
            self.items.append((label, start, end, threading.get_ident()))


def read(prof, spans: Spans, w0: int, w1: int, thread: int | None = None,
         max_labelled_gaps: int = 4000) -> Trace:
    """The `Trace` of a finished CUDA ``torch.profiler.profile`` over the
    window ``[w0, w1]`` (ns); idle gaps are labelled by the innermost span
    of ``thread`` (any thread when None) open at their middle."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda and not name.startswith(_ANNOTATION_PREFIXES):
            dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    by_name: dict[str, float] = collections.defaultdict(float)
    iv = []
    for name, s, t in dev:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            by_name[name] += (t - s) / 1e9
            iv.append((s, t))
    busy = _union(np.asarray(iv, np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    by_group: dict[str, float] = collections.defaultdict(float)
    for name, s in by_name.items():
        by_group[group_of(name)] += s
    # Idle gaps: the window outside the busy union.
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:max_labelled_gaps]
    ann = [(n, s, t) for n, s, t, th in spans.items if thread is None or th == thread]
    a_start = np.asarray([s for _, s, _ in ann], np.float64)
    a_end = np.asarray([t for _, _, t in ann], np.float64)
    labels: dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = np.flatnonzero((a_start <= mid) & (a_end >= mid))
        label = "outside the benchmark's spans"
        if len(inside):
            label = ann[inside[np.argmin(a_end[inside] - a_start[inside])]][0]
        labels[label] += (g1 - g0) / 1e9
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:10]
    return Trace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_s,
        by_name=dict(by_name), by_group=dict(by_group), idle_gaps=[[k, v] for k, v in idle],
    )


class Window:
    """A CUDA-only profiler over a window of the run (host ops are not
    recorded, which would slow a host-paced loop several-fold); the
    benchmark's own `Spans` label the idle gaps. `start` and `stop` may be
    called at any unit boundary; `read` afterwards."""

    def __init__(self, spans: Spans) -> None:
        self.spans = spans
        self.prof = None
        self.w0 = self.w1 = 0
        self.thread = threading.get_ident()

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so that its first start (the
        CUPTI set-up, about a second) falls in set-up and not in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.open = True
        self.w0 = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.w1 = time.time_ns()
        self.spans.open = False
        self.prof.__exit__(None, None, None)

    def read(self) -> Trace:
        return read(self.prof, self.spans, self.w0, self.w1, self.thread)


def annotate(obj, attr: str, label: str, spans: Spans) -> None:
    """Wrap ``obj.attr`` (a function or method) so that each call records a
    host span named ``label`` in ``spans``: the benchmark's spans around
    calls into the program's layers, set only in the traced run."""
    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            spans.record(label, t0, time.time_ns())

    setattr(obj, attr, wrapped)
