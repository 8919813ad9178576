"""Trace summarization: turn a ``torch.profiler`` Chrome trace into per-op
numbers, in place of ``latice_tpu.utils.xla_trace``.

`utils.profiling.trace` writes a Chrome trace (``*.json``; ``*.json.gz``
is read too) whose duration events (``"ph": "X"``) carry a category:
``kernel`` for CUDA kernels, ``gpu_memcpy`` / ``gpu_memset`` for copies,
``cpu_op`` for host ATen ops. This module sums the events of one category
by name, so a headless run reads device time per op without a viewer.

Usage::

    from latice_tpu_torch.utils import trace, summarize_trace, format_summary
    with trace("/tmp/trace"):             # utils.profiling context manager
        run_workload()                    # repeat N times for stable stats
    print(format_summary(summarize_trace("/tmp/trace", iterations=N)))

or from the shell::

    python -m latice_tpu_torch.utils.torch_trace /tmp/trace --iterations 5

A CPU-only trace has no kernels: read it with ``category="cpu_op"``. The
program's own spans (`utils.profiling.span`) are events of category
``program_span`` (``--category program_span``), and `idle_by_span`
(``--idle``) groups the device's idle time by the span it fell in.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from dataclasses import dataclass, field

import numpy as np

__all__ = ["IdleBySpan", "OpTime", "TraceSummary", "format_idle", "format_summary",
           "idle_by_span", "summarize_trace"]

_PATTERNS = ("*.json", "*.json.gz")
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside the program's spans"


@dataclass
class OpTime:
    """Aggregated time of one op (kernel or host op) across the trace."""

    name: str
    total_ms: float
    count: int


@dataclass
class TraceSummary:
    """Per-op time of one captured trace."""

    trace_file: str
    iterations: int
    total_ms: float  # sum over ops, per iteration
    ops: list[OpTime] = field(default_factory=list)  # sorted, slowest first


def _find_trace_file(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = [h for pat in _PATTERNS
            for h in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        raise FileNotFoundError(
            f"no *.json or *.json.gz trace under {path!r}: pass the directory "
            "given to utils.trace (or a trace file directly)"
        )
    return max(hits, key=os.path.getmtime)  # latest capture


def _load(path: str) -> tuple[str, dict]:
    """The trace file under ``path`` and its JSON, as a dict."""
    trace_file = _find_trace_file(path)
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        data = json.load(f)
    return trace_file, data if isinstance(data, dict) else {"traceEvents": data}


def summarize_trace(
    path: str, iterations: int = 1, category: str | tuple[str, ...] = "kernel"
) -> TraceSummary:
    """Aggregate per-op time from a ``torch.profiler`` Chrome trace.

    Args:
        path: the directory given to `utils.trace` (the newest trace file
            inside is read) or a trace file.
        iterations: workload repetitions inside the capture; reported times
            and counts are divided by it.
        category: the event category, or several, to sum: ``"kernel"``
            (device kernels, the default), ``"gpu_memcpy"``,
            ``"gpu_memset"``, ``"cpu_op"`` (host ATen ops).

    Returns:
        `TraceSummary` with ops sorted slowest first, in milliseconds per
        iteration.
    """
    trace_file, data = _load(path)
    categories = {category} if isinstance(category, str) else set(category)
    events = data["traceEvents"]

    totals: dict[str, float] = collections.defaultdict(float)
    counts: collections.Counter[str] = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in categories:
            continue
        name = e["name"]
        totals[name] += float(e.get("dur", 0))  # microseconds
        counts[name] += 1

    it = max(1, iterations)
    ops = [OpTime(name=n, total_ms=d / 1e3 / it, count=counts[n] // it)
           for n, d in totals.items()]
    ops.sort(key=lambda o: -o.total_ms)
    return TraceSummary(
        trace_file=trace_file,
        iterations=it,
        total_ms=sum(o.total_ms for o in ops),
        ops=ops,
    )


def format_summary(summary: TraceSummary, top: int = 20) -> str:
    """Human-readable table of the slowest ops."""
    lines = [
        f"{summary.trace_file}",
        f"total: {summary.total_ms:.3f} ms/iteration "
        f"({len(summary.ops)} ops, {summary.iterations} iterations)",
    ]
    for op in summary.ops[:top]:
        lines.append(f"{op.total_ms:9.3f} ms  x{op.count:<4} {op.name[:100]}")
    if len(summary.ops) > top:
        rest = sum(o.total_ms for o in summary.ops[top:])
        lines.append(f"{rest:9.3f} ms  ... {len(summary.ops) - top} more ops")
    return "\n".join(lines)


@dataclass
class IdleBySpan:
    """The device's idle time inside a traced window, by program span."""

    trace_file: str
    window_s: float
    busy_s: float
    idle: list[tuple[str, float]]  # (span name, idle seconds), most first
    syncs: dict[str, int] = field(default_factory=dict)  # stream syncs by span name
    record: dict = field(default_factory=dict)  # the trace's programRecord, if any


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged ``(M, 2)`` intervals of ``(N, 2)`` ones."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > ends[:-1]])
    return np.stack([iv[first, 0], np.r_[ends[first[1:] - 1], ends[-1]]], axis=1)


def idle_by_span(path: str) -> IdleBySpan:
    """The device's idle seconds in the traced window of a `utils.trace`
    capture, grouped by the innermost program span (the shortest of those
    open on any thread) at the middle of each gap; gaps with none open
    count as `OUTSIDE`. The window is the one `utils.trace` wrote, else
    the extent of the device events and spans."""
    trace_file, data = _load(path)
    dev, spans = [], []
    syncs: dict[str, int] = collections.defaultdict(int)
    for e in data["traceEvents"]:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if e.get("cat") in _DEVICE_CATEGORIES:
            dev.append((ts, ts + dur))
        elif e.get("cat") == "program_span":
            spans.append((e["name"], ts, ts + dur))
            syncs[e["name"]] += int(e.get("args", {}).get("syncs", 0))
    record = data.get("programRecord", {})
    window = record.get("window_ns")
    if window is not None:
        w0, w1 = window[0] / 1e3, window[1] / 1e3
    else:
        ends = [t for iv in dev for t in iv] + [t for _, *iv in spans for t in iv]
        w0, w1 = (min(ends), max(ends)) if ends else (0.0, 0.0)
    iv = np.clip(np.asarray(dev, np.float64).reshape(-1, 2), w0, w1)
    busy = _union(iv[iv[:, 1] > iv[:, 0]])
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    start = np.asarray([s for _, s, _ in spans], np.float64)
    end = np.asarray([t for _, _, t in spans], np.float64)
    idle: dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = np.flatnonzero((start <= mid) & (end >= mid))
        label = spans[inside[np.argmin(end[inside] - start[inside])]][0] if len(inside) else OUTSIDE
        idle[label] += (g1 - g0) / 1e6
    return IdleBySpan(
        trace_file=trace_file, window_s=(w1 - w0) / 1e6,
        busy_s=float((busy[:, 1] - busy[:, 0]).sum()) / 1e6,
        idle=sorted(idle.items(), key=lambda kv: -kv[1]),
        syncs=dict(syncs), record=record,
    )


def format_idle(result: IdleBySpan, top: int = 20) -> str:
    """Human-readable table of the idle time and stream syncs by span,
    then the record's counters. Real rows per batch (``index.patterns``
    over ``index.batches``) below the batch size mean padded batches; the
    syncs outside every span should read 0, or the per-span counts miss
    some."""
    lines = [
        result.trace_file,
        f"window {result.window_s:.6f} s, device busy {result.busy_s:.6f} s, "
        f"idle {result.window_s - result.busy_s:.6f} s",
        f"{'idle':>14}  {'syncs':>7}  span",
    ]
    lines += [f"{s:12.6f} s  {result.syncs.get(name, 0):7d}  {name[:100]}"
              for name, s in result.idle[:top]]
    counters = result.record.get("counters", {})
    lines += [f"counter {name} = {n}" for name, n in sorted(counters.items())]
    if counters.get("index.batches"):
        rows = counters.get("index.patterns", 0) / counters["index.batches"]
        lines.append(f"real rows per batch {rows:.1f}")
    if result.record:
        lines.append(f"syncs outside every span {result.record.get('unattributed_syncs', 0)}, "
                     f"spans dropped {result.record.get('dropped', 0)}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("path", help="utils.trace directory or a Chrome trace file")
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--category", default="kernel",
                   help="event category to sum (kernel, gpu_memcpy, cpu_op, program_span, ...)")
    p.add_argument("--idle", action="store_true",
                   help="the device's idle time grouped by the program span it fell in")
    args = p.parse_args(argv)
    if args.idle:
        print(format_idle(idle_by_span(args.path), top=args.top))
        return
    summary = summarize_trace(args.path, args.iterations, category=args.category)
    print(format_summary(summary, top=args.top))


if __name__ == "__main__":
    main()
