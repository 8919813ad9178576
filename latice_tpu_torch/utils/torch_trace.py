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

A CPU-only trace has no kernels: read it with ``category="cpu_op"``.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from dataclasses import dataclass, field

__all__ = ["OpTime", "TraceSummary", "summarize_trace", "format_summary"]

_PATTERNS = ("*.json", "*.json.gz")


@dataclass
class OpTime:
    """Aggregated time of one op (kernel or host op) across the trace."""

    name: str
    total_ms: float
    count: int

    @property
    def per_iteration_ms(self) -> float:  # populated via TraceSummary
        return self.total_ms


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
    trace_file = _find_trace_file(path)
    categories = {category} if isinstance(category, str) else set(category)
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data

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


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("path", help="utils.trace directory or a Chrome trace file")
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--category", default="kernel",
                   help="event category to sum (kernel, gpu_memcpy, cpu_op, ...)")
    args = p.parse_args(argv)
    summary = summarize_trace(args.path, args.iterations, category=args.category)
    print(format_summary(summary, top=args.top))


if __name__ == "__main__":
    main()
