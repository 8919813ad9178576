"""The program's own spans and counters of the profiled window.

`latice_tpu_torch.utils.profiling.recorded()` holds the spans and counters
of the newest ``torch.profiler`` session, which in a ``--trace 1`` run is
the benchmark's window (`trace.Window`): untraced slabs run between
`trace.Window.warm` and the window, so the window starts a record of its
own. Each reading is per batch of the
record's ``index.batches``. Every function returns None where the program
has no recorder (a checkout older than it), where no window was traced, or
where the record counted no batch.
"""

from __future__ import annotations

__all__ = ["ms_per_batch", "syncs_per_batch"]


def _record(r):
    """The record of the profiled window, or None."""
    if r.trace is None:
        return None
    try:
        from latice_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    if rec is None or not rec.counters.get("index.batches"):
        return None
    return rec


def ms_per_batch(r, name: str, within: str | None = None) -> float | None:
    """Milliseconds of the spans ``name`` per batch; with ``within``, only
    those on threads that opened a span of that name."""
    rec = _record(r)
    if rec is None:
        return None
    threads = None if within is None else {s.thread for s in rec.spans if s.name == within}
    ns = sum(s.end_ns - s.start_ns for s in rec.spans
             if s.name == name and (threads is None or s.thread in threads))
    return ns / 1e6 / rec.counters["index.batches"]


def syncs_per_batch(r, name: str) -> float | None:
    """Stream syncs made inside the spans ``name`` and their descendants,
    per batch."""
    rec = _record(r)
    if rec is None:
        return None
    parent = {s.id: s.parent for s in rec.spans}
    named = {s.id for s in rec.spans if s.name == name}
    total = 0
    for s in rec.spans:
        i = s.id
        while i and i not in named:
            i = parent.get(i, 0)
        if i:
            total += s.syncs
    return total / rec.counters["index.batches"]
