"""Profiling hooks, the port of ``latice_tpu.utils.profiling``:
``torch.profiler`` capture around any phase, program spans and counters
recorded while a profiler runs, and a phase timer whose reports feed the
metrics loggers.

Spans and counters (`span`, `count`, `recorded`) label the host side of a
device trace. They record only while a ``torch.profiler`` session is
collecting; otherwise a span costs one flag read and allocates nothing.
Times are ``time.time_ns()``, the clock of the profiler's own events, so a
span encloses the host ops and launches made inside it. While an
outermost span is open, CUDA's sync-debug mode is set to ``"warn"`` and
each blocking host wait on the stream (a pageable copy, ``.cpu()``,
``.item()``, ``synchronize``) is counted against the innermost span open
on its thread, instead of being printed (where CUDA was initialised when
the outermost span opened).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
import warnings
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger(__name__)

__all__ = ["trace", "PhaseTimer", "Record", "SpanRecord", "count", "device_sync", "recorded",
           "span"]

SPAN_LIMIT = 1_000_000  # spans kept in one record; later ones are counted as dropped
_SYNC_MESSAGE = "called a synchronizing CUDA operation"  # c10's sync-debug warning
_PROTOTYPE_MESSAGE = "Synchronization debug mode is a prototype feature"  # once, on first use


class SpanRecord(NamedTuple):
    """One closed span. ``parent`` is 0 for an outermost span, ``root`` the
    id of the outermost span it belongs to (its own id when outermost), and
    ``syncs`` the stream syncs made while it was the innermost open span."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident()
    id: int
    parent: int
    root: int
    syncs: int


class Record:
    """The spans and counters of one profiler session, kept in memory."""

    def __init__(self, limit: int = SPAN_LIMIT) -> None:
        self.limit = limit
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0
        self.unattributed_syncs = 0  # syncs outside every span of their thread (`--idle`)
        self.threads: dict[int, int] = {}  # threading.get_ident() -> native thread id
        self._lock = threading.Lock()

    @property
    def items(self) -> list[tuple[str, int, int, int]]:
        """``(name, start_ns, end_ns, thread)`` of each span."""
        return [(s.name, s.start_ns, s.end_ns, s.thread) for s in self.spans]

    def add(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self.spans) < self.limit:
                self.spans.append(rec)
            else:
                self.dropped += 1

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def unattributed_sync(self) -> None:
        with self._lock:
            self.unattributed_syncs += 1


class _Recorder:
    """The process's span recorder: the newest `Record`, each thread's
    stack of open spans, and the sync counting that the outermost spans
    switch on and off."""

    def __init__(self) -> None:
        self.record: Record | None = None
        self.fresh = True  # a span found the profiler off: the next one starts a record
        self.local = threading.local()
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.roots = 0  # outermost spans open, over all threads
        self.restore = None  # (sync-debug mode, showwarning, filter) while counting syncs

    def start(self) -> Record:
        with self.lock:
            self.record, self.fresh = Record(), False
            return self.record

    def current(self) -> Record:
        if self.fresh or self.record is None:
            with self.lock:
                if self.fresh or self.record is None:
                    self.record, self.fresh = Record(), False
        return self.record

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def root_opened(self) -> None:
        with self.lock:
            self.roots += 1
            if self.roots == 1 and torch.cuda.is_initialized():  # initialised: available
                show = warnings.showwarning
                warnings.filterwarnings("always", message=_SYNC_MESSAGE)
                self.restore = (torch.cuda.get_sync_debug_mode(), show, warnings.filters[0])
                warnings.showwarning = self.on_warning
                torch.cuda.set_sync_debug_mode("warn")

    def root_closed(self) -> None:
        with self.lock:
            self.roots -= 1
            if self.roots == 0 and self.restore is not None:
                mode, show, entry = self.restore
                self.restore = None
                torch.cuda.set_sync_debug_mode(mode)
                if warnings.showwarning == self.on_warning:
                    warnings.showwarning = show
                with contextlib.suppress(ValueError):
                    warnings.filters.remove(entry)

    def on_warning(self, message, category, filename, lineno, file=None, line=None) -> None:
        """``warnings.showwarning`` while syncs are counted: a sync warning
        counts against the innermost span of its thread (and is shown only
        where the sync-debug mode was already "warn"); others pass on."""
        restore = self.restore
        show = warnings._showwarning_orig if restore is None else restore[1]
        text = str(message)
        if text.startswith(_PROTOTYPE_MESSAGE):
            return
        if not text.startswith(_SYNC_MESSAGE):
            show(message, category, filename, lineno, file, line)
            return
        stack = getattr(self.local, "stack", None)
        if stack:
            stack[-1].syncs += 1
        elif self.record is not None:
            self.record.unattributed_sync()
        if restore is not None and restore[0]:
            show(message, category, filename, lineno, file, line)


_recorder = _Recorder()


class span:
    """A named host span, recorded while a ``torch.profiler`` session runs.

    ``with span("index:encode"): ...`` records the name, the start and end
    (``time.time_ns``), the thread, the span's id, its parent's (the
    innermost span open on the same thread) and its outermost span's, and
    the stream syncs made while it was innermost. With no profiler
    running it is one flag read and a shared no-op. A span must close in
    the frame that opened it: never ``yield`` inside one. It does not call
    ``record_function``, so it leaves the device trace as it is.
    """

    __slots__ = ("name", "record", "id", "parent", "root", "thread", "syncs", "start_ns")

    def __new__(cls, name: str):
        if not _profiler._is_profiler_enabled:
            _recorder.fresh = True
            return _OFF
        self = object.__new__(cls)
        self.name = name
        return self

    def __enter__(self):
        rec = _recorder
        self.record = rec.current()
        stack = rec.stack()
        self.id = next(rec.ids)
        self.thread = threading.get_ident()
        self.syncs = 0
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
            self.record.threads.setdefault(self.thread, threading.get_native_id())
            rec.root_opened()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        stack = _recorder.stack()
        stack.pop()
        self.record.add(SpanRecord(self.name, self.start_ns, end, self.thread, self.id,
                                   self.parent, self.root, self.syncs))
        if not stack:
            _recorder.root_closed()


class _Off(span):
    """The span handed out while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = object.__new__(_Off)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current record, while a
    profiler session runs."""
    if not _profiler._is_profiler_enabled:
        _recorder.fresh = True
        return
    _recorder.current().count(name, int(n))


def recorded() -> Record | None:
    """The newest record (None before any).

    torch gives a profiler session no identity to read, so a record starts
    at `trace()`'s entry, or at the first span or count that finds a
    session running after one found none. Two sessions with no span or
    count called between them therefore share a record, and a session
    that records nothing leaves the one before it as the newest: a caller
    that reads one session's record either uses `trace()` or runs the
    instrumented code once between its sessions.
    """
    return _recorder.record


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

    A new `Record` starts on entry; its spans are written into the trace as
    complete events of category ``program_span`` on the kernels' time base,
    with the counters, the dropped spans and the window under the top-level
    key ``programRecord``.

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
    record = _recorder.start()
    w0 = time.time_ns()
    try:
        yield prof
    finally:
        device_sync()
        w1 = time.time_ns()
        prof.__exit__(None, None, None)
        path = log_dir / f"{name or 'trace'}-{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        _write_spans(path, record, w0, w1)
        logger.info(f"Trace '{name or 'phase'}' written to {path}")


def _write_spans(path: Path, record: Record, w0: int, w1: int) -> None:
    """Add ``record``'s spans and totals to the Chrome trace at ``path``."""
    data = json.loads(path.read_text())
    if isinstance(data, list):
        data = {"traceEvents": data}
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    data["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
         "tid": record.threads.get(s.thread, s.thread), "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "root": s.root, "syncs": s.syncs}}
        for s in record.spans
    )
    data["programRecord"] = {"counters": dict(record.counters), "dropped": record.dropped,
                             "unattributed_syncs": record.unattributed_syncs,
                             "window_ns": [w0 - base, w1 - base]}
    path.write_text(json.dumps(data))


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
