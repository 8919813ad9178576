"""The port's program spans and counters (``utils.profiling.span``,
``count``, ``recorded``), the index path's instrumentation, their export
into ``utils.trace``'s Chrome trace, ``torch_trace.idle_by_span`` and the
benchmark's six readers of them, on the CPU; one test for the card.

No JAX here: the card test runs where JAX is absent, with
``python -m pytest tests/test_torch_spans.py -m card --noconftest``.
"""

from __future__ import annotations

import json
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from latice_tpu_torch.data import prefetch_host
from latice_tpu_torch.index import IndexPipeline
from latice_tpu_torch.utils import profiling, summarize_trace, trace
from latice_tpu_torch.utils.profiling import Record, SpanRecord, count, recorded, span
from latice_tpu_torch.utils.torch_trace import OUTSIDE, format_idle, idle_by_span
from latice_tpu_torch.utils.torch_trace import main as trace_main
from port_bench import spec
from port_bench import trace as bench_trace

ROOT = Path(__file__).resolve().parents[1]
ROWS, DIM, SIDE, BATCH, QUERIES = 64, 8, 16, 8, 20  # 20 queries: batches of 8, 8 and 4


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _pipeline(device="cpu") -> IndexPipeline:
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    return IndexPipeline(
        None, vectors, rng.uniform(0, 90, size=(ROWS, 3)), top_n=5, min_required_matches=2,
        batch_size=BATCH, engine="exact", device=device,
        feature_fn=lambda x: x.flatten(1)[:, :DIM].contiguous(),
    )


def _queries() -> np.ndarray:
    return np.random.default_rng(1).integers(0, 256, (QUERIES, SIDE, SIDE), dtype=np.uint8)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One `utils.trace` capture over two pipeline calls, a prefetched
    stream and a matrix product inside a span."""
    pipe, queries = _pipeline(), _queries()
    a = torch.ones(32, 32)
    out = tmp_path_factory.mktemp("spans")
    with trace(out, "spans") as prof:
        pipe(queries)
        pipe(queries[:BATCH])
        items = list(prefetch_host(iter(range(3)), size=1))
        with span("clock"):
            a @ a
        count("tested", 2)
    return dict(record=recorded(), prof=prof, dir=out, items=items, main=threading.get_ident())


def test_no_profiler_records_nothing():
    before = recorded()
    n = None if before is None else len(before.spans)
    with span("a"), span("b"):
        count("c")
    assert span("a") is span("b")  # one shared no-op: nothing allocated
    assert recorded() is before
    assert n is None or len(before.spans) == n


def test_nesting_parents_roots_threads_counters_and_the_bound():
    def worker():
        with span("w"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        count("n")  # starts the record
        rec = recorded()
        with span("outer"), span("inner"), span("leaf"):
            count("n", 4)
        with span("second"):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
        assert not thread.is_alive()
        rec.limit = len(rec.spans) + 1
        for _ in range(3):
            with span("over"):
                pass
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["leaf", "inner", "outer", "w", "second", "over"]
    assert by["outer"].parent == 0 and by["outer"].root == by["outer"].id
    assert by["inner"].parent == by["outer"].id and by["leaf"].parent == by["inner"].id
    assert by["leaf"].root == by["inner"].root == by["outer"].id
    assert by["w"].parent == 0 and by["w"].thread != by["second"].thread == threading.get_ident()
    assert by["outer"].start_ns <= by["leaf"].start_ns <= by["leaf"].end_ns <= by["outer"].end_ns
    assert rec.counters == {"n": 5} and rec.dropped == 2
    assert rec.items[0] == ("leaf", by["leaf"].start_ns, by["leaf"].end_ns, by["leaf"].thread)
    assert all(s.syncs == 0 for s in rec.spans) and rec.unattributed_syncs == 0  # no CUDA
    with span("off"):
        pass  # finds the profiler off: the next session starts a new record
    with profile(activities=[ProfilerActivity.CPU]):
        with span("next"):
            pass
    assert recorded() is not rec and [s.name for s in recorded().spans] == ["next"]
    assert profiling._recorder.roots == 0 and profiling._recorder.restore is None


def test_sessions_with_no_call_between_share_a_record(tmp_path):
    """torch gives a session no identity: back-to-back sessions merge, a
    session that records nothing leaves the one before it, and `trace`
    starts a record of its own."""
    count("k")  # finds the profiler off, so the next session starts a record
    for n in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            with span(f"s{n}"):
                pass
    assert [s.name for s in recorded().spans] == ["s0", "s1"]
    merged = recorded()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.ones(2).sum()
    assert recorded() is merged
    with trace(tmp_path, "own"):
        pass
    assert recorded() is not merged and recorded().spans == []


def test_threads_lose_no_span_or_count():
    """Eight threads at a 1-us switch interval: every span and count lands
    in the record, each span with its own thread's parent."""
    def work():
        for _ in range(200):
            with span("t"), span("u"):
                count("k")

    count("k")  # finds the profiler off, so the session below starts a record
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            rec = recorded()
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters["k"] == 1600 and len(rec.spans) == 3200 and rec.dropped == 0
    by_id = {s.id: s for s in rec.spans}
    assert all(by_id[s.parent].thread == s.thread for s in rec.spans if s.name == "u")
    assert profiling._recorder.roots == 0


def test_index_pipeline_and_prefetch_spans(traced):
    rec = traced["record"]
    names = [s.name for s in rec.spans]
    batches = 3 + 1
    assert names.count("index:call") == 2 and names.count("index:collect") == 2
    for name in ("index:stage", "index:encode", "index:search", "index:consensus"):
        assert names.count(name) == batches, name
    assert rec.counters["index.batches"] == batches
    assert rec.counters["index.patterns"] == QUERIES + BATCH
    assert rec.counters["tested"] == 2
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name.startswith("index:") and s.name != "index:call":
            parent = by_id[s.parent]
            assert parent.name == "index:call" and by_id[s.root] is parent
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    wait = {s.thread for s in rec.spans if s.name == "prefetch:wait"}
    produce = {s.thread for s in rec.spans if s.name == "prefetch:produce"}
    assert traced["items"] == [0, 1, 2]
    assert wait == {traced["main"]} and len(produce) == 1 and produce != wait
    assert names.count("prefetch:wait") == 4 and names.count("prefetch:produce") == 4


def test_spans_share_the_profilers_clock(traced):
    clock = next(s for s in traced["record"].spans if s.name == "clock")
    mm = [e for e in traced["prof"].profiler.kineto_results.events() if e.name() == "aten::mm"]
    inside = [e for e in mm if clock.start_ns <= e.start_ns() <= clock.end_ns]
    assert len(inside) == 1
    assert inside[0].start_ns() + inside[0].duration_ns() <= clock.end_ns


def test_chrome_trace_holds_the_spans_and_idle_by_span_reads_them(traced, capsys):
    s = summarize_trace(str(traced["dir"]), category="program_span")
    got = {op.name: op.count for op in s.ops}
    assert got["index:call"] == 2 and got["index:stage"] == 4 and got["clock"] == 1
    assert len(s.ops) == len(set(x.name for x in traced["record"].spans))
    data = json.loads(Path(s.trace_file).read_text())
    assert data["programRecord"]["counters"]["index.batches"] == 4
    idle = idle_by_span(str(traced["dir"]))  # a CPU trace: the device is idle throughout
    assert idle.busy_s == 0.0 and sum(v for _, v in idle.idle) == pytest.approx(idle.window_s)
    assert {name for name, _ in idle.idle} <= {x.name for x in traced["record"].spans} | {OUTSIDE}
    assert idle.syncs["index:call"] == 0 and idle.record["unattributed_syncs"] == 0
    trace_main([str(traced["dir"]), "--idle"])
    out = capsys.readouterr().out
    assert "device busy 0.000000 s" in out and "counter index.patterns = 28" in out
    assert "real rows per batch 7.0" in out and "syncs outside every span 0" in out


def test_idle_by_span_on_a_hand_trace(tmp_path):
    """Kernels at [0, 10] and [30, 40] us in a 0-60 us window: the gap at
    20 falls in the inner span, the one at 50 in none."""
    def ev(cat, name, ts, dur, syncs=0):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
                "args": {"syncs": syncs}}

    events = [ev("kernel", "k", 0, 10), ev("gpu_memcpy", "Memcpy HtoD", 30, 10),
              ev("program_span", "outer", 5, 40, 1), ev("program_span", "inner", 12, 15, 2),
              ev("program_span", "inner", 27, 1, 3), ev("cpu_op", "aten::mm", 10, 20)]
    path = tmp_path / "t.json"
    record = {"window_ns": [0, 60_000], "counters": {"index.batches": 2, "index.patterns": 300},
              "unattributed_syncs": 4, "dropped": 0}
    path.write_text(json.dumps({"traceEvents": events, "programRecord": record}))
    idle = idle_by_span(str(path))
    assert idle.window_s == pytest.approx(60e-6) and idle.busy_s == pytest.approx(20e-6)
    assert idle.idle == [("inner", pytest.approx(20e-6)), (OUTSIDE, pytest.approx(20e-6))]
    assert idle.syncs == {"outer": 1, "inner": 5}
    lines = format_idle(idle).splitlines()
    assert lines[3].split() == ["0.000020", "s", "5", "inner"]
    assert "real rows per batch 150.0" in lines
    assert "syncs outside every span 4, spans dropped 0" in lines


def test_the_record_is_the_benchmarks_span_layout(traced):
    """`port_bench.trace.read` takes the record as its spans: over the
    window of the "clock" span, the one idle gap is labelled by it."""
    rec = traced["record"]
    clock = next(s for s in rec.spans if s.name == "clock")
    got = bench_trace.read(traced["prof"], rec, clock.start_ns, clock.end_ns, thread=traced["main"])
    assert got.busy_s == 0.0 and [label for label, _ in got.idle_gaps] == ["clock"]


def _hand_record() -> Record:
    rec = Record()
    spans = [  # name, start, end (ms), thread, id, parent, root, syncs
        ("index:stage", 0, 1, 1, 2, 1, 1, 0),
        ("index:consensus", 2, 6, 1, 3, 1, 1, 2),
        ("index:collect", 7, 8, 1, 4, 1, 1, 7),
        ("index:call", 0, 9, 1, 1, 0, 1, 1),
        ("prefetch:wait", 9, 10, 1, 5, 0, 5, 0),
        ("prefetch:produce", 0, 10, 2, 6, 0, 6, 3),
        ("prefetch:wait", 0, 3, 3, 7, 0, 7, 0),  # another thread: not the indexing one
    ]
    for name, t0, t1, thread, i, parent, root, syncs in spans:
        rec.add(SpanRecord(name, t0 * 10**6, t1 * 10**6, thread, i, parent, root, syncs))
    rec.count("index.batches", 2)
    return rec


READERS = {
    "consensus.syncs_per_batch.index": 1.0,
    "pipeline.syncs_per_batch.index": 5.0,
    "consensus.host_ms_per_batch.index": 2.0,
    "pipeline.stage_ms_per_batch.index": 0.5,
    "pipeline.collect_ms_per_batch.index": 0.5,
    "scan.slab_wait_ms_per_batch.index": 0.5,
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_on_a_hand_built_record(metric, monkeypatch):
    read = spec.Benchmark(ROOT).reader(metric)
    traced_run = types.SimpleNamespace(trace=object())
    monkeypatch.setattr(profiling, "recorded", _hand_record)
    assert read(traced_run) == pytest.approx(READERS[metric])
    assert read(types.SimpleNamespace(trace=None)) is None  # no window
    monkeypatch.setattr(profiling, "recorded", Record)  # an empty record
    assert read(traced_run) is None
    monkeypatch.setattr(profiling, "recorded", lambda: None)
    assert read(traced_run) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without a recorder
    assert read(traced_run) is None


def test_the_benchmark_lists_the_readers():
    listed = {m["name"]: m for m in spec.Benchmark(ROOT).data["per_layer"]}
    for metric in READERS:
        assert listed[metric]["workloads"] == ["ref-scan-index", "scaled-scan-index",
                                               "ni-di-scan-index"]
        assert listed[metric]["moves"] == "index_patterns_per_s"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.card
def test_card_counts_a_planted_sync_and_keeps_spans_off_the_device(card, capfd, recwarn):
    torch.zeros(1, device=card)  # CUDA initialised before the window
    mode = torch.cuda.get_sync_debug_mode()
    host = torch.ones(1 << 16)  # pageable: the copy waits on the stream
    pipe, queries = _pipeline(card), _queries()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with span("planted"):
            host.to(card)
        pipe(queries)
    rec = recorded()
    assert [s.syncs for s in rec.spans if s.name == "planted"] == [1]
    assert sum(s.syncs for s in rec.spans if s.name == "index:collect") > 0
    assert torch.cuda.get_sync_debug_mode() == mode
    assert "ynchroniz" not in capfd.readouterr().err
    assert not [w for w in recwarn if "ynchroniz" in str(w.message)]
    names = {s.name for s in rec.spans}
    cuda = torch.autograd.DeviceType.CUDA
    device_names = {e.name() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == cuda}
    assert device_names and not device_names & names
