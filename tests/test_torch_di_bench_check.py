"""The comparison that decides ``correct`` in the benchmark's DI cell
(``port_bench/check_di.py`` against ``port_bench/limits/ni-di-scan-index.json``),
on the CPU at the cell's pattern size with a small dictionary: the port's
DI passes every limit; the reference one precision down (bf16 features,
float8 search operands, a bf16 consensus), a search whose running sums are
rounded to bfloat16 and a search whose scores are rounded to bfloat16 each
fail at least one. Then the cell's three metric readers on hand-built
readings, and on a program without K5.
"""

from __future__ import annotations

import types
from pathlib import Path

import pytest
import torch

from latice_tpu_torch.index import PatternDictionaryIndexer
from port_bench import check, check_di, gen, gen_di, spec

ROOT = Path(__file__).resolve().parents[1]
CELL = "ni-di-scan-index"


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.fixture(scope="module")
def case():
    state, threads = torch.random.get_rng_state(), torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    bench = spec.Benchmark(ROOT)
    cell = bench.workload(CELL)
    cfg = dict(bench.config(cell["config"]), dictionary_rows=384)
    traffic = dict(bench.traffic(cell["traffic"]), scan_rows=2, scan_cols=16, grains=3,
                   dictionary_chunk=128)
    stack, euler, _ = gen_di.dictionary(cfg, traffic, "cpu", 2**31 + 7)
    patterns = gen.scan(cfg, traffic, "cpu", 2**31 + 7)
    di = PatternDictionaryIndexer(stack, euler, bin_factor=cfg["bin_factor"], engine=cfg["engine"],
                                  search_dtype=cfg["search_dtype"], top_n=cfg["top_n"],
                                  batch_size=16, device="cpu")
    res = di(patterns)
    best_q, mean_q = check.program_quats(res.best_orientation, res.mean_orientation)
    out = dict(features=di.pipeline.encode(patterns), scores=res.scores, indices=res.indices,
               success=res.success, n_similar=res.n_similar, best_q=best_q, mean_q=mean_q,
               phase=None)
    dic = check_di.Dictionary(stack.numpy(), euler, None, cfg["phases"], cfg["bin_factor"], "cpu",
                              block=100)
    yield dict(cfg=cfg, dic=dic, patterns=patterns, out=out, limits=bench.limits(CELL))
    torch.random.set_rng_state(state)
    torch.set_num_threads(threads)


def test_the_port_passes(case):
    numbers = check_di.numbers(case["cfg"], case["dic"], case["patterns"], case["out"], "cpu")
    assert set(numbers) == set(case["limits"])
    assert not _fails(numbers, case["limits"]), numbers


def test_the_control_fails(case):
    control = check_di.control_outputs(case["cfg"], case["dic"], case["patterns"], "cpu")
    numbers = check_di.numbers(case["cfg"], case["dic"], case["patterns"], control, "cpu")
    assert _fails(numbers, case["limits"]), numbers


@pytest.mark.parametrize("fault", ["bf16_sums", "bf16_scores"])
def test_a_bf16_search_fails(case, fault):
    planted = check_di.planted_outputs(case["cfg"], case["dic"], case["out"]["features"], "cpu",
                                       fault)
    numbers = check_di.numbers(case["cfg"], case["dic"], case["patterns"], planted, "cpu")
    assert numbers["search_score_gap"] > case["limits"]["search_score_gap"], numbers


def _traced(by_name: dict, patterns: int, window_s: float = 2.0):
    """Readings of a traced DI run with ``patterns`` in the window."""
    bench = spec.Benchmark(ROOT)
    cell = bench.workload(CELL)
    trace = types.SimpleNamespace(window_s=window_s, by_name=by_name)
    return types.SimpleNamespace(cfg=bench.config(cell["config"]), traffic=bench.traffic(cell["traffic"]),
                                 trace=trace, traced={"patterns": patterns, "batches": patterns // 256})


def test_the_di_readers():
    bench = spec.Benchmark(ROOT)
    r = _traced({"k5_cosine_topk_partial": 0.9, "k5_cosine_topk_merge": 0.1, "other": 5.0}, 256 * 100)
    flops = 2.0 * 333_227 * 16_384
    assert bench.reader("mfu.di")(r) == pytest.approx(100 * 25_600 * flops / (2.0 * 989e12))
    bound = max((2.0 * (333_227 + 256) * 16_384 + 12 * 256 * 20) / 3.35e12,
                2.0 * 256 * 333_227 * 16_384 / 989e12)
    assert bench.reader("k5_roofline.di")(r) == pytest.approx(100 * 100 * bound / 1.0)
    # A program without K5 (the parent's exact engine): nothing to read.
    assert bench.reader("k5_roofline.di")(_traced({"other": 5.0}, 25_600)) is None
    for name in ("mfu.di", "k5_roofline.di", "k5.launches_per_batch.di"):
        assert bench.reader(name)(_traced({}, 0) if name != "k5.launches_per_batch.di"
                                  else types.SimpleNamespace(trace=None)) is None


def test_the_launch_reader_reads_the_windows_record(monkeypatch):
    from latice_tpu_torch.utils import profiling
    from latice_tpu_torch.utils.profiling import Record

    read = spec.Benchmark(ROOT).reader("k5.launches_per_batch.di")
    traced = types.SimpleNamespace(trace=object())
    rec = Record()
    rec.count("index.batches", 4)
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert read(traced) is None  # no K5 counter: a program older than K5
    rec.count("search.k5_launches", 4)
    assert read(traced) == 1.0
    monkeypatch.setattr(profiling, "recorded", lambda: None)
    assert read(traced) is None
