"""The control: the reference one precision below the configuration's, put in
the program's place, has to come out as not correct.

On the CPU at the cells' widths with a few patterns; on a
card (``-m card``) at each cell's own size, on three seeds, through the same
readings that set the limits.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from port_bench import check, gen, readings, spec
from port_bench.reference import vae as ref

ROOT = Path(__file__).resolve().parents[2]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("workload", ["ref-scan-index", "scaled-scan-index"])
def test_index_control_is_not_correct_on_the_cpu(workload):
    torch.set_num_threads(4)
    bench = spec.Benchmark(ROOT)
    cell = bench.workload(workload)
    cfg, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    params = gen.weights(ref.param_layout(cfg), "cpu", 21)
    vectors, euler, phases = gen.dictionary(cfg, "cpu", 21)
    patterns = gen.scan(cfg, dict(traffic, scan_rows=2, scan_cols=8, grains=2), "cpu", 21)
    dic = check.Dictionary(vectors, euler, phases if len(cfg["phases"]) > 1 else None,
                           cfg["phases"], "cpu")
    control = check.control_outputs(cfg, params, dic, patterns, "cpu")
    numbers = check.candidate_numbers(cfg, params, dic, patterns, control, "cpu")
    assert _fails(numbers, bench.limits(workload)), numbers


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ref-scan-index", "scaled-scan-index"])
def test_control_is_not_correct_at_the_cells_size(card, workload):
    bench = spec.Benchmark(ROOT)
    cell = bench.workload(workload)
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        ctx = spec.Context(bench=bench, cell=cell, cfg=bench.config(cell["config"]), traffic=traffic,
                           seed=seed, seconds=3.0, trace=False, device=card, t0=time.time())
        r = bench.runner(cell).run(ctx)
        assert not _fails(r.checks, limits), r.checks
        control = readings.upper(ctx, r)["control"]
        assert _fails(control, limits), json.dumps(control)
