"""Pattern dictionary indexing (DI) of a recorded scan, at a published
dictionary size, through the ``di`` CLI's path.

Set-up draws the dictionary on the device (`gen_di.dictionary`: the
configuration's ``dictionary_rows`` orientations and their clean uint8
patterns), builds the port's `PatternDictionaryIndexer` from that stack as
``cmd_di`` does (the configuration's bin, engine, search dtype, top n and
consensus), copies the stack to the host for the check and frees it on the
device; then draws the scan as `scan_index` does and runs one slab. The
window streams the scan as `scan_index` does: a host thread
(`prefetch_host`) prepares ``slab`` patterns at a time while the indexer
indexes the previous slab in batches of ``batch``. A slab counts once its
results have reached the host inside the window. From each completed slab
a few rows are kept, drawn from the seed, with the features the search
received for them; after the window a sample of them is compared with the
reference (`check_di.numbers`).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from port_bench import check, check_di, gen, gen_di, program, yardstick
from port_bench.kinds.scan_index import _annotate, _slabs
from port_bench.spec import Readings

__all__ = ["Cell", "run"]


class Cell:
    """The set-up of one DI cell."""

    def __init__(self, ctx) -> None:
        from latice_tpu_torch.index import PatternDictionaryIndexer

        cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
        stack, self.euler, phases = gen_di.dictionary(cfg, traffic, device, ctx.seed)
        multi = len(cfg["phases"]) > 1
        self.phases = phases if multi else None
        phase_kw = dict(dictionary_phases=phases, phase_symmetries=list(cfg["phases"])) if multi else {}
        self.indexer = PatternDictionaryIndexer(
            stack, self.euler, bin_factor=cfg["bin_factor"], engine=cfg["engine"],
            search_dtype=cfg["search_dtype"], top_n=cfg["top_n"],
            orientation_threshold=cfg["threshold_deg"], min_required_matches=cfg["min_matches"],
            max_iterations=cfg["max_iterations"], batch_size=traffic["batch"], device=device,
            **phase_kw,
        )
        self.dictionary = stack.cpu().numpy()
        del stack
        program.free(device)
        self.scan = gen.scan(cfg, traffic, device, ctx.seed)
        if len(self.scan) % traffic["slab"]:
            raise ValueError("the scan has to hold a whole number of slabs")


class _Keeper:
    """Wraps the pipeline's feature step so that, while a slab is indexed,
    the features of its kept rows (row ``t`` of ``table``, sorted, as the
    search receives them) are gathered on the device batch by batch; the
    positions are on the device before the window, so nothing syncs."""

    def __init__(self, pipe, table: np.ndarray, slab: int, batch: int, device) -> None:
        import torch

        self.encode, pipe._encode = pipe._encode, self
        self.positions = [torch.as_tensor(rows % batch, device=device) for rows in table]
        edges = np.arange(0, slab + 1, batch)
        self.bounds = [np.searchsorted(rows, edges) for rows in table]
        self.row = None
        self.step = 0
        self.kept: list = []

    def start(self, t: int | None) -> None:
        self.row, self.step = t, 0

    def __call__(self, patterns):
        f = self.encode(patterns)
        if self.row is not None:
            lo, hi = self.bounds[self.row][self.step : self.step + 2]
            if hi > lo:
                self.kept.append(f.index_select(0, self.positions[self.row][lo:hi]))
            self.step += 1
        return f


def run(ctx) -> Readings:
    import torch
    from latice_tpu_torch.data import prefetch_host, prepare_patterns

    cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
    cell = Cell(ctx)
    indexer, scan, slab = cell.indexer, cell.scan, traffic["slab"]
    pipe = indexer.pipeline
    indexer(prepare_patterns(scan[:slab], scan.shape[1:]))  # builds the kernels, warms every shape
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed & (2**64 - 1), gen.SAMPLE]))
    # The rows kept from the s-th slab: row s of a table drawn from the seed.
    table = np.sort(np.stack([rng.choice(slab, traffic["keep_per_slab"], replace=False)
                              for _ in range(256)]), axis=1)
    keeper = _Keeper(pipe, table, slab, traffic["batch"], device)
    program.sync(device)
    spans = None
    if ctx.trace:
        from port_bench import trace

        trace.Window.warm()
        spans = trace.Spans()
        _annotate(pipe, spans)
    program.reset_memory(device)
    kept: list[tuple[np.ndarray, tuple]] = []
    stop = threading.Event()
    slabs = prefetch_host(_slabs(scan, slab, stop))
    done = traced = 0
    host0 = program.host_counters()
    t0 = time.time()
    setup_s = t0 - ctx.t0
    watch = program.Stopwatch(spans, traffic["trace_start_s"], traffic["trace_s"], t0)
    try:
        while True:
            watch.tick()
            wait = time.time_ns()
            start, patterns = next(slabs)
            if spans is not None:
                spans.record("bench:wait_for_slab", wait, time.time_ns())
            n_kept = len(keeper.kept)
            keeper.start(len(kept) % len(table))
            called = time.time_ns()
            res = indexer(patterns)
            if spans is not None:
                spans.record("bench:pipeline", called, time.time_ns())
            if time.time() - t0 > ctx.seconds:
                del keeper.kept[n_kept:]
                break
            done += len(patterns)
            traced += len(patterns) if watch.active else 0
            rows = table[len(kept) % len(table)]
            kept.append(((start + rows) % len(scan), tuple(
                None if f is None else f[rows] for f in res)))
    finally:
        stop.set()
        slabs.close()
        watch.stop()
    program.sync(device)
    window_s = ctx.seconds
    memory = program.memory_peak(device)
    tr = watch.read()
    host = program.host_counters(host0, window_s)
    features = torch.cat(keeper.kept).cpu().numpy()
    del pipe, indexer, cell.indexer, keeper
    program.free(device)

    total = sum(len(k[0]) for k in kept)
    pick = rng.choice(total, min(traffic["sample"], total), replace=False)
    where = np.concatenate([k[0] for k in kept])[pick]
    fields = [np.concatenate([k[1][i] for k in kept])[pick] if kept[0][1][i] is not None else None
              for i in range(len(kept[0][1]))]
    mean, best, success, n_similar, indices, scores, phase = fields
    best_q, mean_q = check.program_quats(best, mean)
    dic = check_di.Dictionary(cell.dictionary, cell.euler, cell.phases, cfg["phases"],
                              cfg["bin_factor"], device)
    out = dict(features=features[pick], scores=scores, indices=indices, success=success,
               n_similar=n_similar, best_q=best_q, mean_q=mean_q, phase=phase)
    numbers = check_di.numbers(cfg, dic, cell.scan[where], out, device)
    batches = done // traffic["batch"]
    return Readings(
        cfg=cfg, traffic=traffic, setup_s=setup_s, window_s=window_s, attempted=done, failed=0,
        memory_peak_bytes=memory, checks=numbers,
        work={"patterns": done, "batches": batches},
        traced={"patterns": traced, "batches": -(-traced // traffic["batch"])},
        trace=tr, host=host, power_limit_w=yardstick.power_limit_w() if device == "cuda" else None,
        inputs=dict(dic=dic, patterns=cell.scan[where], out=out),
    )
