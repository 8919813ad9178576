"""Offline indexing of a recorded scan through ``index query``'s streamed path.

Set-up draws the weights, the dictionary and a ``scan_rows x scan_cols``
grain map of uint8 patterns in host memory, builds the port's VAE,
dictionary and `IndexPipeline` (the fused engine), and runs one slab. The
window then streams the scan, wrapping round, as ``cmd_query`` does: a host
thread (`prefetch_host`) prepares ``slab`` patterns at a time while
`IndexPipeline.__call__` indexes the previous slab in batches of
``batch``. A slab counts once its results have reached the host inside the
window. From each completed slab a few rows are kept, drawn from the seed;
after the window a sample of them is compared with the reference
(`check.candidate_numbers`).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from port_bench import check, gen, program, yardstick
from port_bench.reference import vae as ref
from port_bench.spec import Readings

__all__ = ["Cell", "run"]


class Cell:
    """The set-up of one index cell."""

    def __init__(self, ctx) -> None:
        cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
        self.params = gen.weights(ref.param_layout(cfg), device, ctx.seed)
        self.vectors, self.euler, self.phases = gen.dictionary(cfg, device, ctx.seed)
        self.scan = gen.scan(cfg, traffic, device, ctx.seed)
        if len(self.scan) % traffic["slab"]:
            raise ValueError("the scan has to hold a whole number of slabs")
        net = program.model(cfg, self.params, device)
        db = program.database(cfg, self.vectors, self.euler, self.phases, device,
                              str(ctx.bench.folder / ".no_dictionary"))
        self.pipe = program.pipeline(cfg, net, db, traffic["batch"], device)


def _slabs(scan: np.ndarray, slab: int, stop: threading.Event):
    """``(start, patterns)`` slabs of the scan, wrapping round, until
    ``stop``, prepared as ``cmd_query`` prepares them."""
    from latice_tpu_torch.data import prepare_patterns

    start = 0
    while not stop.is_set():
        part = scan[start : start + slab]
        yield start, prepare_patterns(part, part.shape[1:])
        start = (start + len(part)) % len(scan)


def _annotate(pipe, spans) -> None:
    """Host spans around the pipeline's layers, for the traced run."""
    from latice_tpu_torch.index import pipeline as pipeline_mod

    from port_bench import trace

    trace.annotate(pipe, "_encode", "bench:encoder", spans)
    trace.annotate(pipe, "_search", "bench:search", spans)
    trace.annotate(pipe, "consensus", "bench:consensus", spans)
    trace.annotate(pipeline_mod, "device_batches", "bench:host_batches", spans)
    trace.annotate(pipeline_mod, "collect_results", "bench:collect", spans)


def _keep_latents(pipe) -> list:
    """Wrap the pipeline's encoder so that each batch's ``mu``, as the
    search receives it, is appended to the returned list."""
    encode, mus = pipe._encode, []

    def keep(patterns):
        mu = encode(patterns)
        mus.append(mu)
        return mu

    pipe._encode = keep
    return mus


def run(ctx) -> Readings:
    import torch
    from latice_tpu_torch.data import prefetch_host, prepare_patterns

    cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
    cell = Cell(ctx)
    pipe, scan, slab = cell.pipe, cell.scan, traffic["slab"]
    mus = _keep_latents(pipe)
    pipe(prepare_patterns(scan[:slab], scan.shape[1:]))  # builds the kernels, warms every shape
    mus.clear()
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed & (2**64 - 1), gen.SAMPLE]))
    # The rows kept from the s-th slab: row s of a table drawn from the seed,
    # also on the device, where each slab's latents are gathered.
    table = np.stack([rng.choice(slab, traffic["keep_per_slab"], replace=False) for _ in range(256)])
    table_dev = torch.as_tensor(table, device=device)
    program.sync(device)
    spans = None
    if ctx.trace:
        from port_bench import trace

        trace.Window.warm()
        spans = trace.Spans()
        _annotate(pipe, spans)
    program.reset_memory(device)
    kept: list[tuple[np.ndarray, tuple]] = []
    latents = []
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
            called = time.time_ns()
            res = pipe(patterns)
            if spans is not None:
                spans.record("bench:pipeline", called, time.time_ns())
            if time.time() - t0 > ctx.seconds:
                break
            done += len(patterns)
            traced += len(patterns) if watch.active else 0
            rows = table[len(kept) % len(table)]
            latents.append(torch.cat(mus).index_select(0, table_dev[len(kept) % len(table)]))
            mus.clear()
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
    latents = torch.cat(latents).cpu().numpy()
    del pipe, cell.pipe, mus
    program.free(device)

    pick = rng.choice(sum(len(k[0]) for k in kept), min(traffic["sample"], sum(len(k[0]) for k in kept)),
                      replace=False)
    where = np.concatenate([k[0] for k in kept])[pick]
    fields = [np.concatenate([k[1][i] for k in kept])[pick] if kept[0][1][i] is not None else None
              for i in range(len(kept[0][1]))]
    mean, best, success, n_similar, indices, scores, phase = fields
    best_q, mean_q = check.program_quats(best, mean)
    dic = check.Dictionary(cell.vectors, cell.euler, cell.phases if len(cfg["phases"]) > 1 else None,
                           cfg["phases"], device)
    out = dict(latents=latents[pick], scores=scores, indices=indices, success=success,
               n_similar=n_similar, best_q=best_q, mean_q=mean_q, phase=phase)
    numbers = check.candidate_numbers(cfg, cell.params, dic, cell.scan[where], out, device)
    batches = done // traffic["batch"]
    return Readings(
        cfg=cfg, traffic=traffic, setup_s=setup_s, window_s=window_s, attempted=done, failed=0,
        memory_peak_bytes=memory, checks=numbers,
        work={"patterns": done, "batches": batches},
        traced={"patterns": traced, "batches": -(-traced // traffic["batch"])},
        trace=tr, host=host, power_limit_w=yardstick.power_limit_w() if device == "cuda" else None,
        inputs=dict(params=cell.params, dic=dic, patterns=cell.scan[where], out=out),
    )
