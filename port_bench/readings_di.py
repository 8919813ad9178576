"""The readings that the DI cells' limits (``port_bench/limits/``) are set
from.

    python3 -m port_bench.readings_di --workload ni-di-scan-index --seeds 1 2 3 ... --seconds 3 [--controls 4]

For each seed, one run of the cell at its own size over a short window, as
``run`` makes it, and the numbers its comparison reads (the lower
readings), with statistics that are not compared. For the first
``--controls`` seeds also the same numbers for the control (the reference
one precision down in the program's place) and for faults planted in the
search (the upper readings): ``bf16_sums`` (running sums rounded to
bfloat16), ``bf16_scores`` (each score rounded to bfloat16) and
``half_dictionary`` (candidates from the first half of the dictionary
only, as a search that skips part of the table returns them).

One JSON line per seed on standard output. Needs a CUDA card, like ``run``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from port_bench import check_di, spec


def upper(ctx, r) -> dict:
    i, cfg, dev = r.inputs, ctx.cfg, ctx.device
    args = (cfg, i["dic"], i["patterns"])
    out = {"detail": check_di.numbers(*args, i["out"], dev, detail=True),
           "control": check_di.numbers(*args, check_di.control_outputs(*args, dev), dev, detail=True)}
    for fault in ("bf16_sums", "bf16_scores"):
        planted = check_di.planted_outputs(cfg, i["dic"], i["out"]["features"], dev, fault)
        out[fault] = check_di.numbers(*args, planted, dev, detail=True)
    f = torch.as_tensor(i["out"]["features"], device=dev)
    s = check_di.reference_scores(f, i["dic"])
    s[:, len(i["dic"]) // 2 :] = -torch.inf
    half = check_di.outputs(cfg, i["dic"], f, s)
    out["half_dictionary"] = check_di.numbers(*args, half, dev)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=4)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.readings_di needs a CUDA card", file=sys.stderr)
        return 3
    bench = spec.Benchmark(Path.cwd())
    cell = bench.workload(args.workload)
    traffic = bench.traffic(cell["traffic"])
    for n, seed in enumerate(args.seeds):
        ctx = spec.Context(bench=bench, cell=cell, cfg=bench.config(cell["config"]), traffic=traffic,
                           seed=seed, seconds=args.seconds, trace=False, device="cuda", t0=time.time())
        r = bench.runner(cell).run(ctx)
        line = {"workload": args.workload, "seed": seed, "program": r.checks, "failed": r.failed,
                "setup_s": r.setup_s, "work": r.work, "window_s": r.window_s,
                "memory_peak_bytes": r.memory_peak_bytes}
        if n < args.controls:
            line.update(upper(ctx, r))
        else:
            line["detail"] = check_di.numbers(ctx.cfg, r.inputs["dic"], r.inputs["patterns"],
                                              r.inputs["out"], ctx.device, detail=True)
        print(json.dumps(line), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
