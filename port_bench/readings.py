"""The readings that the limits of ``port_bench/limits/`` are set from.

    python3 -m port_bench.readings --workload <name> --seeds 1 2 3 ... --seconds 3 [--controls 3]

For each seed, one run of the cell at its own size and load over a short
window, as ``run`` makes it, and the numbers its comparison reads (the
lower readings), with statistics that are not compared (``detail``:
quantiles, the end-to-end score gap), from which a compared number is
chosen. For the first ``--controls`` seeds also the same numbers for the
control (the reference in float8 in the program's place) and for faults
planted in what the program returned (the upper readings):

* ``half_left_out``: half of the answers replaced by other rows' (as when
  half of a batch is left out);
* ``answer_altered``: one score moved by 0.1 and one orientation turned by
  30 degrees;
* ``search_half_dictionary``: each row's candidates taken from the first
  half of the dictionary only (the exact top-k of the program's latents
  there), as a search that skips part of the dictionary returns them.

One JSON line per seed on standard output. Needs a CUDA card, like ``run``.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from port_bench import check, spec
from port_bench.reference import rotations as rot
from port_bench.reference.search import cosine_scores


def _turned(q: np.ndarray, degrees: float) -> np.ndarray:
    half = np.deg2rad(degrees) / 2
    return rot.mul(np.array([np.cos(half), 0.0, 0.0, np.sin(half)]), q)


def _half_left_out(n: int) -> np.ndarray:
    """Row ``i`` of the second half answered with row ``i - n//2``'s."""
    src = np.arange(n)
    src[n // 2 :] = src[: n - n // 2]
    return src


def _half_dictionary(out: dict, dic: check.Dictionary, k: int, device) -> dict:
    lat = torch.as_tensor(out["latents"], device=device)
    top = torch.topk(cosine_scores(lat, dic.vectors[: len(dic.vectors) // 2]), k, dim=1)
    return dict(out, scores=top.values.cpu().numpy(), indices=top.indices.cpu().numpy())


def upper(ctx, r) -> dict:
    i, cfg = r.inputs, ctx.cfg
    args = (cfg, i["params"], i["dic"], i["patterns"])
    out = {"detail": check.candidate_numbers(*args, i["out"], ctx.device, detail=True),
           "control": check.candidate_numbers(*args, check.control_outputs(*args, ctx.device),
                                              ctx.device, detail=True)}
    src = _half_left_out(len(i["patterns"]))
    half = {k: None if v is None else np.asarray(v)[src] for k, v in i["out"].items()}
    out["half_left_out"] = check.candidate_numbers(*args, half, ctx.device)
    altered = copy.deepcopy(i["out"])
    altered["scores"] = np.array(altered["scores"], copy=True)
    altered["scores"][0, 0] += 0.1
    altered["best_q"][0] = _turned(altered["best_q"][0], 30.0)
    out["answer_altered"] = check.candidate_numbers(*args, altered, ctx.device)
    skipped = _half_dictionary(i["out"], i["dic"], cfg["top_n"], ctx.device)
    out["search_half_dictionary"] = check.candidate_numbers(*args, skipped, ctx.device)
    return out


def detail(ctx, r) -> dict:
    i = r.inputs
    return check.candidate_numbers(ctx.cfg, i["params"], i["dic"], i["patterns"], i["out"],
                                   ctx.device, detail=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.readings needs a CUDA card", file=sys.stderr)
        return 3
    bench = spec.Benchmark(Path.cwd())
    cell = bench.workload(args.workload)
    traffic = bench.traffic(cell["traffic"])
    for n, seed in enumerate(args.seeds):
        ctx = spec.Context(bench=bench, cell=cell, cfg=bench.config(cell["config"]), traffic=traffic,
                           seed=seed, seconds=args.seconds, trace=False, device="cuda", t0=time.time())
        r = bench.runner(cell).run(ctx)
        line = {"workload": args.workload, "seed": seed, "program": r.checks, "failed": r.failed,
                "setup_s": r.setup_s, "work": r.work, "window_s": r.window_s}
        line.update(upper(ctx, r) if n < args.controls else {"detail": detail(ctx, r)})
        print(json.dumps(line), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
