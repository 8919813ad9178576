"""Run one cell of the benchmark and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name under ``port_bench/`` (`spec`); the traffic mix's
``kind`` names the runner (``port_bench/kinds/<kind>.py``) that builds
the program's objects, runs the measured window and makes the comparison
that decides ``correct``. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled part of the window.

Exits with a code other than 0, and prints no result, where there is no
CUDA card or fewer than the cell asks for, or where JAX or the JAX package
has been loaded by the end.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up starts here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from port_bench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "latice_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_cores(n: int = 4) -> None:
    """Keep this process, and the threads it starts later, on the first
    ``n`` of the cores it may use: its host path is paced by one thread,
    and unpinned its worker threads' spinning kept about five of eight
    cores busy (PERF.md)."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[:n])


def cache_dirs(root: Path) -> None:
    """Fixed build and kernel-cache directories inside the checkout, for
    whatever builds through torch's extension loader or Triton; the port's
    nvcc libraries are built into ``latice_tpu_torch/ops/_build``."""
    cache = root / "port_bench" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float | None = None, count: int = 1) -> dict:
    """The result of one run of cell ``name`` as a dict (the line's keys,
    with ``checks`` last); ``device="cpu"`` runs the same path on the CPU."""
    bench = spec.Benchmark(root)
    cell = bench.workload(name)
    r = bench.runner(cell).run(spec.Context(
        bench=bench, cell=cell, cfg=bench.config(cell["config"]), traffic=bench.traffic(cell["traffic"]),
        seed=seed, seconds=seconds, trace=trace, device=device, t0=T0 if t0 is None else t0,
    ))
    limits = bench.limits(name)
    checks = []
    for key, value in r.checks.items():
        if key not in limits:
            raise KeyError(f"no limit for {key!r} in port_bench/limits/{name}.json")
        checks.append((key, value, limits[key]))
    correct = r.failed == 0 and all(v <= lim for _, v, lim in checks)
    metrics = {}
    for m in bench.metrics(name, per_layer=trace):
        value = bench.reader(m["name"])(r)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']!r} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    import torch

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": count, "memory_peak_bytes": r.memory_peak_bytes}
    out = {"correct": correct, "attempted": r.attempted, "failed": r.failed, "metrics": metrics,
           "device": dev}
    if trace and r.trace is not None:
        dev["busy_s"] = r.trace.busy_s
        dev["window_s"] = r.trace.window_s
        out["breakdown"] = {"device_ops": r.trace.device_ops(), "idle_gaps": r.trace.idle_gaps}
    out["power_limit_w"] = r.power_limit_w
    out["host"] = r.host
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    pin_cores()
    try:
        cell = spec.Benchmark(root).workload(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: cell {args.workload!r} needs {cell['chips']} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    out = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                   count=cell["chips"])
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: forbidden modules were loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for key, c in out["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
