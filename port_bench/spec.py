"""Finding a cell's parts by name, so that a new cell, configuration, traffic
mix or metric is a new file and never an edit.

* ``BENCHMARK.json`` at the root: the cells, the configurations' files and
  the metrics.
* ``port_bench/traffic/<traffic>.json``: a traffic mix's parameters; its
  ``kind`` names the runner ``port_bench/kinds/<kind>.py``, whose
  ``run(ctx) -> Readings`` builds and drives the program.
* ``port_bench/limits/<workload>.json``: the limit of each number that the
  cell's comparison reads.
* ``port_bench/metrics/<metric>.py``: the metric's ``read(readings)``,
  which returns a number or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

__all__ = ["Benchmark", "Context", "Readings"]

PACKAGE = "port_bench"


class Benchmark:
    """The benchmark as checked out at ``root``."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.folder = self.root / PACKAGE

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.folder / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.folder / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload: str, per_layer: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: the end-to-end ones, or
        with ``per_layer`` the per-layer ones, that list it or list no cells."""
        group = self.data["per_layer" if per_layer else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[["Readings"], float | None]:
        path = self.folder / "metrics" / f"{metric}.py"
        mod_name = f"{PACKAGE}_metric_" + "".join(ch if ch.isalnum() else "_" for ch in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(f"no reader {path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def runner(self, cell: dict):
        kind = self.traffic(cell["traffic"])["kind"]
        return importlib.import_module(f"{PACKAGE}.kinds.{kind}")


@dataclass
class Context:
    """What a runner is handed."""

    bench: Benchmark
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float


@dataclass
class Readings:
    """What a runner measured, for the metric readers and the comparison.

    ``work`` counts the window's completed work (``patterns``,
    ``batches``) and ``traced`` the same inside the profiled part; ``host``
    the process's CPU time and the like over the window
    (`program.host_counters`).
    """

    cfg: dict
    traffic: dict
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict[str, float]
    work: dict[str, float] = field(default_factory=dict)
    traced: dict[str, float] = field(default_factory=dict)
    trace: Any = None  # trace.Trace of the profiled part, with --trace 1
    host: dict = field(default_factory=dict)
    power_limit_w: float | None = None
    # What the comparison was made from, for `readings` (the control and
    # the planted faults are compared the same way); not printed.
    inputs: dict = field(default_factory=dict, repr=False)
