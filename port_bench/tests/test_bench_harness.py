"""The harness on the CPU: a new cell from added files alone, the faults
that must make ``correct`` false, and the check that nothing loads JAX.

These runs skip the look for a card (`run.run_cell` with ``device="cpu"``)
and drive the rest of a run at a tiny size, in float32, against the real
cells' limit files.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import run

REPO = Path(__file__).resolve().parents[2]
TINY = dict(inplanes=4, latent_dim=8, n_stages=3, bottleneck_hw=4, image_size=32, precision="32",
            rows_per_phase=500)
SMALL = dict(image_size=32, batch=32, render_chunk=64, trace_start_s=0.2, trace_s=0.5)


def _add(root: Path, name: str, like: str, traffic: dict, cfg: dict = TINY) -> None:
    """Add cell ``name`` to the copy at ``root``, cut from cell ``like``: a
    config, a traffic mix, a limits file and a ``BENCHMARK.json`` entry,
    each a new file or entry."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    like_cell = next(w for w in bench["workloads"] if w["name"] == like)
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == like_cell["config"])
    base = json.loads((root / cfg_file).read_text())
    (root / "port_bench" / "configs" / f"{name}.json").write_text(json.dumps({**base, **cfg}))
    mix = json.loads((root / "port_bench" / "traffic" / f"{like_cell['traffic']}.json").read_text())
    (root / "port_bench" / "traffic" / f"{name}.json").write_text(json.dumps({**mix, **traffic}))
    shutil.copy(root / "port_bench" / "limits" / f"{like}.json", root / "port_bench" / "limits" / f"{name}.json")
    bench["configs"].append({"name": name, "source": "test", "file": f"port_bench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": name, "traffic": name, "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def root(tmp_path):
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    torch.set_num_threads(2)
    return tmp_path


SCAN = dict(SMALL, scan_rows=8, scan_cols=16, grains=4, slab=64, keep_per_slab=64, sample=10**6)


def test_a_new_cell_and_metric_from_added_files_alone(root):
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*") if p.is_file()}
    _add(root, "tiny-scan", "ref-scan-index", SCAN)
    (root / "port_bench" / "metrics" / "tiny_batches_per_s.py").write_text(
        "def read(r):\n    return r.work['batches'] / r.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "tiny_batches_per_s", "unit": "batches/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["tiny-scan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell(root, "tiny-scan", 2**31 + 7, 1.0, False, device="cpu")
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"index_patterns_per_s", "setup_s", "tiny_batches_per_s"}
    assert out["metrics"]["tiny_batches_per_s"]["value"] * 32 == pytest.approx(
        out["metrics"]["index_patterns_per_s"]["value"])
    assert list(out)[-1] == "checks"
    assert all(p.read_bytes() == b for p, b in before.items())


def _turn_first_row(res):
    res.best_orientation[0, 0] = (res.best_orientation[0, 0] + 30.0) % 360.0
    res.mean_orientation[0, 0] = (res.mean_orientation[0, 0] + 30.0) % 360.0
    return res


def _half_left_out(encode):
    def broken(self, patterns):
        mu = encode(self, patterns)
        h = len(mu) // 2
        return torch.cat([mu[:h], mu[: len(mu) - h]])

    return broken


def _half_dictionary(search):
    def broken(queries, dictionary, k, n_valid=None):
        return search(queries, dictionary[: len(dictionary) // 2], k)

    return broken


def _kth_swapped(search):
    """The k-th candidate replaced by the (k+1)-th."""
    def broken(queries, dictionary, k, n_valid=None):
        scores, idx = search(queries, dictionary, k + 1)
        keep = [*range(k - 1), k]
        return scores[:, keep], idx[:, keep]

    return broken


@pytest.mark.parametrize("fault", [None, "answer_altered", "half_left_out", "search_half_dictionary",
                                   "search_kth_swapped"])
def test_index_faults_are_not_correct(root, monkeypatch, fault):
    from latice_tpu_torch.index import pipeline as pipeline_mod

    _add(root, "tiny-scan", "ref-scan-index", SCAN)
    if fault == "answer_altered":
        collect = pipeline_mod.collect_results
        monkeypatch.setattr(pipeline_mod, "collect_results", lambda *a: _turn_first_row(collect(*a)))
    if fault == "half_left_out":
        monkeypatch.setattr(pipeline_mod.IndexPipeline, "_encode",
                            _half_left_out(pipeline_mod.IndexPipeline._encode))
    if fault == "search_half_dictionary":
        monkeypatch.setattr(pipeline_mod, "cosine_topk_fused", _half_dictionary(pipeline_mod.cosine_topk_fused))
    if fault == "search_kth_swapped":
        monkeypatch.setattr(pipeline_mod, "cosine_topk_fused", _kth_swapped(pipeline_mod.cosine_topk_fused))
    out = run.run_cell(root, "tiny-scan", 11, 1.0, False, device="cpu")
    assert out["correct"] is (fault is None), out["checks"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "latice_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "latice_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax", "latice_tpu"]


def test_nothing_the_benchmark_runs_loads_jax():
    code = ("import port_bench.run, port_bench.readings, port_bench.kinds.scan_index, "
            "latice_tpu_torch.index.pipeline, latice_tpu_torch.data\n"
            "from port_bench.run import forbidden_modules\nprint(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pin_cores_keeps_the_first_allowed_cores():
    code = ("import os\nfrom port_bench.run import pin_cores\nfirst = sorted(os.sched_getaffinity(0))\n"
            "pin_cores(2)\nprint(sorted(os.sched_getaffinity(0)) == first[:2])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_no_result_without_a_card(tmp_path):
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "ref-scan-index",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
