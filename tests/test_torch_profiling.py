"""The port's device, timer and trace helpers (``utils.device``,
``utils.profiling``, ``utils.torch_trace``) and the last API gaps
(``index.consensus_from_euler``, ``data.create_default_transform``), on
the CPU, against the JAX package where it has the same function.

Tolerances: trace sums exact to float rounding (1e-9 ms); the consensus
mean within 1e-4 degrees (the repo's orientation parity), its masks equal;
the transform bitwise.
"""

from __future__ import annotations

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.data import create_default_transform as jax_create_default_transform
from latice_tpu.index import consensus_from_euler as jax_consensus_from_euler
from latice_tpu.utils import PhaseTimer as JaxPhaseTimer
from latice_tpu_torch.data import create_default_transform
from latice_tpu_torch.index import consensus_from_euler
from latice_tpu_torch.utils import (
    PhaseTimer,
    device_sync,
    format_summary,
    get_device,
    get_platform,
    summarize_trace,
    trace,
)
from latice_tpu_torch.utils import torch_trace


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def test_device_helpers_never_pick_the_cpu_alone():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device("gpu")
    assert get_device("cpu") == torch.device("cpu")
    assert get_platform() == "cpu"
    device_sync()  # no CUDA: nothing to wait for


def test_phase_timer_report_has_jax_keys():
    timers = {"port": PhaseTimer(sync=True), "jax": JaxPhaseTimer(sync=False)}
    for timer in timers.values():
        for name in ("encode", "search", "encode"):
            with timer.phase(name):
                pass
    port, want = timers["port"].report(), timers["jax"].report()
    assert list(port) == list(want)
    assert port["encode/count"] == 2.0 and port["search/count"] == 1.0
    assert port["encode/mean_s"] == pytest.approx(port["encode/total_s"] / 2)
    assert repr(timers["port"]).startswith("PhaseTimer(encode=")
    timers["port"].reset()
    assert timers["port"].report() == {}


def _event(name, cat, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur}


@pytest.fixture(scope="module")
def hand_trace(tmp_path_factory):
    """A Chrome trace with known sums: two iterations of three kernels, a
    copy, host ops and events that must be ignored (instants, metadata)."""
    events = []
    for it in range(2):
        t = 1000.0 * it
        events += [
            _event("gemm_kernel", "kernel", t, 300.0),
            _event("gemm_kernel", "kernel", t + 300, 100.0),
            _event("instance_norm_lrelu_fwd", "kernel", t + 400, 250.0),
            _event("topk_partial", "kernel", t + 650, 50.0),
            _event("Memcpy HtoD", "gpu_memcpy", t + 700, 40.0),
            _event("aten::mm", "cpu_op", t, 500.0),
            _event("marker", "kernel", t, 999.0, ph="i"),
        ]
    events.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "x"}})
    root = tmp_path_factory.mktemp("trace")
    (root / "older.json").write_text(json.dumps({"traceEvents": []}))
    path = root / "sub" / "newest.json.gz"
    path.parent.mkdir()
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return root, path


def test_summarize_hand_trace(hand_trace):
    root, path = hand_trace
    s = summarize_trace(str(root), iterations=2)  # the newest file under the directory
    assert s.trace_file == str(path) and s.iterations == 2
    got = {op.name: (op.total_ms, op.count) for op in s.ops}
    assert got == {"gemm_kernel": (0.4, 2), "instance_norm_lrelu_fwd": (0.25, 1),
                   "topk_partial": (0.05, 1)}
    assert [op.name for op in s.ops] == ["gemm_kernel", "instance_norm_lrelu_fwd", "topk_partial"]
    assert s.total_ms == pytest.approx(0.7, abs=1e-9)
    both = summarize_trace(str(path), iterations=2, category=("kernel", "gpu_memcpy"))
    assert both.total_ms == pytest.approx(0.74, abs=1e-9)
    host = summarize_trace(str(path), category="cpu_op")
    assert [(op.name, op.count) for op in host.ops] == [("aten::mm", 2)]
    text = format_summary(s, top=2)
    assert "0.700 ms/iteration" in text and "gemm_kernel" in text and "1 more ops" in text
    with pytest.raises(FileNotFoundError, match="no \\*.json"):
        summarize_trace(str(root / "sub" / "none"))


def test_trace_writes_a_readable_cpu_capture(tmp_path, capsys):
    """`trace` around CPU work writes a Chrome trace that the reader sums
    with ``category="cpu_op"``; the CLI prints the same table."""
    a = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))
    with trace(tmp_path, "mm"):
        for _ in range(3):
            a = a @ a.T / 64.0
    files = list(tmp_path.glob("mm-*.json"))
    assert len(files) == 1
    s = summarize_trace(str(tmp_path), iterations=3, category="cpu_op")
    mm = [op for op in s.ops if op.name == "aten::mm"]
    assert mm and mm[0].count == 1 and mm[0].total_ms > 0
    assert s.total_ms == pytest.approx(sum(op.total_ms for op in s.ops))
    torch_trace.main([str(tmp_path), "--iterations", "3", "--category", "cpu_op", "--top", "5"])
    assert "aten::mm" in capsys.readouterr().out


def test_consensus_from_euler_matches_jax():
    """(B, K, 3) zxz degrees of noisy clusters around random orientations:
    the same successes and masks, the mean within 1e-4 degrees."""
    rng = np.random.default_rng(5)
    b, k = 24, 20
    centre = rng.uniform([0, 10, 0], [360, 170, 360], size=(b, 1, 3))
    spread = np.where(np.arange(b) % 3 == 0, 6.0, 0.3)[:, None, None]
    cand = (centre + spread * rng.normal(size=(b, k, 3))).astype(np.float32)
    got = consensus_from_euler(torch.from_numpy(cand), 1.0, min_required_matches=12)
    want = jax_consensus_from_euler(jnp.asarray(cand), 1.0, min_required_matches=12)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.similar_mask.numpy(), np.asarray(want.similar_mask))
    ok = got.success.numpy()
    assert 0 < ok.sum() < b
    from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle

    mis = misorientation_angle(
        from_euler_zxz_deg(got.mean_euler.double()[ok]),
        from_euler_zxz_deg(torch.from_numpy(np.asarray(want.mean_euler, np.float64)[ok])),
    )
    assert np.rad2deg(mis.numpy()).max() <= 1e-4


def test_create_default_transform_matches_jax():
    rng = np.random.default_rng(6)
    for patterns, size in ((rng.integers(0, 256, (3, 131, 140), dtype=np.uint8), (128, 128)),
                           (rng.uniform(size=(2, 60, 60, 3)).astype(np.float32), (32, 40))):
        got = create_default_transform(size)(patterns)
        want = jax_create_default_transform(size)(patterns)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
