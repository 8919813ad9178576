"""The frozen arithmetic: FLOPs from shapes, kernel bounds, trace reading."""

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench import trace, yardstick

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_encoder_flops_from_shapes():
    ref, scaled = yardstick.encoder_flops(cfg("vae_ref")), yardstick.encoder_flops(cfg("vae_scaled"))
    assert ref == pytest.approx(1.406e9, rel=1e-3)
    assert scaled / ref == pytest.approx(4.0, rel=0.02)


def test_train_flops_are_three_forwards():
    c = cfg("vae_ref")
    assert yardstick.decoder_flops(c) == pytest.approx(1.406e9, rel=1e-3)
    assert yardstick.train_flops(c) == pytest.approx(8.44e9, rel=1e-3)


@pytest.mark.parametrize("train, launches", [(False, 10), (True, 19)])
def test_norm_launches_per_batch(train, launches):
    assert len(yardstick.norm_shapes(cfg("vae_ref"), train)) == launches


def test_kernel_bounds_match_chip_smoke():
    # K1 at B=256 over 100k x 16, k=20: bounded by its operations, 0.0126 ms.
    assert yardstick.k1_bound_s(256, 100_000, 16, 20) * 1e3 == pytest.approx(0.0126, rel=0.01)
    # K2f bf16 on one plane of 256 x 32 x 128 x 128: bounded by its bytes.
    n = 256 * 32 * 128 * 128
    assert yardstick.bound_s(4.0 * n + 8.0 * 256 * 32, 7.0 * n) == pytest.approx(
        (4.0 * n + 8.0 * 256 * 32) / yardstick.PEAK_BYTES)
    assert yardstick.norm_bound_s(cfg("vae_ref"), 64, True, True) > yardstick.norm_bound_s(
        cfg("vae_ref"), 64, True, False)


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::instance_norm_lrelu_fwd<__nv_bfloat16>(...)", "k2f"),
    ("void (anonymous namespace)::instance_norm_lrelu_bwd<__nv_bfloat16>(...)", "k2b"),
    ("void (anonymous namespace)::topk_partial<64, 1, 4>(...)", "k1"),
    ("Memcpy HtoD (Pinned -> Device)", "h2d"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convolution"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "convolution"),
    ("void at::native::elementwise_kernel<128, 4>", "other"),
])
def test_kernel_groups(name, group):
    assert trace.group_of(name) == group


def test_busy_is_the_union_of_intervals():
    iv = np.array([[0, 10], [5, 15], [20, 30], [21, 22]], np.float64)
    assert trace._union(iv).tolist() == [[0, 15], [20, 30]]


class _Event:
    def __init__(self, name, start, dur, cuda=True):
        import torch

        self._n, self._s, self._d = name, start, dur
        self._t = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda s: events})()})()


def test_idle_share_and_gap_labels():
    events = [_Event("instance_norm_lrelu_fwd", 100, 200), _Event("Memcpy HtoD (Pinned -> Device)", 250, 100),
              _Event("topk_partial", 600, 100)]
    spans = trace.Spans()
    spans.open = True
    spans.record("bench:consensus", 350, 600)
    spans.record("bench:pipeline", 0, 1000)
    t = trace.read(_Prof(events), spans, 0, 1000)
    assert t.busy_s == pytest.approx(350e-9)  # [100, 350] and [600, 700]
    assert t.window_s == pytest.approx(1000e-9)
    assert t.by_group == pytest.approx({"k2f": 200e-9, "h2d": 100e-9, "k1": 100e-9})
    labels = dict(t.idle_gaps)
    assert labels["bench:consensus"] == pytest.approx(250e-9)
    assert labels["bench:pipeline"] == pytest.approx(400e-9)
