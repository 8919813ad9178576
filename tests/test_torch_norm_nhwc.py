"""The encoder in channels_last on the card, and K2f's NHWC kernel.

On the card under bfloat16 autocast with autograd off the encoder runs in
``torch.channels_last`` (`models.vae`), so cuDNN's NHWC convolutions need no
layout transforms, and K2f normalizes NHWC tensors with a kernel of its
own (`ops.fused_norm`, planned by `_nhwc_plan`). On the CPU: the plain
twin in channels_last, the plan, the module keeping its layout, today's
NCHW bits on every path outside the gate, the gated control flow with the
gate opened on the CPU, and the benchmark's reader of the counter. On the
card: the kernel against the twin and against the NCHW kernel, and the
channels_last encoder against the NCHW one.

The card tests run where JAX is absent:
``python -m pytest tests/test_torch_norm_nhwc.py -m card --noconftest``.
"""

from __future__ import annotations

import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from latice_tpu_torch.models import VariationalAutoEncoderRawData, vae
from latice_tpu_torch.models.vae import ConvBlock, InstanceNormLeakyReLU
from latice_tpu_torch.ops import fused_norm
from latice_tpu_torch.ops.fused_norm import (
    _nhwc_plan,
    instance_norm_leaky_relu,
    instance_norm_leaky_relu_plain,
)
from latice_tpu_torch.utils import profiling
from latice_tpu_torch.utils.profiling import Record, recorded, trace
from port_bench import spec

ROOT = Path(__file__).resolve().parents[1]
COUNTER = "encoder.nhwc_norms"
METRIC = "encoder.nhwc_norms_per_batch.index"
CL = torch.channels_last

# (C, H, W) of the encoder's norms at 128x128 input, each run twice: vae_ref
# (inplanes 32, 5 stages) and vae_scaled (inplanes 64, 6 stages).
ENCODER_SHAPES = {
    "ref": [(32, 128, 128), (64, 64, 64), (128, 32, 32), (128, 16, 16), (128, 8, 8)],
    "scaled": [(64, 128, 128), (128, 64, 64), (256, 32, 32), (256, 16, 16), (256, 8, 8),
               (256, 4, 4)],
}
# Besides them: an odd channel count whose 16-byte chunks are not a power of
# two (24, 40) over pixels that split unevenly across the cluster, channel
# counts that take one element a chunk (12, 6), and float32.
OTHER_SHAPES = [(24, 127, 127, torch.bfloat16), (40, 37, 53, torch.bfloat16),
                (12, 33, 33, torch.bfloat16), (6, 128, 128, torch.bfloat16),
                (32, 64, 64, torch.float32)]
CARD_SHAPES = [(c, h, w, torch.bfloat16) for shapes in ENCODER_SHAPES.values()
               for c, h, w in shapes] + OTHER_SHAPES
H100_SMS_SMEM = 228 * 1024  # shared memory of one SM, 1 KB of it reserved per CTA
NHWC_STATIC_SMEM = 10 * 1024  # the kernel's own sums (part + sums in csrc/fused_norm.cu)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _x(shape, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * 3 + 1).to(device=device, dtype=dtype)


# --- on the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("source", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 5), (3, 24, 7, 9)])
def test_plain_twin_takes_channels_last(shape, dtype, source):
    """The twin on a channels_last tensor, or asked for a channels_last y
    from an NCHW one, gives the NCHW result, bit for bit, with y in
    channels_last."""
    x = _x(shape, dtype)
    want = instance_norm_leaky_relu_plain(x)
    if source == "nchw":
        got = instance_norm_leaky_relu_plain(x, memory_format=CL)
    else:
        got = instance_norm_leaky_relu_plain(x.contiguous(memory_format=CL))
    assert got[0].is_contiguous(memory_format=CL) and not got[0].is_contiguous()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[0].is_contiguous()


@pytest.mark.parametrize("nchw_in", [False, True], ids=["nhwc_in", "nchw_in"])
@pytest.mark.parametrize("c, h, w, dtype", [(c, h, w, torch.bfloat16) for c, h, w in
                                            {s for v in ENCODER_SHAPES.values() for s in v}]
                         + OTHER_SHAPES, ids=str)
def test_nhwc_plan_covers_every_pixel_once(c, h, w, dtype, nchw_in):
    size = torch.tensor([], dtype=dtype).element_size()
    vec = c % (16 // size) == 0 and (h * w % (16 // size) == 0 or not nchw_in)
    per_chunk = 16 // size if vec else 1
    p = _nhwc_plan(c, h * w, size, vec, nchw_in)
    if nchw_in:  # an NCHW input is cached in whole 16-byte chunks of pixels
        assert p.rows % per_chunk == 0
    assert c % p.group == 0 and p.group % per_chunk == 0
    assert p.group * size <= max(16, fused_norm._NHWC_GROUP_BYTES)  # and so at most 256 channels
    chunks = p.group // per_chunk
    assert p.threads % chunks == 0 and chunks <= p.threads <= fused_norm._NHWC_THREADS
    # Pixels: ranks 0..cluster-1 take [rank * rows, rank * rows + rows), each
    # at least one, together every pixel once.
    assert 1 <= p.cluster <= fused_norm._NHWC_MAX_CLUSTER
    assert (p.cluster - 1) * p.rows < h * w <= p.cluster * p.rows
    assert p.cached
    if (c, h, w) in {s for v in ENCODER_SHAPES.values() for s in v}:
        # Slices of at most 64 KB, three CTAs to an SM, and a pixel's share
        # of a channel group at least one 32-byte sector.
        slice_bytes = p.rows * p.group * size
        assert slice_bytes <= fused_norm._NHWC_MAX_SLICE_BYTES
        assert 3 * (slice_bytes + NHWC_STATIC_SMEM + 1024) <= H100_SMS_SMEM
        assert p.group * size >= 32 and p.vec


def test_nhwc_plan_sizes_clusters_by_the_shape():
    """Stage 0 spreads an image's 32 channels over sixteen CTAs (scaled's 64
    halved to 32); 32x32 images take four; the 16x16 to 4x4 images a
    cluster of one; groups of at most 64 bf16 channels."""
    assert _nhwc_plan(32, 128 * 128, 2, True)[:3] == (32, 16, 1024)
    assert _nhwc_plan(64, 128 * 128, 2, True)[:3] == (32, 16, 1024)
    assert _nhwc_plan(256, 1024, 2, True)[:3] == (64, 4, 256)
    assert _nhwc_plan(128, 256, 2, True)[:2] == (64, 1)
    assert _nhwc_plan(256, 16, 2, True)[:2] == (64, 1)


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "transposed", "nchw_to_cl"])
def test_norm_module_keeps_its_layout(layout):
    """The module hands the op NCHW or channels_last as given, and other
    strides as NCHW, its output in the input's layout unless asked for
    channels_last; y equals the twin's on the NCHW copy, bit for bit."""
    x = _x((2, 8, 6, 6))
    given = {"nchw": x, "channels_last": x.contiguous(memory_format=CL), "nchw_to_cl": x,
             "transposed": x.transpose(2, 3).contiguous().transpose(2, 3)}[layout]
    y = InstanceNormLeakyReLU()(given, CL if layout == "nchw_to_cl" else None)
    assert torch.equal(y, instance_norm_leaky_relu_plain(x)[0])
    if layout in ("channels_last", "nchw_to_cl"):
        assert y.is_contiguous(memory_format=CL) and not y.is_contiguous()
    else:
        assert y.is_contiguous()


def _model(inplanes=4, latent=8, n_stages=3, hw=4, device="cpu"):
    gen = torch.Generator().manual_seed(5)
    model = VariationalAutoEncoderRawData(inplanes, latent, n_stages, hw).init_weights(gen)
    return model.to(device).eval()


def _nchw_encoder(encoder, x):
    """The encoder written out in NCHW functionals: every convolution with
    its bias, the twin's norm, the pool."""
    for layer in encoder:
        if isinstance(layer, ConvBlock):
            x = instance_norm_leaky_relu_plain(F.conv2d(x, layer[0].weight, layer[0].bias,
                                                        padding=1))[0]
        else:
            x = F.max_pool2d(x, 2)
    return x


@pytest.mark.parametrize("precision", ["32", "16-mixed"])
@pytest.mark.parametrize("grad", [False, True], ids=["inference", "grad"])
def test_the_cpu_keeps_nchw_bit_for_bit(tmp_path, precision, grad):
    """Outside the gate (here: the CPU) the encoder, its blocks and norms
    stay NCHW with the bits of the NCHW functionals, and no NHWC norm is
    counted."""
    model = _model().set_precision(precision)
    x = _x((2, 1, 32, 32)).sigmoid()
    with trace(tmp_path), torch.set_grad_enabled(grad), model._autocast(x):
        got = model.encoder(x)
        want = _nchw_encoder(model.encoder, x)
        block = model.encoder[1](model.encoder[0](x))
    assert COUNTER not in recorded().counters
    assert got.is_contiguous() and block.is_contiguous()
    assert torch.equal(got, want)
    assert all(not hasattr(b, "_nhwc_weight") for b in model.encoder if isinstance(b, ConvBlock))
    if grad:
        got.float().square().sum().backward()
        assert all(b[0].weight.grad is not None for b in model.encoder if isinstance(b, ConvBlock))


def test_the_gate_runs_the_encoder_in_channels_last(monkeypatch):
    """The gated control flow, opened on the CPU under bfloat16 autocast:
    the first block's convolution on the one-channel patterns with the
    parameter, every later block's weight copied once to channels_last bf16
    and kept until the parameter changes, every block's and pool's output
    in channels_last, ``mu`` within bf16 noise of the NCHW path with every
    bias, the parameters and the state dict untouched."""
    model = _model().set_precision("16-mixed")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = _x((3, 1, 32, 32)).sigmoid()
    blocks = [b for b in model.encoder if isinstance(b, ConvBlock)]
    with torch.inference_mode():
        want = model.encode(x)[0]  # the gate shut: NCHW, every bias added
    monkeypatch.setattr(vae, "_bias_cancels", lambda t: not torch.is_grad_enabled()
                        and torch.is_autocast_enabled(t.device.type))
    with torch.inference_mode():
        with model._autocast(x):
            h = x
            for layer in model.encoder:
                h = layer(h)
                assert h.is_contiguous(memory_format=CL) and not h.is_contiguous()
        assert not hasattr(blocks[0], "_nhwc_weight")
        kept = [b._nhwc_weight[1] for b in blocks[1:]]
        assert all(w.dtype == torch.bfloat16 and w.is_contiguous(memory_format=CL) for w in kept)
        mu = model.encode(x)[0]
        assert all(b._nhwc_weight[1] is w for b, w in zip(blocks[1:], kept))  # kept, not re-made
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]) and value.is_contiguous()
    # A changed parameter (load_state_dict copies in place) is copied anew.
    with torch.no_grad():
        blocks[1][0].weight.mul_(2.0)
    with torch.inference_mode(), model._autocast(x):
        model.encoder(x)
    assert torch.equal(blocks[1]._nhwc_weight[1], (2.0 * before["encoder.1.0.weight"]).to(
        torch.bfloat16, memory_format=CL))
    assert (mu - want).abs().max() <= 0.05 * want.abs().max()


def test_the_reader_reads_the_nhwc_counter(monkeypatch):
    read = spec.Benchmark(ROOT).reader(METRIC)
    traced = types.SimpleNamespace(trace=object())
    assert read(types.SimpleNamespace(trace=None)) is None  # no window
    rec = Record()
    rec.count("index.batches", 4)
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert read(traced) is None  # no counter: a program without the NHWC norm
    rec.count(COUNTER, 48)
    assert read(traced) == 12.0
    monkeypatch.setattr(profiling, "recorded", lambda: None)
    assert read(traced) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without a recorder
    assert read(traced) is None
    listed = {m["name"]: m for m in spec.Benchmark(ROOT).data["per_layer"]}[METRIC]
    assert listed["workloads"] == ["ref-scan-index", "scaled-scan-index"]
    assert listed["moves"] == "index_patterns_per_s" and listed["source"] == "program_counter"
    assert listed["layer"] == "encoder and decoder"


# --- on the card -----------------------------------------------------------------

K2_ATOL = 1e-4  # chip_smoke.py's: statistics, and f32 outputs
K2_BF16_ATOL, K2_BF16_RTOL = 1e-2, 2.0**-7  # chip_smoke.py's: bf16 outputs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _close(got, want, dtype):
    atol, rtol = (K2_BF16_ATOL, K2_BF16_RTOL) if dtype == torch.bfloat16 else (K2_ATOL, 0.0)
    err = (got.float() - want.float()).abs() - rtol * want.float().abs()
    return err.max().item() <= atol, err.max().item()


@pytest.mark.card
@pytest.mark.parametrize("source", ["channels_last", "nchw"])
@pytest.mark.parametrize("c, h, w, dtype", CARD_SHAPES, ids=str)
def test_card_nhwc_kernel_matches_twin_and_nchw_kernel(card, tmp_path, c, h, w, dtype, source):
    """The NHWC kernel from a channels_last x, or from an NCHW one, against
    the twin and the NCHW kernel, after one synchronize."""
    x = _x((16, c, h, w), dtype, card, seed=c + h)
    before = instance_norm_leaky_relu.launches
    with trace(tmp_path):
        if source == "nchw":
            got = instance_norm_leaky_relu(x, memory_format=CL)
        else:
            got = instance_norm_leaky_relu(x.contiguous(memory_format=CL))
        nchw = instance_norm_leaky_relu(x)
    twin = instance_norm_leaky_relu_plain(x)
    torch.cuda.synchronize()
    assert instance_norm_leaky_relu.launches == before + 2
    assert recorded().counters[COUNTER] == 1
    assert got[0].is_contiguous(memory_format=CL) and not got[0].is_contiguous()
    for want in (twin, nchw):
        ok, err = _close(got[0], want[0], dtype)
        assert ok, err
        for g, s in zip(got[1:], want[1:]):
            assert (g - s).abs().max().item() <= K2_ATOL


CARD_WIDTHS = {"ref": (32, 16, 5, 4, 10), "scaled": (64, 64, 6, 2, 12)}


def _unit(mu):
    return mu / mu.norm(dim=1, keepdim=True)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_WIDTHS))
def test_card_channels_last_encoder(card, tmp_path, name):
    """``mu`` of the channels_last encoder against the same blocks in NCHW
    with the parameters' own layout (the path before it): no farther from
    the f32 model than twice their distance; the trace has no cuDNN layout
    transform and no generic elementwise kernel (a weight or activation
    re-layout) in the encoder; every norm NHWC."""
    inplanes, latent, n_stages, hw, convs = CARD_WIDTHS[name]
    model = _model(inplanes, latent, n_stages, hw, device=card).set_precision("16-mixed")
    x = _x((32, 1, 128, 128), device=card, seed=3).sigmoid()
    with torch.inference_mode():
        model.encode(x)  # builds the kernels, keeps the weights
        with trace(tmp_path / "encode"):
            mu = model.encode(x)[0]
        assert recorded().counters[COUNTER] == convs
        with model._autocast(x):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                model.encoder(x)
                torch.cuda.synchronize()
            h = x
            for layer in model.encoder:
                if isinstance(layer, ConvBlock):
                    h = layer[1](layer[0]._conv_forward(h, layer[0].weight, None))
                else:
                    h = layer(h)
            assert h.is_contiguous()
            nchw = model.mu(h.flatten(1)).float()
        mu32 = model.set_precision("32").encode(x)[0]
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n], names
    assert not [n for n in names if "::elementwise_kernel<" in n], names
    gap = (_unit(mu) - _unit(mu32)).norm(dim=1)
    gap_nchw = (_unit(nchw) - _unit(mu32)).norm(dim=1)
    assert gap.max() <= 2 * gap_nchw.max() + 1e-4, (gap.max(), gap_nchw.max())
