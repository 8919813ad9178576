"""The encoder's convolutions without their bias (`models.vae.ConvBlock`).

A norm without affine follows each encoder convolution and cancels its
per-channel bias, so on the card, in bfloat16 and with autograd off, a
block leaves the bias out. On the CPU: the identity block by block, in
float32 and under bfloat16 autocast, with every bias drawn in ±0.5; the
gate, which keeps the add bit for bit on the CPU, in float32 and under
autograd; the parameters; the benchmark's reader of the counter. On the
card: the encoder against its with-bias forward, the counter, and no
broadcast add left after the convolutions.

The card tests run where JAX is absent:
``python -m pytest tests/test_torch_conv_bias.py -m card --noconftest``.
"""

from __future__ import annotations

import types
from pathlib import Path

import pytest
import torch
from torch import nn

from latice_tpu_torch.models import VariationalAutoEncoderRawData
from latice_tpu_torch.models.vae import ConvBlock
from latice_tpu_torch.utils import profiling
from latice_tpu_torch.utils.profiling import Record, recorded, trace
from port_bench import spec

ROOT = Path(__file__).resolve().parents[1]
COUNTER = "encoder.bias_free_convs"


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it: building a module
    draws from it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _blocks(model) -> list[ConvBlock]:
    return [m for m in model.encoder if isinstance(m, ConvBlock)]


def _model(inplanes=4, latent=8, n_stages=3, hw=4, device="cpu"):
    """A seeded VAE whose encoder biases are drawn in ±0.5, far above their
    default bounds, so that a bias the norm failed to cancel would show."""
    gen = torch.Generator().manual_seed(7)
    model = VariationalAutoEncoderRawData(inplanes, latent, n_stages, hw).init_weights(gen)
    with torch.no_grad():
        for block in _blocks(model):
            bias = block[0].bias
            bias.copy_(torch.rand(bias.shape, generator=gen) - 0.5)
    return model.to(device).eval()


def _patterns(n, side, device="cpu"):
    return torch.rand(n, 1, side, side, generator=torch.Generator().manual_seed(3)).to(device)


def _with_bias(encoder, x):
    """The encoder with every block's convolution adding its bias, as the
    blocks ran before they could leave it out."""
    for layer in encoder:
        x = nn.Sequential.forward(layer, x) if isinstance(layer, ConvBlock) else layer(x)
    return x


def _bias_free(encoder, x):
    for layer in encoder:
        x = layer.bias_free(x) if isinstance(layer, ConvBlock) else layer(x)
    return x


def _bf16_step(rows: torch.Tensor) -> torch.Tensor:
    """One bfloat16 step of each row's scale: bfloat16's epsilon times the
    row's largest magnitude, shaped to broadcast over the row."""
    scale = rows.flatten(1).abs().amax(1).float()
    return (torch.finfo(torch.bfloat16).eps * scale).view(-1, *[1] * (rows.dim() - 1))


@pytest.mark.parametrize("precision", ["32", "16-mixed"])
def test_the_bias_free_block_is_the_block(precision):
    """Block by block on the same input, against the with-bias block in
    float32. In bfloat16 the with-bias block rounds the convolution plus its
    bias once more, an error the norm scales by up to the bias over the
    plane's spread, so the two bfloat16 blocks differ by up to two steps:
    the bias-free one is held within one step of the float32 block, and no
    farther from it than the with-bias one."""
    model = _model().set_precision(precision)
    x = _patterns(4, 32)
    with torch.no_grad():
        h = x
        for layer in model.encoder:
            if isinstance(layer, ConvBlock):
                exact = layer(h.float())  # the CPU keeps the bias
                with model._autocast(x):
                    want, got = layer(h), layer.bias_free(h)
                assert got.dtype == want.dtype == model.compute_dtype
                err = (got.float() - exact).abs()
                if precision == "32":
                    assert err.max() <= 1e-5
                else:
                    assert (err <= _bf16_step(exact)).all(), (err / _bf16_step(exact)).max()
                    assert err.max() <= (want.float() - exact).abs().max()
                h = want
            else:
                h = layer(h)
        if precision == "32":  # and through the whole encoder
            assert (_bias_free(model.encoder, x) - _with_bias(model.encoder, x)).abs().max() <= 1e-5


@pytest.mark.parametrize("precision", ["32", "16-mixed"])
@pytest.mark.parametrize("grad", [False, True], ids=["inference", "grad"])
def test_the_cpu_keeps_the_bias_bit_for_bit(tmp_path, precision, grad):
    model = _model().set_precision(precision)
    x = _patterns(2, 32)
    with trace(tmp_path), torch.set_grad_enabled(grad), model._autocast(x):
        got = model.encoder(x)
        want = _with_bias(model.encoder, x)
    assert COUNTER not in recorded().counters
    assert torch.equal(got, want)
    if grad:
        got.float().square().sum().backward()
        for block in _blocks(model):
            assert block[0].bias.grad is not None


def test_the_blocks_keep_their_parameters():
    model = _model()
    keys = [k for k in model.state_dict() if k.startswith("encoder.")]
    blocks = [i for i, m in enumerate(model.encoder) if isinstance(m, ConvBlock)]
    assert keys == [f"encoder.{i}.0.{p}" for i in blocks for p in ("weight", "bias")]
    assert all(b[0].bias is not None for b in _blocks(model))


def test_the_reader_reads_the_windows_record(monkeypatch):
    read = spec.Benchmark(ROOT).reader("encoder.bias_free_convs_per_batch.index")
    traced = types.SimpleNamespace(trace=object())
    assert read(types.SimpleNamespace(trace=None)) is None  # no window
    rec = Record()
    rec.count("index.batches", 4)
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert read(traced) is None  # no counter: a program whose blocks keep the bias
    rec.count(COUNTER, 40)
    assert read(traced) == 10.0
    monkeypatch.setattr(profiling, "recorded", lambda: None)
    assert read(traced) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without a recorder
    assert read(traced) is None


def test_the_benchmark_lists_the_reader():
    listed = {m["name"]: m for m in spec.Benchmark(ROOT).data["per_layer"]}
    metric = listed["encoder.bias_free_convs_per_batch.index"]
    assert metric["workloads"] == ["ref-scan-index", "scaled-scan-index"]
    assert metric["moves"] == "index_patterns_per_s"
    assert metric["source"] == "program_counter"


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


# (inplanes, latent_dim, n_stages, bottleneck_hw, convolutions): the cells' widths
CARD_WIDTHS = {"ref": (32, 16, 5, 4, 10), "scaled": (64, 64, 6, 2, 12)}


def _generic_adds(prof) -> int:
    """Launches of ATen's generic elementwise kernel (a broadcast add over
    NCHW), not its vectorized or unrolled ones."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum("::elementwise_kernel<" in e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda)


def _unit(mu: torch.Tensor) -> torch.Tensor:
    return mu / mu.norm(dim=1, keepdim=True)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_WIDTHS))
def test_card_encode_leaves_the_bias_out(card, tmp_path, name):
    inplanes, latent, n_stages, hw, convs = CARD_WIDTHS[name]
    model = _model(inplanes, latent, n_stages, hw, device=card).set_precision("16-mixed")
    x = _patterns(16, 128, card)
    with torch.inference_mode():
        model.encode(x)  # builds the kernels
        with trace(tmp_path / "encode"):
            mu = model.encode(x)[0]
        assert recorded().counters[COUNTER] == convs
        with model._autocast(x):
            with trace(tmp_path / "free") as free:
                model.encoder(x)
            with trace(tmp_path / "with") as kept:
                _with_bias(model.encoder, x)
            want = model.mu(_with_bias(model.encoder, x).flatten(1)).float()
        mu32 = model.set_precision("32").encode(x)[0]
    assert _generic_adds(free) == 0
    assert _generic_adds(kept) >= convs
    # One bfloat16 rounding fewer: no farther from float32 than the with-bias
    # forward, within bf16 noise.
    gap = (_unit(mu) - _unit(mu32)).norm(dim=1)
    gap_with = (_unit(want) - _unit(mu32)).norm(dim=1)
    assert gap.max() <= 2 * gap_with.max() + 1e-4, (gap.max(), gap_with.max())


@pytest.mark.card
@pytest.mark.parametrize("precision,grad", [("32", False), ("16-mixed", True)],
                         ids=["f32", "grad"])
def test_card_keeps_the_bias_in_f32_and_under_autograd(card, tmp_path, precision, grad):
    model = _model(*CARD_WIDTHS["ref"][:4], device=card).set_precision(precision)
    x = _patterns(4, 128, card)
    with trace(tmp_path), torch.set_grad_enabled(grad), model._autocast(x):
        got = model.encoder(x)
        want = _with_bias(model.encoder, x)
    assert COUNTER not in recorded().counters
    assert torch.equal(got, want)
    if grad:
        got.float().square().sum().backward()
        assert all(b[0].bias.grad is not None for b in _blocks(model))
