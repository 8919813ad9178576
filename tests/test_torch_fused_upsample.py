"""The decoder's fused upsample (each nearest-2x upsample folded into the
next ConvTranspose3x3 as one stride-2 transposed convolution over a
composed 4x4 kernel) against the JAX package's fused decoder and against
the port's materialized path, on the CPU.

Tolerance 5e-5 on values and on every gradient, the bound of
tests/models/test_fused_upsample.py; JAX's weights cross over through
`flax_params_to_state_dict` (inplanes 2, 3 stages, 32x32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.models.torch_import import torch_state_dict_to_flax
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.models.vae import Decoder

ATOL = 5e-5
INPLANES, LATENT, STAGES, HW, SIZE = 2, 8, 3, 4, 32


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def jax_model():
    """The JAX VAE (fused decoder by default), its params, and ``z``."""
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT, n_stages=STAGES, bottleneck_hw=HW)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, SIZE, SIZE, 1)), jax.random.key(1)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    z = np.random.default_rng(7).normal(size=(2, LATENT)).astype(np.float32)
    return jm, params, z


def _port(params, fuse: bool, remat: str = "none") -> VariationalAutoEncoderRawData:
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, HW, remat=remat)
    model.decoder = Decoder(INPLANES, STAGES, remat, fuse_upsample=fuse)
    model.load_state_dict(flax_params_to_state_dict(params, INPLANES, LATENT, STAGES, HW))
    return model


def _decode_and_grads(model, z: np.ndarray):
    """Decoded logits and the gradient of ``mean(x_hat ** 2)`` for every
    parameter of linear2 and the decoder."""
    model.zero_grad(set_to_none=True)
    x_hat = model.decode(torch.from_numpy(z))
    (x_hat**2).mean().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return x_hat.detach(), grads


def _jax_decode_and_grads(jm, params, z):
    def loss(p):
        return (jm.apply({"params": p}, jnp.asarray(z), method="decode") ** 2).mean()

    x_hat = jm.apply({"params": params}, jnp.asarray(z), method="decode")
    grads = jax.tree.map(np.asarray, jax.grad(loss)(params))
    state = flax_params_to_state_dict(grads, INPLANES, LATENT, STAGES, HW)
    return np.moveaxis(np.asarray(x_hat), -1, 1), state


@pytest.fixture(scope="module")
def runs(jax_model):
    jm, params, z = jax_model
    return {
        "jax": _jax_decode_and_grads(jm, params, z),
        "fused": _decode_and_grads(_port(params, True), z),
        "materialized": _decode_and_grads(_port(params, False), z),
    }


def test_fused_decode_matches_jax(runs):
    want, _ = runs["jax"]
    got, _ = runs["fused"]
    assert got.shape == (2, 1, SIZE, SIZE)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_fused_gradients_match_jax(runs):
    _, want = runs["jax"]
    _, got = runs["fused"]
    assert set(got) == {k for k in want if k.startswith(("decoder.", "linear2."))}
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), atol=ATOL, err_msg=name)


def test_fused_matches_materialized(runs):
    (fused, g_fused), (plain, g_plain) = runs["fused"], runs["materialized"]
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=ATOL)
    assert set(g_fused) == set(g_plain)
    for name in g_plain:
        np.testing.assert_allclose(g_fused[name].numpy(), g_plain[name].numpy(), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("remat", ["none", "block", "stage"])
def test_state_dict_keys_equal_in_both_modes(jax_model, runs, remat):
    """The same keys fused and materialized under every ``remat`` mode (a
    reference checkpoint loads either way), and each mode decodes as the
    un-rematerialized fused model."""
    _, params, z = jax_model
    fused, plain = _port(params, True, remat), _port(params, False, remat)
    assert list(fused.state_dict()) == list(plain.state_dict())
    assert list(fused.state_dict()) == list(VariationalAutoEncoderRawData(
        INPLANES, LATENT, STAGES, HW).state_dict())
    got, grads = _decode_and_grads(fused, z)
    want, want_grads = runs["fused"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    for name in want_grads:
        np.testing.assert_allclose(grads[name].numpy(), want_grads[name].numpy(), atol=ATOL)


def test_port_weights_carry_to_jax_fused_decoder():
    """Port weights drawn by the port cross into the JAX model through
    `torch_state_dict_to_flax` (the reference's 5 stages) and decode alike,
    both fused."""
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT)
    port = VariationalAutoEncoderRawData(INPLANES, LATENT)
    port.init_weights(torch.Generator().manual_seed(3))
    params = torch_state_dict_to_flax(port.state_dict(), inplanes=INPLANES, latent_dim=LATENT)
    z = np.random.default_rng(8).normal(size=(2, LATENT)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(z), method="decode")
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
    assert got.shape == (2, 1, 128, 128)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 1), atol=ATOL)


def test_env_switch_honoured(jax_model, monkeypatch):
    """``LATICE_TPU_FUSED_UPSAMPLE=0`` builds the materialized decoder in
    the port as it restores that path in the JAX decoder; ``1`` fuses."""
    jm, params, z = jax_model
    monkeypatch.setenv("LATICE_TPU_FUSED_UPSAMPLE", "0")
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, HW)
    assert model.decoder.fuse_upsample is False
    assert isinstance(model.decoder[0], torch.nn.Upsample)
    model.load_state_dict(flax_params_to_state_dict(params, INPLANES, LATENT, STAGES, HW))
    want = np.moveaxis(np.asarray(jm.apply({"params": params}, jnp.asarray(z),
                                           method="decode")), -1, 1)
    with torch.no_grad():
        np.testing.assert_allclose(model.decode(torch.from_numpy(z)).numpy(), want, atol=ATOL)
    assert Decoder(INPLANES, STAGES, fuse_upsample=True).fuse_upsample is False
    monkeypatch.setenv("LATICE_TPU_FUSED_UPSAMPLE", "1")
    assert Decoder(INPLANES, STAGES, fuse_upsample=False).fuse_upsample is True
    monkeypatch.delenv("LATICE_TPU_FUSED_UPSAMPLE")
    assert Decoder(INPLANES, STAGES).fuse_upsample is True


def test_fused_bf16_autocast_matches_materialized(jax_model, runs):
    """Under bfloat16 autocast the 4x4 kernel is composed from the float32
    parameter before the cast. The fused bf16 decode is as close to the
    float32 decode as the materialized bf16 decode is (within 2x, plus
    1e-3), the rule `chip_smoke.py` holds 16-mixed serving to."""
    _, params, z = jax_model
    want = runs["fused"][0].numpy()
    err = {}
    for fuse in (True, False):
        model = _port(params, fuse).set_precision("16-mixed")
        with torch.no_grad():
            out = model.decode(torch.from_numpy(z))
        assert out.dtype == torch.bfloat16
        err[fuse] = np.abs(out.float().numpy() - want).max()
    assert err[True] <= 2 * err[False] + 1e-3, err
