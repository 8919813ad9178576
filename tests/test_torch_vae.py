"""The port's VAE against latice_tpu's, on the same weights.

JAX ``init`` with a fixed key; the params cross over through
`flax_params_to_state_dict`. Encode within 1e-4 and decode within 2e-4,
the tolerances of tests/models/test_torch_import.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.models.torch_import import torch_state_dict_to_flax
from latice_tpu_torch.models import (
    VariationalAutoEncoderRawData,
    flax_params_to_state_dict,
    load_checkpoint,
)
from latice_tpu_torch.ops import instance_norm_leaky_relu

# (inplanes, latent_dim, n_stages, bottleneck_hw, image size)
CONFIGS = {
    "5stage": (4, 16, 5, 4, 128),
    "3stage": (4, 8, 3, 4, 32),
    "6stage_hw2": (2, 16, 6, 2, 128),
}


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


def _pair(name, use_pallas=False):
    inplanes, latent, n_stages, hw, size = CONFIGS[name]
    jm = JaxVAE(
        inplanes=inplanes, latent_dim=latent, n_stages=n_stages, bottleneck_hw=hw,
        use_pallas=use_pallas,
    )
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, size, size, 1)), jax.random.key(1)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    tm = VariationalAutoEncoderRawData(inplanes, latent, n_stages, hw)
    tm.load_state_dict(flax_params_to_state_dict(params, inplanes, latent, n_stages, hw))
    return jm, params, tm.eval(), size


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _pair(request.param)


def _encode_both(jm, params, tm, x):
    jmu, jlv = jm.apply({"params": params}, jnp.asarray(x), method="encode")
    with torch.no_grad():
        tmu, tlv = tm.encode(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    return (np.asarray(jmu), np.asarray(jlv)), (tmu.numpy(), tlv.numpy())


def test_encode_matches_jax(pair):
    jm, params, tm, size = pair
    x = np.random.default_rng(0).uniform(size=(2, size, size, 1)).astype(np.float32)
    (jmu, jlv), (tmu, tlv) = _encode_both(jm, params, tm, x)
    np.testing.assert_allclose(tmu, jmu, atol=1e-4)
    np.testing.assert_allclose(tlv, jlv, atol=1e-4)


def test_decode_matches_jax(pair):
    jm, params, tm, size = pair
    z = np.random.default_rng(1).normal(size=(2, tm.latent_dim)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z), method="decode"))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z)).numpy()
    assert got.shape == (2, 1, size, size)
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 1), atol=2e-4)


def test_encode_matches_jax_pallas_kernel(monkeypatch):
    """JAX side on ``use_pallas=True`` with the kernel in interpret mode."""
    import latice_tpu.ops as ops_mod
    from latice_tpu.ops import instance_norm_leaky_relu as jax_kernel

    monkeypatch.setattr(
        ops_mod, "instance_norm_leaky_relu", functools.partial(jax_kernel, interpret=True)
    )
    jm, params, tm, size = _pair("3stage", use_pallas=True)
    x = np.random.default_rng(2).uniform(size=(2, size, size, 1)).astype(np.float32)
    (jmu, jlv), (tmu, tlv) = _encode_both(jm, params, tm, x)
    np.testing.assert_allclose(tmu, jmu, atol=1e-4)
    np.testing.assert_allclose(tlv, jlv, atol=1e-4)
    assert instance_norm_leaky_relu.launches == 0  # CPU: the plain twin ran


def test_state_dict_round_trips_exactly():
    _, params, tm, _ = _pair("5stage")
    back = torch_state_dict_to_flax(tm.state_dict(), inplanes=4, latent_dim=16)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_orig = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_orig)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_orig[path])


def test_state_dict_keys_are_reference_layout():
    keys = set(VariationalAutoEncoderRawData(4, 16).state_dict())
    assert "encoder.0.0.weight" in keys and "encoder.13.0.bias" in keys
    assert "encoder.2.weight" not in keys  # pools carry nothing
    assert {"mu.0.weight", "logvar.0.weight", "linear2.0.weight"} <= keys
    assert "decoder.13.0.weight" in keys and "decoder.14.weight" in keys
    assert len(keys) == 2 * (10 + 9 + 1 + 3)


def test_load_checkpoint_strips_lightning_prefix(tmp_path):
    src = VariationalAutoEncoderRawData(2, 8, n_stages=3)
    src.init_weights(torch.Generator().manual_seed(3))
    path = tmp_path / "vae.pt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in src.state_dict().items()}}, path)
    got = load_checkpoint(str(path), 2, 8, n_stages=3, device="cpu")
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    assert not got.training


def test_init_weights_is_seeded():
    a = VariationalAutoEncoderRawData(2, 8, n_stages=3).init_weights(
        torch.Generator().manual_seed(5)
    )
    b = VariationalAutoEncoderRawData(2, 8, n_stages=3).init_weights(
        torch.Generator().manual_seed(5)
    )
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


def test_forward_and_reparameterize():
    model = VariationalAutoEncoderRawData(2, 8, n_stages=3).init_weights(
        torch.Generator().manual_seed(6)
    )
    x = torch.rand(3, 1, 32, 32, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        out = model(x, generator=torch.Generator().manual_seed(8))
        again = model(x, generator=torch.Generator().manual_seed(8))
        mu, logvar = model.encode(x)
    assert out.x_hat.shape == (3, 1, 32, 32) and out.z.shape == (3, 8)
    torch.testing.assert_close(out.z, again.z, rtol=0, atol=0)
    torch.testing.assert_close(out.mu, mu, rtol=0, atol=0)
    torch.testing.assert_close(out.std, torch.exp(logvar / 2), rtol=0, atol=0)
    eps = torch.randn((3, 8), generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(out.z, mu + out.std * eps)
