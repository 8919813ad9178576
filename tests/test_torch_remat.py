"""The VAE's ``remat`` (`torch.utils.checkpoint` around each block or stage)
on the CPU, as tests/ops/test_norm_vjp.py::TestRematModes holds the JAX
model's.

* ``"block"`` and ``"stage"`` against ``"none"`` from the same weights,
  batch and noise (4 stages, 64x64, inplanes 2): outputs and the gradient
  of every parameter within `REMAT_ATOL` (measured: equal bitwise in
  float32), in float32 and under bfloat16 autocast, whose recompute runs
  under the same autocast state; state-dict names unchanged.
* The recompute: the norm's forward runs once more per checkpointed norm in
  each backward (all 15 of a 4-stage model with ``"block"``, 14 with
  ``"stage"``: the decoder's last stage is not checkpointed, as in the JAX
  decoder; 19 and 18 at 5 stages), and not at all without autograd.
* The JAX model with ``remat="stage"`` and the port's on the same weights:
  the same loss, as both equal their ``"none"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.train import VAELoss as JaxLoss
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.ops import fused_norm
from latice_tpu_torch.train import VAELoss

REMAT_ATOL = 1e-5
INPLANES, LATENT, BATCH, SIZE, STAGES = 2, 8, 2, 64, 4
NORMS = 4 * STAGES - 1  # two per encoder stage, two per decoder stage but the last's one


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.uniform(size=(BATCH, 1, SIZE, SIZE)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(BATCH, LATENT)).astype(np.float32))
    return x, eps


def _step(remat: str, precision: str, x, eps):
    """Loss, ``x_hat``, gradients, state-dict names and the norm forwards
    of one forward and backward."""
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, remat=remat)
    model.init_weights(torch.Generator().manual_seed(1)).set_precision(precision)
    calls = []
    plain = fused_norm.instance_norm_leaky_relu_plain

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return plain(*a, **k)

    fused_norm.instance_norm_leaky_relu_plain = counted
    try:
        out = model(x, eps=eps)
        loss = VAELoss(5e-6)(*out, x)["loss"]
        forward = len(calls)
        loss.backward()
    finally:
        fused_norm.instance_norm_leaky_relu_plain = plain
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), out.x_hat.detach(), grads, list(model.state_dict()), forward, len(calls)


@pytest.mark.parametrize("precision", ["32", "16-mixed"])
@pytest.mark.parametrize("remat", ["block", "stage"])
def test_outputs_and_grads_match_none(batch, remat, precision):
    x, eps = batch
    loss0, xh0, g0, names0, fwd0, total0 = _step("none", precision, x, eps)
    loss1, xh1, g1, names1, fwd1, total1 = _step(remat, precision, x, eps)
    assert names1 == names0
    torch.testing.assert_close(loss1, loss0, rtol=0, atol=REMAT_ATOL)
    torch.testing.assert_close(xh1, xh0, rtol=0, atol=REMAT_ATOL)
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, rtol=0, atol=REMAT_ATOL, msg=name)
    assert fwd0 == fwd1 == NORMS and total0 == NORMS
    assert total1 - fwd1 == {"block": NORMS, "stage": NORMS - 1}[remat]


def test_no_recompute_without_autograd(batch):
    x, eps = batch
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, remat="stage")
    model.init_weights(torch.Generator().manual_seed(1))
    ref = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES).init_weights(
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(model(x, eps=eps).x_hat, ref(x, eps=eps).x_hat, rtol=0, atol=0)
        torch.testing.assert_close(model.encode(x)[0], ref.encode(x)[0], rtol=0, atol=0)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="remat must be one of"):
        VariationalAutoEncoderRawData(INPLANES, LATENT, remat="layer")


def test_stage_remat_loss_matches_jax(batch):
    x, eps = batch
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT, n_stages=STAGES, remat="stage")
    xj = jnp.asarray(np.moveaxis(x.numpy(), 1, -1))
    params = jax.jit(jm.init)({"params": jax.random.key(1)}, xj[:1], jax.random.key(0))["params"]
    z, x_hat, mu, std = jax.jit(jm.apply)({"params": params}, xj, jax.random.key(0))
    # The port's forward with the noise the JAX model drew.
    eps_j = torch.from_numpy(np.array((z - mu) / std))
    want = float(JaxLoss(5e-6)(z, x_hat, mu, std, xj)["loss"])
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, remat="stage")
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params), INPLANES, LATENT, STAGES, 4))
    out = model(x, eps=eps_j)
    got = float(VAELoss(5e-6)(*out, x)["loss"].detach())
    assert got == pytest.approx(want, rel=1e-5)
