"""One and three train steps of the port against latice_tpu's, on the same
weights and the same noise.

The JAX model is initialized with a fixed key and its params cross over
through `flax_params_to_state_dict`; the port's step gets the noise JAX
draws, ``normal(fold_in(rng, step), (B, latent))``, through its ``eps``
seam. Small model: inplanes 2, latent 8, 3 stages, 32x32 patterns, f32.

Tolerances. Losses within 1e-5 relative for one step, 1e-4 over three.
Gradients within 1e-4 absolute: the two decoders differ in form (JAX folds
each upsample into a dilated conv), equal only to roundoff. The conv biases
in front of an InstanceNorm have an exact gradient of 0; their computed
gradients are roundoff, which Adam's g/(|g|+1e-8) turns into an arbitrary
step of up to lr, so after N steps those biases are held to N*lr and every
other parameter to 1e-6.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.train import VAELoss as JaxLoss
from latice_tpu.train import create_train_state
from latice_tpu.train import make_train_step as jax_make_train_step
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.train import VAELoss, make_optimizer, make_train_step

INPLANES, LATENT, STAGES, HW, SIZE, BATCH = 2, 8, 3, 4, 32, 4
KL = 0.1
LR = 1e-4
_BEFORE_NORM_BIAS = re.compile(r"^(encoder|decoder)\.\d+\.0\.bias$")


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def setup():
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT, n_stages=STAGES, bottleneck_hw=HW)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, SIZE, SIZE, 1)), jax.random.key(1)
    )["params"]
    x = np.random.default_rng(0).uniform(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32)
    return jm, params, x


def _to_torch(tree):
    return flax_params_to_state_dict(
        jax.tree.map(np.asarray, tree), INPLANES, LATENT, STAGES, HW
    )


def _port_model(params):
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, HW)
    model.load_state_dict(_to_torch(params))
    return model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _eps(rng, step):
    return torch.from_numpy(
        np.array(jax.random.normal(jax.random.fold_in(rng, step), (BATCH, LATENT)))
    )


def _is_before_norm_bias(name):
    """Conv and transposed-conv blocks sit at ``{encoder,decoder}.i`` with
    their conv at ``.0``; the logit conv (``decoder.<last>.bias``) has no
    norm after it and does not match."""
    return bool(_BEFORE_NORM_BIAS.match(name))


def test_one_step_loss_and_gradients_match_jax(setup):
    jm, params, x = setup
    rng = jax.random.key(2)
    mask = np.ones(BATCH, np.float32)
    step_rng = jax.random.fold_in(rng, 0)
    loss_fn = JaxLoss(kl_lambda=KL)

    def loss_of(p):
        z, x_hat, mu, std = jm.apply({"params": p}, jnp.asarray(x), step_rng)
        losses = loss_fn(z, x_hat, mu, std, jnp.asarray(x), jnp.asarray(mask))
        return losses["loss"], losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    want_grads = _to_torch(grads)

    model = _port_model(params)
    step = make_train_step(VAELoss(kl_lambda=KL))
    got = step(model, make_optimizer(model.parameters()), _nchw(x),
               torch.from_numpy(mask), 0, _eps(rng, 0))
    for key in ("loss", "kl_loss", "recon_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)
    names = dict(model.named_parameters())
    assert set(names) == set(want_grads)
    for name, p in names.items():
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=0, atol=1e-4, err_msg=name
        )
    assert all(names[f"encoder.{i}.0.weight"].grad.abs().max() > 0
               for i in range(3 * STAGES) if i % 3 != 2)


def test_three_steps_match_jax_train_step(setup):
    jm, params, x = setup
    rng = jax.random.key(3)
    mask = np.ones(BATCH, np.float32)
    state = create_train_state(jm, params, learning_rate=LR, amsgrad=True)
    jax_step = jax_make_train_step(JaxLoss(kl_lambda=KL), donate=False)
    model = _port_model(params)
    opt = make_optimizer(model.parameters(), learning_rate=LR)
    step = make_train_step(VAELoss(kl_lambda=KL))
    for s in range(3):
        state, want = jax_step(state, jnp.asarray(x), rng, jnp.asarray(mask))
        got = step(model, opt, _nchw(x), torch.from_numpy(mask), s, _eps(rng, s))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    want_params = _to_torch(state.params)
    for name, p in model.named_parameters():
        atol = 3 * LR * (1 + 1e-3) if _is_before_norm_bias(name) else 1e-6
        np.testing.assert_allclose(
            p.detach().numpy(), want_params[name].numpy(), rtol=0, atol=atol, err_msg=name
        )


def test_mask_zeroes_pad_rows_gradient(setup):
    """A padded batch with a masked garbage row gives the gradient of the
    unpadded batch."""
    _, params, x = setup
    eps = torch.from_numpy(np.random.default_rng(4).normal(size=(BATCH, LATENT)).astype(np.float32))
    real = BATCH - 1
    padded = _nchw(x).clone()
    padded[real:] = 7.0

    def grads(batch, mask, e):
        model = _port_model(params)
        step = make_train_step(VAELoss(kl_lambda=KL))
        step(model, make_optimizer(model.parameters()), batch, mask, 0, e)
        return {k: p.grad for k, p in model.named_parameters()}

    mask = torch.tensor([1.0] * real + [0.0] * (BATCH - real))
    got = grads(padded, mask, eps)
    want = grads(_nchw(x)[:real], None, eps[:real])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-7, msg=k)
    zero = _nchw(x).clone()
    zero[real:] = 0.0
    assert all(torch.isfinite(g).all() for g in grads(zero, mask, eps).values())


def test_skip_nonfinite_updates_keeps_state(setup):
    _, params, x = setup
    model = _port_model(params)
    opt = make_optimizer(model.parameters())
    step = make_train_step(VAELoss(kl_lambda=KL), skip_nonfinite_updates=True)
    eps = torch.zeros(BATCH, LATENT)
    good = step(model, opt, _nchw(x), None, 0, eps)
    assert float(good["skipped"]) == 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {k: v.clone() for k, v in opt.state[next(model.parameters())].items()
                  if isinstance(v, torch.Tensor)}
    bad = _nchw(x).clone()
    bad[0, 0, 0, 0] = float("nan")
    out = step(model, opt, bad, None, 1, eps)
    assert float(out["skipped"]) == 1.0 and not np.isfinite(float(out["loss"]))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for k, v in opt_before.items():
        torch.testing.assert_close(opt.state[next(model.parameters())][k], v, rtol=0, atol=0)
    assert opt.state[next(model.parameters())]["count"] == 1


def test_keyed_noise_replays(setup):
    """Without eps, the noise of step s depends on (seed, s) only."""
    _, params, x = setup
    losses = []
    for _ in range(2):
        model = _port_model(params)
        step = make_train_step(VAELoss(kl_lambda=KL), seed=11)
        losses.append(float(step(model, make_optimizer(model.parameters()), _nchw(x), None, 5)["loss"]))
    assert losses[0] == losses[1]


def test_mixed_precision_forward_dtypes(setup):
    _, params, x = setup
    model = _port_model(params).set_precision("16-mixed")
    out = model(_nchw(x), eps=torch.zeros(BATCH, LATENT))
    assert out.x_hat.dtype == torch.bfloat16
    assert out.mu.dtype == out.std.dtype == out.z.dtype == torch.float32
    ref = _port_model(params)(_nchw(x), eps=torch.zeros(BATCH, LATENT))
    torch.testing.assert_close(out.mu, ref.mu, rtol=0, atol=5e-2)
    with pytest.raises(ValueError, match="Unknown precision"):
        model.set_precision("8-bit")


def test_unported_step_options_raise(setup):
    """``augment`` and ``denoising``, once refused here, are taken: an
    identity augmentation, with or without the denoising objective, and
    ``denoising`` alone leave the step as it was (tests/test_torch_augment.py
    holds them against the JAX step)."""
    _, params, x = setup
    eps = torch.zeros(BATCH, LATENT)
    losses = []
    for kw in ({}, dict(augment=lambda g, b: b), dict(augment=lambda g, b: b, denoising=True),
               dict(denoising=True)):
        model = _port_model(params)
        step = make_train_step(VAELoss(kl_lambda=KL), **kw)
        losses.append(float(step(model, make_optimizer(model.parameters()), _nchw(x), None, 0,
                                 eps)["loss"]))
    assert losses[1:] == losses[:1] * 3
