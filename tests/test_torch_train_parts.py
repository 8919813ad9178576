"""The port's loss, optimizer, plateau schedule and epoch metrics against
latice_tpu.train, on the same numbers.

Loss within 1e-6; the optimizer's parameters within rtol 1e-6 of optax
over 6 steps of shrinking gradients with one learning-rate change; the
schedule's rates exactly.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latice_tpu.train import EpochAggregator as JaxAggregator
from latice_tpu.train import ReduceLROnPlateau as JaxPlateau
from latice_tpu.train import VAELoss as JaxLoss
from latice_tpu.train import gaussian_likelihood as jax_gaussian_likelihood
from latice_tpu_torch.train import (
    EpochAggregator,
    OptaxAdam,
    ReduceLROnPlateau,
    VAELoss,
    gaussian_likelihood,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)


def _loss_inputs(seed=0, b=5, latent=8, hw=16):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(b, latent)).astype(np.float32)
    std = np.exp(rng.normal(size=(b, latent)) * 0.3).astype(np.float32)
    z = (mu + std * rng.normal(size=(b, latent))).astype(np.float32)
    x_hat = (rng.normal(size=(b, hw, hw, 1)) * 2).astype(np.float32)
    x = rng.uniform(size=(b, hw, hw, 1)).astype(np.float32)
    return z, x_hat, mu, std, x


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("masked", [False, True])
def test_vae_loss_matches_jax(masked):
    z, x_hat, mu, std, x = _loss_inputs()
    mask = np.asarray([1, 1, 0, 1, 0], np.float32) if masked else None
    want = JaxLoss(kl_lambda=0.3)(
        *(jnp.asarray(a) for a in (z, x_hat, mu, std, x)),
        None if mask is None else jnp.asarray(mask),
    )
    got = VAELoss(kl_lambda=0.3)(
        torch.from_numpy(z), _nchw(x_hat), torch.from_numpy(mu), torch.from_numpy(std), _nchw(x),
        None if mask is None else torch.from_numpy(mask),
    )
    assert set(got) == set(want) == {"loss", "kl_loss", "recon_loss", "elbo"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-6)


def test_masked_loss_ignores_pad_rows():
    z, x_hat, mu, std, x = _loss_inputs(seed=1)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])
    args = [torch.from_numpy(z), _nchw(x_hat), torch.from_numpy(mu), torch.from_numpy(std), _nchw(x)]
    full = VAELoss(0.1)(*args, mask)
    garbage = [a.clone() for a in args]
    for a in garbage:
        a[3:] = 1e3
    assert torch.allclose(VAELoss(0.1)(*garbage, mask)["loss"], full["loss"])
    head = VAELoss(0.1)(*(a[:3] for a in args))
    torch.testing.assert_close(full["loss"], head["loss"], rtol=1e-6, atol=0)


def test_gaussian_likelihood_matches_jax():
    rng = np.random.default_rng(2)
    x_hat = rng.normal(size=(3, 4, 4, 1)).astype(np.float32)
    x = rng.normal(size=(3, 4, 4, 1)).astype(np.float32)
    want = jax_gaussian_likelihood(jnp.asarray(x_hat), jnp.asarray(0.2), jnp.asarray(x))
    got = gaussian_likelihood(_nchw(x_hat), torch.tensor(0.2), _nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _shrinking_grads(seed=3, steps=6):
    """Per step, gradients for two parameters that first grow, then shrink
    by 10x per step: the second moment falls, where AMSGrad's max matters."""
    rng = np.random.default_rng(seed)
    base = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    scales = [1.0, 2.0, 0.2, 0.02, 0.002, 0.0002][:steps]
    return [[b * np.float32(s) + rng.normal(size=b.shape).astype(np.float32) * 1e-3 * s
             for b in base] for s in scales]


def _run_optax(inner, params0, grads, lr_change_at=3, new_lr=3e-4):
    tx = optax.inject_hyperparams(inner)(learning_rate=1e-3)
    params = [jnp.asarray(p) for p in params0]
    state = tx.init(params)
    history = []
    for i, g in enumerate(grads):
        if i == lr_change_at:
            state.hyperparams["learning_rate"] = jnp.asarray(new_lr, jnp.float32)
        updates, state = tx.update([jnp.asarray(a) for a in g], state, params)
        params = optax.apply_updates(params, updates)
        history.append([np.asarray(p) for p in params])
    return history


def _run_torch(opt_factory, params0, grads, lr_change_at=3, new_lr=3e-4):
    params = [torch.tensor(p, requires_grad=True) for p in params0]
    opt = opt_factory(params)
    history = []
    for i, g in enumerate(grads):
        if i == lr_change_at:
            set_learning_rate(opt, new_lr)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
        history.append([p.detach().numpy().copy() for p in params])
    return history, opt


@pytest.mark.parametrize("amsgrad", [True, False])
def test_optimizer_matches_optax(amsgrad):
    grads = _shrinking_grads()
    params0 = [np.full((4, 3), 0.5, np.float32), np.linspace(-1, 1, 5).astype(np.float32)]
    want = _run_optax(optax.amsgrad if amsgrad else optax.adam, params0, grads)
    got, opt = _run_torch(
        lambda ps: make_optimizer(ps, learning_rate=1e-3, amsgrad=amsgrad), params0, grads
    )
    assert isinstance(opt, OptaxAdam) and get_learning_rate(opt) == pytest.approx(3e-4)
    for step, (w, g) in enumerate(zip(want, got)):
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f"step {step}")
    # The moved distance itself agrees, not only the parameters.
    for a0, a, b in zip(params0, want[-1], got[-1]):
        np.testing.assert_allclose(b - a0, a - a0, rtol=1e-4, atol=1e-9)


def test_torch_amsgrad_differs_from_optax():
    """torch.optim.Adam(amsgrad=True) maxes the raw second moment: on
    shrinking gradients it leaves optax's path (hazard pinned here)."""
    grads = _shrinking_grads()
    params0 = [np.full((4, 3), 0.5, np.float32), np.linspace(-1, 1, 5).astype(np.float32)]
    want = _run_optax(optax.amsgrad, params0, grads)
    got, _ = _run_torch(
        lambda ps: torch.optim.Adam(ps, lr=1e-3, amsgrad=True, eps=1e-8), params0, grads
    )
    moved = [np.abs(b - a).max() for a, b in zip(want[-1], got[-1])]
    assert max(moved) > 1e-5


def test_optimizer_state_round_trips():
    grads = _shrinking_grads(steps=4)
    params0 = [np.zeros((4, 3), np.float32), np.zeros(5, np.float32)]
    _, opt = _run_torch(lambda ps: make_optimizer(ps, 1e-3), params0, grads[:2])
    sd = opt.state_dict()
    assert {"count", "mu", "nu", "nu_max"} <= set(sd["state"][0])
    assert sd["state"][0]["count"] == 2


def test_plateau_schedule_matches_jax():
    rng = np.random.default_rng(4)
    metrics = list(np.concatenate([np.linspace(1.0, 0.5, 8), 0.5 + rng.uniform(0, 0.1, 22)]))
    for kw in (dict(), dict(patience=2, cooldown=1), dict(patience=3, threshold_mode="abs",
                                                          threshold=0.01, min_lr=1e-6)):
        ours, theirs = ReduceLROnPlateau(**kw), JaxPlateau(**kw)
        lr_a = lr_b = 1e-3
        for m in metrics:
            lr_a, lr_b = ours.step(m, lr_a), theirs.step(m, lr_b)
            assert lr_a == lr_b
        assert lr_a < 1e-3 or kw == {}


def test_epoch_aggregator_matches_jax():
    ours, theirs = EpochAggregator("train_"), JaxAggregator("train_")
    for step, w in ((dict(loss=1.0, kl_loss=0.1), 64), (dict(loss=3.0, kl_loss=0.2), 10)):
        assert ours.update(step, w) == theirs.update(step, w)
    assert ours.epoch_metrics() == theirs.epoch_metrics()
    assert set(ours.epoch_metrics()) == {"Epoch_train_loss", "Epoch_train_kl_loss"}
    assert len(ours) == 2


def test_epoch_aggregator_raises_on_non_finite():
    agg = EpochAggregator("val_")
    with pytest.raises(FloatingPointError, match="val_loss"):
        agg.update({"loss": float("nan")})
