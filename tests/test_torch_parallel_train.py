"""Data-parallel training over a port mesh of four CPU entries, against the
one-device step and against latice_tpu's data-parallel step.

Small model: inplanes 2, latent 8, 3 stages, 32x32 patterns, f32, batch 8
(two rows per replica). The noise is the one JAX draws,
``normal(fold_in(rng, step), (B, latent))``, passed through the steps'
``eps`` seam as tests/test_torch_train_step.py passes it.

Tolerances. The DP step against the one-device step: the loss at rtol 1e-5,
every summed gradient leaf within 1e-5 of its scale (the leaf's largest
|gradient|, and for the conv biases in front of an InstanceNorm, whose exact
gradient is 0 and whose computed one is roundoff, the model's largest), the
updated parameters within 1e-6. Adam turns a roundoff gradient into a step
of up to lr in an arbitrary direction (g/(|g|+1e-8)), so after N steps two
runs can hold those biases up to 2*N*lr apart, and they are held to that.
Against JAX's DP step: the loss at rtol 1e-5 and the updated parameters the
same way.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.parallel import make_mesh as jax_make_mesh
from latice_tpu.parallel import replicate_state as jax_replicate_state
from latice_tpu.parallel import shard_batch as jax_shard_batch
from latice_tpu.train import VAELoss as JaxLoss
from latice_tpu.train import create_train_state
from latice_tpu.train import make_train_step as jax_make_train_step
from latice_tpu_torch.data import DPDataModule
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.parallel import make_mesh
from latice_tpu_torch.train import (
    Trainer,
    VAELoss,
    VAEModule,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from latice_tpu_torch.train.steps import model_replicas

INPLANES, LATENT, STAGES, HW, SIZE, BATCH = 2, 8, 3, 4, 32, 8
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
def mesh():
    return make_mesh(devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def setup():
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT, n_stages=STAGES, bottleneck_hw=HW)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, SIZE, SIZE, 1)), jax.random.key(1)
    )["params"]
    x = np.random.default_rng(0).uniform(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32)
    return jm, params, x


def _port_model(params):
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, HW)
    model.load_state_dict(
        flax_params_to_state_dict(jax.tree.map(np.asarray, params), INPLANES, LATENT, STAGES, HW)
    )
    return model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _eps(rng, step):
    return torch.from_numpy(
        np.array(jax.random.normal(jax.random.fold_in(rng, step), (BATCH, LATENT)))
    )


def _param_atol(name, steps=1):
    return 2 * steps * LR * (1 + 1e-3) if _BEFORE_NORM_BIAS.match(name) else 1e-6


@pytest.fixture(scope="module")
def one_step(setup, mesh):
    """One step on one device and over the mesh, from the same weights,
    batch, mask (the last two rows padding) and noise."""
    _, params, x = setup
    mask = torch.tensor([1.0] * (BATCH - 2) + [0.0] * 2)
    eps = _eps(jax.random.key(2), 0)
    out = {}
    for name, m in (("one", None), ("dp", mesh)):
        model = _port_model(params)
        opt = make_optimizer(model.parameters(), learning_rate=LR)
        grads = {}
        metrics = make_train_step(VAELoss(kl_lambda=KL), mesh=m)(
            model, opt, _nchw(x), mask, 0, eps
        )
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        out[name] = (metrics, grads, model)
    return out


def test_dp_step_loss_matches_one_device(one_step):
    (m1, _, _), (m4, _, _) = one_step["one"], one_step["dp"]
    for key in ("loss", "kl_loss", "recon_loss"):
        np.testing.assert_allclose(float(m4[key]), float(m1[key]), rtol=1e-5, err_msg=key)


def test_dp_step_summed_gradients_match_one_device(one_step):
    (_, g1, _), (_, g4, _) = one_step["one"], one_step["dp"]
    assert set(g1) == set(g4)
    model_scale = max(float(g.abs().max()) for g in g1.values())
    for name, want in g1.items():
        scale = model_scale if _BEFORE_NORM_BIAS.match(name) else float(want.abs().max())
        err = float((g4[name] - want).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)


def test_dp_step_update_matches_one_device(one_step):
    (_, _, p1), (_, _, p4) = one_step["one"], one_step["dp"]
    want = dict(p1.named_parameters())
    for name, p in p4.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), rtol=0,
                                   atol=_param_atol(name), err_msg=name)


def test_dp_step_matches_jax_dp_step(setup, mesh):
    """JAX's step on a batch sharded over a 4-device mesh with a replicated
    state against the port's over a 4-entry mesh."""
    jm, params, x = setup
    rng = jax.random.key(3)
    mask = np.ones(BATCH, np.float32)
    jax_mesh = jax_make_mesh(4)
    state = jax_replicate_state(create_train_state(jm, params, learning_rate=LR, amsgrad=True),
                                jax_mesh)
    jax_step = jax_make_train_step(JaxLoss(kl_lambda=KL), donate=False)
    state, want = jax_step(state, jax_shard_batch(jnp.asarray(x), jax_mesh), rng,
                           jnp.asarray(mask))
    model = _port_model(params)
    opt = make_optimizer(model.parameters(), learning_rate=LR)
    got = make_train_step(VAELoss(kl_lambda=KL), mesh=mesh)(
        model, opt, _nchw(x), torch.from_numpy(mask), 0, _eps(rng, 0)
    )
    for key in ("loss", "kl_loss", "recon_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    want_params = flax_params_to_state_dict(
        jax.tree.map(np.asarray, state.params), INPLANES, LATENT, STAGES, HW
    )
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(), rtol=0,
                                   atol=_param_atol(name), err_msg=name)


def test_dp_keyed_noise_is_the_one_device_draw(setup, mesh):
    """Without ``eps`` the DP step draws the global batch's noise once, as
    one device draws it: the two steps agree with no seam."""
    _, params, x = setup
    losses = []
    for m in (None, mesh):
        model = _port_model(params)
        opt = make_optimizer(model.parameters(), learning_rate=LR)
        step = make_train_step(VAELoss(kl_lambda=KL), seed=9, mesh=m)
        losses.append([float(step(model, opt, _nchw(x), None, s)["loss"]) for s in range(2)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_dp_eval_step_matches_one_device(setup, mesh):
    _, params, x = setup
    model = _port_model(params)
    mask = torch.tensor([1.0] * (BATCH - 3) + [0.0] * 3)
    m1, r1 = make_eval_step(VAELoss(kl_lambda=KL), return_recon=True, seed=4)(
        model, _nchw(x), mask, key=7
    )
    m4, r4 = make_eval_step(VAELoss(kl_lambda=KL), return_recon=True, seed=4, mesh=mesh)(
        model, _nchw(x), mask, key=7
    )
    for key in ("loss", "kl_loss", "recon_loss"):
        np.testing.assert_allclose(float(m4[key]), float(m1[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(r4.numpy(), r1.numpy(), rtol=0, atol=1e-5)


def test_multi_step_stability(setup, mesh):
    """Five DP steps on one batch lower the loss, and the replicas stay
    copies of the model."""
    _, params, x = setup
    model = _port_model(params)
    opt = make_optimizer(model.parameters(), learning_rate=1e-3)
    step = make_train_step(VAELoss(kl_lambda=KL), mesh=mesh)
    losses = [float(step(model, opt, _nchw(x), None, s)["loss"]) for s in range(5)]
    assert losses[-1] < losses[0]
    reps = model_replicas(model, mesh)
    assert len(reps) == 4 and reps[0] is model
    for rep in reps[1:]:
        for (name, p), q in zip(model.named_parameters(), rep.parameters()):
            torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)


def test_dp_step_checks(setup, mesh):
    _, params, x = setup
    model = _port_model(params)
    opt = make_optimizer(model.parameters())
    step = make_train_step(VAELoss(kl_lambda=KL), mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        step(model, opt, _nchw(x[:6]), None, 0)
    with pytest.raises(ValueError, match="first device"):
        model_replicas(model.to("meta"), mesh)


def _fit(dataset, mesh, batch_size):
    trainer = Trainer(max_epochs=1, precision="32", seed=3, device="cpu", mesh=mesh,
                      enable_progress_bar=False, recon_figure=False)
    module = VAEModule(VariationalAutoEncoderRawData(2, 8, n_stages=3), kl_lambda=0.1)
    dm = DPDataModule(*dataset, image_size=(32, 32), batch_size=batch_size, seed=5)
    return trainer, trainer.fit(module, dm)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """3*4+1 training rows after the split, so the last batch is padded."""
    d = tmp_path_factory.mktemp("dp_data")
    rng = np.random.default_rng(1)
    n = 16
    np.save(d / "patterns.npy", rng.uniform(size=(n, 36, 36)).astype(np.float32))
    with open(d / "angles.txt", "w") as f:
        f.write(f"eu\n{n}\n")
        np.savetxt(f, rng.uniform(0, 90, (n, 3)), fmt="%.4f")
    return d / "patterns.npy", d / "angles.txt"


def test_trainer_padded_tail_epoch_over_mesh(dataset, mesh):
    """One epoch with a padded tail batch over the mesh ends at the
    one-device run's metrics and weights."""
    one, m1 = _fit(dataset, None, 4)
    four, m4 = _fit(dataset, mesh, 4)
    assert four.steps_run == one.steps_run and one.steps_run["train"] >= 3
    for key, want in one.history[0].items():
        if key != "epoch_time_s":
            np.testing.assert_allclose(four.history[0][key], want, rtol=1e-5, err_msg=key)
    want = dict(m1.named_parameters())
    for name, p in m4.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), rtol=0,
                                   atol=_param_atol(name, one.steps_run["train"]), err_msg=name)
    with pytest.raises(ValueError, match="divide by the mesh size"):
        _fit(dataset, mesh, 6)
