"""The port's training augmentation (`latice_tpu_torch.data.augment`) and
the train step's ``augment`` / ``denoising`` against the JAX package's, on
the CPU.

* Each stage alone and the composition: the port's `apply_augment` fed the
  draws ``jax.random`` makes inside `latice_tpu.data.make_augment_fn`
  (the same key splits), against that function's output, within
  `AUG_ATOL` (measured: 0 for the shift, scale, offset and noise; 6e-8
  for gamma alone and 1.2e-7 composed, ``pow`` in another library). NHWC
  batches of 16x20, so rows and columns cannot swap unseen.
* The validation errors, with the JAX package's messages.
* One train step with a deterministic augmentation, with and without
  ``denoising``, against the JAX step on the same weights and the noise
  JAX draws after splitting off its augmentation key: loss within 1e-5
  relative; parameters after the step within 1e-6, but the conv biases in
  front of an InstanceNorm: their exact gradient is 0, so Adam's step on
  each side's roundoff is arbitrary up to lr, and the two sides within
  2 lr (tests/test_torch_train_step.py).
* The port's own draws: keyed, in range, and the trainer taking an
  `AugmentConfig` with the denoising objective, validation unaugmented.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.data import AugmentConfig as JaxAugmentConfig
from latice_tpu.data import make_augment_fn as jax_make_augment_fn
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.train import VAELoss as JaxLoss
from latice_tpu.train import create_train_state
from latice_tpu.train import make_train_step as jax_make_train_step
from latice_tpu_torch.data import AugmentConfig, DPDataModule, make_augment_fn
from latice_tpu_torch.data.augment import AugmentDraws, apply_augment, draw_augment
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.train import Trainer, VAELoss, VAEModule, make_optimizer, make_train_step

AUG_ATOL = 1e-6
INPLANES, LATENT, STAGES, HW, SIZE, BATCH = 2, 8, 3, 4, 32, 4
KL, LR = 0.1, 1e-4
_BEFORE_NORM_BIAS = re.compile(r"^(encoder|decoder)\.\d+\.0\.bias$")
ROBUST = dict(noise_std=0.05, intensity_range=(0.9, 1.1), offset_range=(-0.05, 0.05),
              gamma_range=(0.8, 1.25), shift_px=2)  # conf/trainer/robust.yaml


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _jax_draws(cfg: dict, key, x: np.ndarray) -> AugmentDraws:
    """The draws `latice_tpu.data.make_augment_fn` makes from ``key``."""
    b = x.shape[0]
    k_shift, k_scale, k_off, k_gamma, k_noise = jax.random.split(key, 5)

    def uniform(k, rng_):
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (b,), minval=rng_[0], maxval=rng_[1])))

    s = cfg.get("shift_px")
    return AugmentDraws(
        shift=torch.from_numpy(np.array(jax.random.randint(k_shift, (b, 2), 0, 2 * s + 1)))
        if s else None,
        scale=uniform(k_scale, cfg["intensity_range"]) if "intensity_range" in cfg else None,
        offset=uniform(k_off, cfg["offset_range"]) if "offset_range" in cfg else None,
        gamma=uniform(k_gamma, cfg["gamma_range"]) if "gamma_range" in cfg else None,
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, x.shape, jnp.float32)))
        if cfg.get("noise_std") else None,
    )


CASES = {
    "shift": dict(shift_px=3),
    "shift_zero": dict(shift_px=0),
    "scale": dict(intensity_range=(0.8, 1.2)),
    "offset": dict(offset_range=(-0.1, 0.1)),
    "gamma": dict(gamma_range=(0.7, 1.4)),
    "noise": dict(noise_std=0.05),
    "robust": ROBUST,
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_application_on_jax_draws_matches_jax(case, seed):
    cfg = CASES[case]
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(5, 16, 20, 1)) - 0.2).astype(np.float32)  # gamma meets x < 0
    key = jax.random.key(seed + 10)
    want = np.asarray(jax_make_augment_fn(JaxAugmentConfig(**cfg))(key, jnp.asarray(x)))
    got = apply_augment(AugmentConfig(**cfg), torch.from_numpy(x), _jax_draws(cfg, key, x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_ATOL)


@pytest.mark.parametrize("cfg", [
    dict(intensity_range=(1.1, 0.9)),
    dict(offset_range=(0.1,)),
    dict(gamma_range=(0.0, 1.0)),
    dict(gamma_range=(-1.0, 1.0)),
    dict(shift_px=-1),
])
def test_validation_matches_jax(cfg):
    with pytest.raises(ValueError) as jax_err:
        jax_make_augment_fn(JaxAugmentConfig(**cfg))
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        make_augment_fn(AugmentConfig(**cfg))


def test_port_draws_keyed_and_in_range():
    cfg = AugmentConfig(**ROBUST)
    x = torch.rand((64, 8, 8, 1), generator=torch.Generator().manual_seed(0))
    a, b = (draw_augment(cfg, torch.Generator().manual_seed(3), x) for _ in range(2))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert a.shift.min() >= 0 and a.shift.max() <= 4 and len(set(a.shift.flatten().tolist())) == 5
    assert 0.9 <= a.scale.min() and a.scale.max() <= 1.1
    assert -0.05 <= a.offset.min() and a.offset.max() <= 0.05
    assert 0.8 <= a.gamma.min() and a.gamma.max() <= 1.25
    assert a.noise.shape == x.shape
    out = make_augment_fn(cfg)(torch.Generator().manual_seed(3), x)
    torch.testing.assert_close(out, apply_augment(cfg, x, a), rtol=0, atol=0)


@pytest.fixture(scope="module")
def setup():
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT, n_stages=STAGES, bottleneck_hw=HW)
    params = jax.jit(jm.init)(
        {"params": jax.random.key(0)}, jnp.zeros((1, SIZE, SIZE, 1)), jax.random.key(1)
    )["params"]
    x = np.random.default_rng(0).uniform(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32)
    return jm, params, x


def _to_torch(tree):
    return flax_params_to_state_dict(jax.tree.map(np.asarray, tree), INPLANES, LATENT, STAGES, HW)


@pytest.mark.parametrize("denoising", [False, True])
def test_train_step_with_augment_matches_jax(setup, denoising):
    jm, params, x = setup
    rng = jax.random.key(4)
    mask = np.ones(BATCH, np.float32)
    state = create_train_state(jm, params, learning_rate=LR, amsgrad=True)
    jax_step = jax_make_train_step(JaxLoss(kl_lambda=KL), donate=False,
                                   augment=lambda key, b: 0.8 * b + 0.1, denoising=denoising)
    state, want = jax_step(state, jnp.asarray(x), rng, jnp.asarray(mask))
    # The JAX step splits the augmentation key off fold_in(rng, step) and
    # draws the noise from the rest.
    _, noise_key = jax.random.split(jax.random.fold_in(rng, 0))
    eps = torch.from_numpy(np.array(jax.random.normal(noise_key, (BATCH, LATENT))))

    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, HW)
    model.load_state_dict(_to_torch(params))
    step = make_train_step(VAELoss(kl_lambda=KL), augment=lambda gen, b: 0.8 * b + 0.1,
                           denoising=denoising)
    batch = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    got = step(model, make_optimizer(model.parameters(), learning_rate=LR), batch,
               torch.from_numpy(mask), 0, eps)
    for key in ("loss", "kl_loss", "recon_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)
    want_params = _to_torch(state.params)
    for name, p in model.named_parameters():
        atol = 2 * LR * (1 + 1e-3) if _BEFORE_NORM_BIAS.match(name) else 1e-6
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(), rtol=0,
                                   atol=atol, err_msg=name)


def test_denoising_targets_the_clean_batch(setup):
    """With ``denoising`` the reconstruction loss reads the batch as given;
    without it, the augmented one (the same model, weights and noise)."""
    _, params, x = setup
    batch = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    eps = torch.zeros(BATCH, LATENT)
    loss = VAELoss(kl_lambda=KL)
    recon = {}
    for denoising in (False, True):
        model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, HW)
        model.load_state_dict(_to_torch(params))
        step = make_train_step(loss, augment=lambda gen, b: 0.5 * b, denoising=denoising)
        recon[denoising] = float(step(model, make_optimizer(model.parameters()), batch, None,
                                      0, eps)["recon_loss"])
        model.load_state_dict(_to_torch(params))
        with torch.no_grad():
            out = model(0.5 * batch, eps=eps)
        target = batch if denoising else 0.5 * batch
        assert recon[denoising] == pytest.approx(float(loss(*out, target)["recon_loss"]),
                                                 rel=1e-6)
    assert recon[False] != recon[True]


def test_trainer_takes_augment_config(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "p.npy", rng.uniform(size=(24, 32, 32)).astype(np.float32))
    with open(tmp_path / "a.txt", "w") as f:
        f.write("eu\n24\n")
        np.savetxt(f, rng.uniform(0, 90, (24, 3)), fmt="%.4f")
    dm = DPDataModule(tmp_path / "p.npy", tmp_path / "a.txt", image_size=(32, 32),
                      batch_size=8, seed=5)
    trainer = Trainer(max_epochs=1, precision="32", seed=3, device="cpu",
                      augment=AugmentConfig(**ROBUST), denoising=True)
    assert callable(trainer.augment) and trainer.denoising
    trainer.fit(VAEModule(VariationalAutoEncoderRawData(2, 8, n_stages=3), kl_lambda=0.1), dm)
    assert trainer.steps_run == {"train": 3, "val": 1}
    assert all(np.isfinite(v) for v in trainer.history[0].values())
    with pytest.raises(TypeError, match="AugmentConfig"):
        Trainer(device="cpu", augment={"noise_std": 0.1})
