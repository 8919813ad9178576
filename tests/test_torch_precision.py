"""The precision the port computes in: the serve CLI's bf16 model, and the
f32 model's convolutions without TF32.

``cli.serve`` builds its model through ``cli._common._load_model`` at
``16-mixed``, as the JAX serve CLI builds its own at ``dtype=bfloat16``
(``latice_tpu/cli/_common.py:_load_model``); its ``/encode`` latents are
held to the JAX CLI's service at the index CLI's bf16 tolerance, 3e-2 of
each row's norm, on the same weights and dictionary.

An f32 model turns ``torch.backends.cudnn.allow_tf32`` off around its
forward and the f32 train step around its ``backward()``; every other cuDNN
setting stays as it was, and a ``16-mixed`` model leaves the flags alone.
The flags are process-wide, so the tests record them from inside each
convolution's forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.cli._common import _load_model as jax_load_model
from latice_tpu.index import LatentVectorDatabaseConfig as JaxDbConfig
from latice_tpu.index import TpuLatentVectorDatabase
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.serve import IndexService as JaxIndexService
from latice_tpu.train.checkpoint import save_params
from latice_tpu_torch.cli import serve as serve_cli
from latice_tpu_torch.device import no_tf32
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.train import VAELoss, make_optimizer, make_train_step

cudnn = torch.backends.cudnn
SMALL = ["--inplanes", "2", "--latent-dim", "8", "--batch-size", "16", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_cli")
    params = JaxVAE(inplanes=2, latent_dim=8).init(
        {"params": jax.random.key(5)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(6)
    )["params"]
    save_params(tmp / "ckpt", params)
    torch.save(flax_params_to_state_dict(jax.tree.map(np.asarray, params), 2, 8), tmp / "vae.pt")
    rng = np.random.default_rng(0)
    jdb = TpuLatentVectorDatabase(JaxDbConfig(npz_path=str(tmp / "db.npz"), dimension=8))
    jdb.add_vectors(rng.normal(size=(12, 8)).astype(np.float32),
                    rng.uniform([0, 20, 0], [340, 140, 340], size=(12, 3)))
    jdb.save()
    return tmp


@pytest.mark.parametrize("checkpoint", [True, False], ids=["checkpoint", "random"])
def test_serve_cli_model_is_16_mixed(files, checkpoint):
    argv = ["--db", str(files / "db.npz")] + SMALL
    if checkpoint:
        argv += ["--checkpoint", str(files / "vae.pt")]
    service = serve_cli.build_service(serve_cli.parse_args(argv))
    model = service.pipeline.model
    assert model.compute_dtype == torch.bfloat16
    assert not model.training
    assert service.pipeline.device.type == "cpu"
    assert service.health()["count"] == 12


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_serve_cli_encode_matches_jax_cli_service(files, dtype):
    argv = ["--db", str(files / "db.npz"), "--checkpoint", str(files / "vae.pt")] + SMALL
    service = serve_cli.build_service(serve_cli.parse_args(argv))
    jm, params = jax_load_model(str(files / "ckpt"), 2, 8)
    jdb = TpuLatentVectorDatabase(JaxDbConfig(npz_path=str(files / "db.npz"), dimension=8))
    jax_service = JaxIndexService(jm, params, jdb, top_n=5, batch_size=16)
    q = np.random.default_rng(1).uniform(size=(6, 128, 128)).astype(np.float32)
    if dtype == "uint8":
        q = (q * 255).astype(np.uint8)
    got = np.asarray(service.encode(q)["latents"], np.float32)
    want = np.asarray(jax_service.encode(q)["latents"], np.float32)
    assert got.shape == want.shape == (6, 8)
    scale = np.linalg.norm(want, axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 3e-2 * scale)


def _flags() -> tuple[bool, bool, bool, bool]:
    return (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark, cudnn.deterministic)


def _record_conv_flags(model: torch.nn.Module) -> dict[str, list]:
    """Hooks on every convolution that record the cuDNN flags as each one
    runs forward and backward."""
    seen: dict[str, list] = {"forward": [], "backward": []}
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_pre_hook(lambda *_: seen["forward"].append(_flags()))
            m.register_full_backward_pre_hook(lambda *_: seen["backward"].append(_flags()))
    return seen


def _tiny_model(precision: str) -> VariationalAutoEncoderRawData:
    model = VariationalAutoEncoderRawData(2, 4, n_stages=3)
    return model.init_weights(torch.Generator().manual_seed(0)).set_precision(precision)


def _train_step(model):
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(2, 1, 32, 32)).astype(np.float32))
    eps = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 4)).astype(np.float32))
    step = make_train_step(VAELoss(kl_lambda=5e-6))
    return step(model, make_optimizer(model.parameters()), x, None, 0, eps)


@pytest.fixture
def tf32_default():
    """cuDNN flags at PyTorch's defaults, restored afterwards."""
    saved = _flags()
    cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark, cudnn.deterministic = True, True, False, False
    yield
    cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark, cudnn.deterministic = saved


def test_f32_forward_runs_convs_without_tf32(tf32_default):
    model = _tiny_model("32").eval()
    seen = _record_conv_flags(model)
    x = torch.rand((2, 1, 32, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x, eps=torch.zeros((2, 4)))
    assert len(seen["forward"]) == 12  # 6 encoder convs, 6 decoder convs
    assert all(f == (False, True, False, False) for f in seen["forward"])
    assert _flags() == (True, True, False, False)


def test_f32_train_step_backward_runs_convs_without_tf32(tf32_default):
    model = _tiny_model("32")
    seen = _record_conv_flags(model)
    metrics = _train_step(model)
    assert np.isfinite(float(metrics["loss"]))
    assert len(seen["forward"]) == 12 and len(seen["backward"]) == 12
    assert all(f == (False, True, False, False) for f in seen["forward"] + seen["backward"])
    assert _flags() == (True, True, False, False)


def test_16_mixed_leaves_cudnn_flags_alone(tf32_default):
    model = _tiny_model("16-mixed")
    seen = _record_conv_flags(model)
    _train_step(model)
    assert len(seen["backward"]) == 12
    assert all(f == (True, True, False, False) for f in seen["forward"] + seen["backward"])
    assert _flags() == (True, True, False, False)


def test_no_tf32_keeps_other_settings_and_restores_on_error(tf32_default):
    cudnn.benchmark, cudnn.deterministic = True, True
    with pytest.raises(KeyError):
        with no_tf32():
            assert _flags() == (False, True, True, True)
            raise KeyError("inside")
    assert _flags() == (True, True, True, True)
