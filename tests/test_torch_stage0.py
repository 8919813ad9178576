"""K3, the fused encoder stage 0, and the pipeline's ``feature_fn`` hook.

The kernel's plain twin against the JAX Pallas kernel in interpret mode
(``stage0_fused`` with its 4-image lane packing and ``fused_stage0_apply``)
and against flax's ConvBlock×2 + max-pool, at the JAX test's own size (B=4,
32×32, C=8) and bound, atol = rtol = 3e-2 (tests/ops/test_stage0_fused.py:
bf16 staging bounds the agreement). The twin and the kernel round in the
same places as the Pallas kernel, so the measured distance to it is one
bf16 rounding at most. Weights are HWIO in JAX and OIHW in the port;
activations NHWC and NCHW.

``feature_fn``: the port's IndexPipeline against JAX's, both with a
zero-mean, L2-normalized pixel feature and no model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index import IndexPipeline as JaxPipeline
from latice_tpu.models import ConvBlock
from latice_tpu.ops.stage0_fused import fused_stage0_apply as jax_stage0_apply
from latice_tpu.ops.stage0_fused import pack_weights
from latice_tpu.ops.stage0_fused import stage0_fused as jax_stage0_fused
from latice_tpu_torch.index import IndexPipeline
from latice_tpu_torch.models import VariationalAutoEncoderRawData
from latice_tpu_torch.ops import (
    cosine_topk_fused,
    fused_stage0_apply,
    instance_norm_leaky_relu,
    stage0_fused,
    stage0_fused_reference,
)

C = 8
TOL = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def flax_stage0():
    """Two flax ConvBlocks + pool, the JAX encoder's stage 0, and its params."""
    import flax.linen as nn

    class Stage0(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = ConvBlock(C, name="stage0_block0")(x)
            x = ConvBlock(C, name="stage0_block1")(x)
            return nn.max_pool(x, (2, 2), strides=(2, 2))

    model = Stage0()
    params = model.init(jax.random.key(0), jnp.zeros((4, 32, 32, 1), jnp.float32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _oihw(params):
    """(w1, b1, w2, b2) torch tensors, OIHW, from the flax stage-0 params."""
    w1 = params["stage0_block0"]["conv"]["kernel"]
    w2 = params["stage0_block1"]["conv"]["kernel"]
    return (
        torch.from_numpy(np.transpose(w1, (3, 2, 0, 1)).copy()),
        torch.from_numpy(np.array(params["stage0_block0"]["conv"]["bias"])),
        torch.from_numpy(np.transpose(w2, (3, 2, 0, 1)).copy()),
        torch.from_numpy(np.array(params["stage0_block1"]["conv"]["bias"])),
    )


def _port_stage0(params, x_nhwc: np.ndarray) -> np.ndarray:
    """The port's stage 0 of NHWC images, back in NHWC float32."""
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2))))
    out = stage0_fused(x, *_oihw(params))
    assert out.dtype == torch.bfloat16
    return np.transpose(out.float().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("batch", [4, 8])
def test_twin_matches_jax_pallas_kernel(flax_stage0, batch):
    _, params = flax_stage0
    x = np.random.default_rng(batch).uniform(size=(batch, 32, 32, 1)).astype(np.float32)
    w1, b1 = params["stage0_block0"]["conv"]["kernel"], params["stage0_block0"]["conv"]["bias"]
    w2, b2 = params["stage0_block1"]["conv"]["kernel"], params["stage0_block1"]["conv"]["bias"]
    packed = [jnp.asarray(a) for a in pack_weights(w1, b1, w2, b2, pack=4)]
    want = np.asarray(
        jax_stage0_fused(jnp.asarray(x), *packed, interpret=True, pack=4), np.float32
    )
    got = _port_stage0(params, x)
    assert got.shape == want.shape == (batch, 16, 16, C)
    np.testing.assert_allclose(got, want, **TOL)
    # Tighter: rounding where the Pallas kernel rounds leaves at most one
    # bf16 step of the value between them (K2's bf16 rule).
    diff = np.abs(got - want)
    assert np.all(diff <= 1e-2 + 2.0**-7 * np.abs(want))
    print(f"K3 twin vs Pallas (interpret), B={batch}: max abs err {diff.max()}, "
          f"{np.mean(diff > 0):.2%} of elements differ")


def test_apply_matches_jax_fused_stage0_apply(flax_stage0):
    _, params = flax_stage0
    x = np.random.default_rng(1).uniform(size=(4, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax_stage0_apply(params, jnp.asarray(x), interpret=True), np.float32)
    encoder = VariationalAutoEncoderRawData(inplanes=C, latent_dim=4, n_stages=3).encoder
    w1, b1, w2, b2 = _oihw(params)
    with torch.no_grad():
        for block, (w, b) in ((encoder[0][0], (w1, b1)), (encoder[1][0], (w2, b2))):
            block.weight.copy_(w)
            block.bias.copy_(b)
        x_t = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
        got = fused_stage0_apply(encoder, x_t).float().numpy()
    np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 1)), want, **TOL)

    # The port's own encoder[0:3] (f32 throughout) is the same function up
    # to the bf16 staging.
    with torch.no_grad():
        f32 = encoder[0:3](x_t).numpy()
    np.testing.assert_allclose(got, f32, **TOL)


def test_twin_matches_flax_blocks(flax_stage0):
    model, params = flax_stage0
    x = np.random.default_rng(2).uniform(size=(4, 32, 32, 1)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_port_stage0(params, x), want, **TOL)


def test_images_independent_and_odd_batch(flax_stage0):
    """No lane packing: any batch size, and images never mix."""
    _, params = flax_stage0
    x = np.random.default_rng(3).uniform(size=(3, 32, 32, 1)).astype(np.float32)
    base = _port_stage0(params, x)
    x2 = x.copy()
    x2[1] = np.random.default_rng(4).uniform(size=(32, 32, 1))
    out2 = _port_stage0(params, x2)
    np.testing.assert_array_equal(base[[0, 2]], out2[[0, 2]])
    assert not np.array_equal(base[1], out2[1])


def test_wrapper_on_cpu_is_the_twin_and_never_counts():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 1, 16, 16), generator=g)
    args = (
        torch.randn((16, 1, 3, 3), generator=g), torch.randn((16,), generator=g),
        torch.randn((16, 16, 3, 3), generator=g) / 12, torch.randn((16,), generator=g),
    )
    before = stage0_fused.launches
    torch.testing.assert_close(stage0_fused(x, *args), stage0_fused_reference(x, *args),
                               rtol=0, atol=0)
    assert stage0_fused.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        stage0_fused(x.to("meta"), *(a.to("meta") for a in args))
    assert stage0_fused.launches == before


# -- feature_fn ---------------------------------------------------------


def _dictionary(rng, n=40, hw=8):
    """Patterns small enough that their pixels are the features (D = 64)."""
    pats = rng.uniform(size=(n, hw, hw)).astype(np.float32)
    orients = rng.uniform([0, 20, 0], [340, 140, 340], size=(n, 3))
    return pats, orients


def _np_feature(p):
    f = p.reshape(len(p), -1)
    f = f - f.mean(axis=1, keepdims=True)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _jax_feature(p):  # (B, H, W, 1)
    f = p.reshape(p.shape[0], -1)
    f = f - f.mean(axis=1, keepdims=True)
    return f / jnp.linalg.norm(f, axis=1, keepdims=True)


def _torch_feature(p):  # (B, H, W)
    f = p.reshape(p.shape[0], -1)
    f = f - f.mean(dim=1, keepdim=True)
    return f / torch.linalg.vector_norm(f, dim=1, keepdim=True)


@pytest.mark.parametrize("engine", ["exact", "fused"])
def test_feature_fn_matches_jax(engine):
    rng = np.random.default_rng(5)
    pats, orients = _dictionary(rng)
    vecs = _np_feature(pats)
    queries = np.clip(pats[rng.integers(0, 40, 13)] + rng.normal(scale=0.02, size=(13, 8, 8)),
                      0, 1).astype(np.float32)
    common = dict(top_n=5, min_required_matches=1, batch_size=8)
    jax_pipe = JaxPipeline(None, None, vecs, orients, feature_fn=_jax_feature, **common)
    port = IndexPipeline(None, vecs, orients, feature_fn=_torch_feature, engine=engine,
                         device="cpu", **common)
    for q in (queries, np.round(queries * 255).astype(np.uint8)):
        want, got = jax_pipe(q), port(q)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.success, want.success)
        np.testing.assert_array_equal(got.n_similar, want.n_similar)
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
        np.testing.assert_allclose(got.best_orientation, want.best_orientation, atol=1e-3)
    np.testing.assert_allclose(port.encode(queries), _np_feature(queries), atol=1e-6)


def test_feature_fn_excludes_model():
    vecs, orients = np.eye(4, dtype=np.float32), np.zeros((4, 3))
    model = VariationalAutoEncoderRawData(inplanes=2, latent_dim=4, n_stages=3)
    with pytest.raises(ValueError, match="pass a model or a feature_fn"):
        IndexPipeline(None, vecs, orients, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        IndexPipeline(model, vecs, orients, feature_fn=_torch_feature, device="cpu")


def test_k3_composition_through_feature_fn():
    """The chip check's K3 path on the CPU: stage 0 through the twin, the
    rest of the encoder and the mu head under bf16 autocast, as a
    feature_fn, against the model's own 16-mixed encode. On the CPU no
    kernel is launched."""
    model = VariationalAutoEncoderRawData(inplanes=16, latent_dim=8, n_stages=3,
                                          bottleneck_hw=2)
    model.init_weights(torch.Generator().manual_seed(1)).set_precision("16-mixed").eval()

    def feature_fn(p):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            h = model.encoder[3:](fused_stage0_apply(model.encoder, p[:, None]))
            return model.mu(h.flatten(1)).float()

    rng = np.random.default_rng(6)
    pats = rng.integers(0, 256, (6, 16, 16), dtype=np.uint8)
    vecs = rng.normal(size=(30, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    pipe = IndexPipeline(None, vecs, rng.uniform(0, 90, (30, 3)), feature_fn=feature_fn,
                         engine="fused", batch_size=4, device="cpu")
    counters = (stage0_fused, instance_norm_leaky_relu, cosine_topk_fused)
    before = [f.launches for f in counters]
    got = pipe.encode(pats)
    result = pipe(pats)
    assert [f.launches for f in counters] == before
    assert result.indices.shape == (6, 20)
    with torch.no_grad():
        want = model.encode(torch.from_numpy(pats[:, None].astype(np.float32) / 255))[0].numpy()
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert rel.max() < 5e-2
