"""The fused InstanceNorm+LeakyReLU backward (K2b's plain twin, inside the
autograd Function) against the JAX package's two VJPs.

The JAX side is the Pallas kernel's custom VJP in interpret mode, as
tests/ops/test_fused_norm.py runs it, and the analytic XLA VJP of
latice_tpu/ops/norm_vjp.py. NHWC there, NCHW here. Gradients within 1e-4
at f32 (different reduction orders) and 1e-2 at bf16 (bf16 outputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.ops import instance_norm_leaky_relu as jax_kernel
from latice_tpu.ops.norm_vjp import instance_norm_leaky_relu_xla
from latice_tpu_torch.models import InstanceNormLeakyReLU
from latice_tpu_torch.ops import (
    InstanceNormLeakyReLUFunction,
    instance_norm_leaky_relu,
    instance_norm_leaky_relu_backward,
    instance_norm_leaky_relu_backward_plain,
    instance_norm_leaky_relu_plain,
)

jax_fused = functools.partial(jax_kernel, interpret=True)
SHAPES = [(2, 16, 16, 8), (1, 8, 8, 32), (3, 4, 4, 16)]


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _inputs(shape, seed, negative=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 3 + 1
    if negative:
        x = -np.abs(x) - 1
    g = rng.normal(size=shape)
    return x.astype(np.float32), g.astype(np.float32)


def _jax_vjp(fn, x, g, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda t: fn(t, 1e-5, 0.02), jnp.asarray(x, dtype))
    return np.asarray(vjp(jnp.asarray(g, dtype))[0], np.float32)


def _port_grad(x, g, dtype=torch.float32):
    xt = _nchw(x).to(dtype).requires_grad_()
    y = InstanceNormLeakyReLUFunction.apply(xt, 1e-5, 0.02)
    y.backward(_nchw(g).to(dtype))
    return y, xt.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_fn", ["pallas_interpret", "norm_vjp"])
def test_f32_gradient_matches_jax(shape, jax_fn):
    fn = jax_fused if jax_fn == "pallas_interpret" else instance_norm_leaky_relu_xla
    x, g = _inputs(shape, seed=len(shape) + shape[-1])
    want = _jax_vjp(fn, x, g)
    _, got = _port_grad(x, g)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-4)


def test_gradient_through_negative_region():
    """Every y < 0: the slope must scale the whole gradient."""
    x, g = _inputs((1, 8, 8, 8), seed=5, negative=True)
    x[..., 0, 0, :] = 10.0  # one positive element per plane keeps var > 0 and y mixed
    want = _jax_vjp(jax_fused, x, g)
    _, got = _port_grad(x, g)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-4)


@pytest.mark.parametrize("jax_fn", ["pallas_interpret", "norm_vjp"])
def test_bf16_gradient_matches_jax(jax_fn):
    fn = jax_fused if jax_fn == "pallas_interpret" else instance_norm_leaky_relu_xla
    x, g = _inputs((2, 8, 8, 8), seed=7)
    want = _jax_vjp(fn, x, g, jnp.bfloat16)
    y, got = _port_grad(x, g, torch.bfloat16)
    assert y.dtype == got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-2)


def test_grad_fn_is_the_function():
    # A seeded generator: a bare draw would move torch's global RNG, which
    # tests in other files read unseeded.
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0), requires_grad=True)
    y = InstanceNormLeakyReLU()(x)
    assert type(y.grad_fn).__name__ == "InstanceNormLeakyReLUFunctionBackward"
    with torch.no_grad():
        assert InstanceNormLeakyReLU()(x).grad_fn is None


def test_forward_matches_plain_and_counts_nothing_on_cpu():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 4, 6, 6)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 4, 6, 6)).astype(np.float32))
    y = InstanceNormLeakyReLUFunction.apply(x, 1e-5, 0.02)
    torch.testing.assert_close(y, instance_norm_leaky_relu_plain(x)[0], rtol=0, atol=0)
    _, mean, rstd = instance_norm_leaky_relu(x)
    torch.testing.assert_close(
        instance_norm_leaky_relu_backward(x, mean, rstd, g),
        instance_norm_leaky_relu_backward_plain(x, mean, rstd, g),
        rtol=0, atol=0,
    )
    assert instance_norm_leaky_relu.launches == 0
    assert instance_norm_leaky_relu_backward.launches == 0


def test_backward_matches_autograd_of_plain_forward():
    """The closed form equals torch's own autograd of the plain forward."""
    x, g = _inputs((2, 12, 12, 5), seed=9)
    xt = _nchw(x).requires_grad_()
    y, *_ = instance_norm_leaky_relu_plain(xt)
    (want,) = torch.autograd.grad(y, xt, _nchw(g))
    _, got = _port_grad(x, g)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_zero_planes_give_finite_zero_gradients():
    """An all-zero pad row: var 0, rstd 1/sqrt(eps), and with g = 0 a zero dx."""
    x = torch.zeros(2, 3, 8, 8, requires_grad=True)
    y = InstanceNormLeakyReLUFunction.apply(x, 1e-5, 0.02)
    y.backward(torch.zeros_like(y))
    assert torch.isfinite(y).all() and torch.equal(x.grad, torch.zeros_like(x))


def test_bf16_autocast_keeps_f32_statistics():
    """Under autocast a bf16 input gives a bf16 output whose statistics were
    taken in f32."""
    x, _ = _inputs((2, 8, 8, 4), seed=10)
    xb = _nchw(x).to(torch.bfloat16)
    y, mean, rstd = instance_norm_leaky_relu_plain(xb)
    assert y.dtype == torch.bfloat16 and mean.dtype == rstd.dtype == torch.float32
    y32, mean32, _ = instance_norm_leaky_relu_plain(xb.float())
    torch.testing.assert_close(mean, mean32, rtol=0, atol=0)
    torch.testing.assert_close(y.float(), y32, rtol=0, atol=1e-2)
