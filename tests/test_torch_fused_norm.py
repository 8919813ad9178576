"""Plain InstanceNorm+LeakyReLU (the K2 twin) against the JAX Pallas kernel.

The JAX side runs in Pallas interpret mode, as tests/ops/test_fused_norm.py
does; NHWC there, NCHW here. Values, means and rstds within 1e-5 (f32
reductions in different orders).
"""

import numpy as np
import pytest
import torch

from latice_tpu.ops.fused_norm import _fwd as jax_fused_fwd
from latice_tpu_torch.ops import instance_norm_leaky_relu, instance_norm_leaky_relu_plain

SHAPES = [(2, 16, 16, 8), (1, 8, 8, 32), (3, 4, 4, 128)]


def _jax_fused(x_nhwc):
    out, (_, mean, rstd) = jax_fused_fwd(x_nhwc, 1e-5, 0.02, True)
    return np.asarray(out), np.asarray(mean)[:, 0, :], np.asarray(rstd)[:, 0, :]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    want_y, want_mean, want_rstd = _jax_fused(x)
    y, mean, rstd = instance_norm_leaky_relu_plain(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    np.testing.assert_allclose(np.moveaxis(y.numpy(), 1, -1), want_y, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), want_mean, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), want_rstd, atol=1e-5)


def test_negative_region_uses_slope():
    rng = np.random.default_rng(1)
    x = (-np.abs(rng.normal(size=(1, 8, 8, 8))) - 1).astype(np.float32)
    want_y, *_ = _jax_fused(x)
    y, *_ = instance_norm_leaky_relu_plain(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    np.testing.assert_allclose(np.moveaxis(y.numpy(), 1, -1), want_y, atol=1e-5)


def test_cpu_tensor_takes_plain_path_and_counts_nothing():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 4, 6, 6)).astype(np.float32))
    before = instance_norm_leaky_relu.launches
    got = instance_norm_leaky_relu(x)
    want = instance_norm_leaky_relu_plain(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert instance_norm_leaky_relu.launches == before == 0


def test_plain_matches_torch_instance_norm():
    """The one-pass statistics agree with torch's own InstanceNorm2d."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 5, 12, 12)).astype(np.float32))
    y, *_ = instance_norm_leaky_relu_plain(x)
    ref = torch.nn.functional.leaky_relu(torch.nn.functional.instance_norm(x), 0.02)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
