"""Plain fused top-k (the K1 twin) and the exact engine against JAX.

The JAX side is ``cosine_topk_fused(..., interpret=True)`` on every case of
tests/ops/test_topk_fused.py, and ``knn.cosine_topk`` for the exact engine.
Indices equal (ties to the lowest index); scores within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index.knn import cosine_topk as jax_cosine_topk
from latice_tpu.index.knn import l2_normalize as jax_l2_normalize
from latice_tpu.ops.topk_fused import cosine_topk_fused as jax_fused
from latice_tpu_torch.index.knn import cosine_topk, l2_normalize
from latice_tpu_torch.ops import cosine_topk_fused, cosine_topk_fused_plain


def _case(rng, b, n, d=16):
    q = rng.normal(size=(b, d)).astype(np.float32)
    dic = np.array(jax_l2_normalize(rng.normal(size=(n, d)).astype(np.float32)))
    return q, dic


def _port(q, dic, k, **kw):
    s, i = cosine_topk_fused(torch.tensor(q), torch.tensor(dic), k, **kw)
    assert s.dtype == torch.float32 and i.dtype == torch.int64
    return s.numpy(), i.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "b,n,tile_b,tile_n,d",
    [
        (8, 256, 8, 128, 16),
        (12, 300, 8, 128, 16),
        (16, 100, 8, 256, 16),
        (8, 129, 8, 128, 16),
        (8, 256, 8, 128, 64),
    ],
)
def test_matches_jax_fused(b, n, tile_b, tile_n, d):
    q, dic = _case(np.random.default_rng(b * 1000 + n + d), b, n, d)
    want = jax_fused(jnp.asarray(q), jnp.asarray(dic), k=10, tile_b=tile_b, tile_n=tile_n,
                     interpret=True)
    _assert_same(_port(q, dic, 10), want)


def test_tie_breaking_lowest_index_first():
    rng = np.random.default_rng(7)
    base = np.asarray(jax_l2_normalize(rng.normal(size=(7, 16)).astype(np.float32)))
    dic = np.concatenate([base, base, base], axis=0)
    q = base[:3] + 0.0
    want = jax_fused(jnp.asarray(q), jnp.asarray(dic), k=6, tile_b=8, tile_n=128, interpret=True)
    got = _port(q, dic, 6)
    _assert_same(got, want)
    # Each row's three copies come out in ascending index order.
    assert np.all(np.diff(got[1][:, :3], axis=1) > 0)


def test_negative_similarities_beat_padding():
    rng = np.random.default_rng(8)
    q = np.ones((8, 16), np.float32)
    dic = np.asarray(jax_l2_normalize(-np.abs(rng.normal(size=(130, 16))) - 0.1)).astype(
        np.float32
    )
    want = jax_fused(jnp.asarray(q), jnp.asarray(dic), k=5, tile_b=8, tile_n=128, interpret=True)
    got = _port(q, dic, 5)
    assert np.all(got[0] < 0) and np.all(got[1] < 130)
    _assert_same(got, want)


def test_n_valid_masks_trailing_padding():
    rng = np.random.default_rng(9)
    q = np.ones((8, 16), np.float32)
    real = np.asarray(jax_l2_normalize(-np.abs(rng.normal(size=(90, 16))) - 0.1)).astype(
        np.float32
    )
    dic = np.concatenate([real, np.zeros((38, 16), np.float32)])
    want = jax_fused(jnp.asarray(q), jnp.asarray(dic), k=5, tile_b=8, tile_n=128,
                     interpret=True, n_valid=90)
    got = _port(q, dic, 5, n_valid=90)
    _assert_same(got, want)
    assert np.all(got[1] < 90)


def test_k_larger_than_dictionary_raises():
    q, dic = _case(np.random.default_rng(10), 4, 8)
    with pytest.raises(ValueError, match="exceeds dictionary"):
        _port(q, dic, 16)
    with pytest.raises(ValueError, match="exceeds dictionary"):
        jax_fused(jnp.asarray(q), jnp.asarray(dic), k=16, interpret=True)


def test_oversized_k_raises_with_guidance():
    q, dic = _case(np.random.default_rng(11), 4, 200)
    with pytest.raises(ValueError, match="k <= ~32"):
        _port(q, dic, 100)
    with pytest.raises(ValueError, match="k <= ~32"):
        jax_fused(jnp.asarray(q), jnp.asarray(dic), k=100, interpret=True)


@pytest.mark.parametrize("k", [1, 64])
def test_k_extremes(k):
    q, dic = _case(np.random.default_rng(12 + k), 9, 300)
    want = jax_fused(jnp.asarray(q), jnp.asarray(dic), k=k, tile_b=8, tile_n=128, interpret=True)
    _assert_same(_port(q, dic, k), want)


def test_zero_query_stays_finite():
    q, dic = _case(np.random.default_rng(13), 3, 50)
    q[1] = 0.0
    s, i = _port(q, dic, 4)
    assert np.all(s[1] == 0.0) and np.array_equal(i[1], np.arange(4))


def test_cpu_path_counts_no_launch():
    q, dic = _case(np.random.default_rng(14), 4, 64)
    a = cosine_topk_fused(torch.from_numpy(q), torch.from_numpy(dic), 5)
    b = cosine_topk_fused_plain(torch.from_numpy(q), torch.from_numpy(dic), 5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cosine_topk_fused.launches == 0


@pytest.mark.parametrize("b,n,k", [(8, 256, 10), (33, 1000, 20), (5, 64, 64)])
def test_exact_engine_matches_jax(b, n, k):
    q, dic = _case(np.random.default_rng(b + n + k), b, n)
    want = jax_cosine_topk(jnp.asarray(q), jnp.asarray(dic), k)
    s, i = cosine_topk(torch.from_numpy(q), torch.from_numpy(dic), k)
    _assert_same((s.numpy(), i.numpy()), want)


def test_l2_normalize_zero_guard():
    v = np.array([[3.0, 4.0], [0.0, 0.0]], np.float32)
    np.testing.assert_allclose(
        l2_normalize(torch.from_numpy(v)).numpy(), np.asarray(jax_l2_normalize(v)), atol=1e-7
    )
