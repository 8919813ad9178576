"""K1's launch planner, and the plain twin against the JAX kernel where the
CUDA kernel's splits meet.

`_plan` and `_split_bounds` are pure: the planner decides how many queries
each warp scores and how many splits the dictionary is cut into, and the
kernel cuts the splits at `_split_bounds`. The twin cases put tied
duplicates on both sides of each split boundary, and every query's top-k
inside one split, and hold the twin to ``cosine_topk_fused(...,
interpret=True)``: indices equal (ties to the lowest index), scores within
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index.knn import l2_normalize as jax_l2_normalize
from latice_tpu.ops.topk_fused import cosine_topk_fused as jax_fused
from latice_tpu_torch.ops import cosine_topk_fused
from latice_tpu_torch.ops import topk_fused as k1

H100_SMS = 132


@pytest.mark.parametrize("n", [3001, 100_000, 1_000_000])
@pytest.mark.parametrize("b", [1, 13, 64, 256, 257, 1024])
def test_plan_keeps_splits_full_and_covers_the_batch(b, n):
    for k in (1, 20, 64):
        qw, splits = k1._plan(b, n, k, 16, H100_SMS)
        assert qw in k1._QUERIES_PER_WARP
        assert splits >= 1
        bounds = k1._split_bounds(n, splits)
        assert bounds[0] == 0 and bounds[-1] == n and len(bounds) == splits + 1
        sizes = np.diff(bounds)
        assert splits == 1 or sizes.min() >= max(k1._MIN_SPLIT_ROWS, k)
        assert sizes.max() - sizes.min() <= 1
        blocks = -(-b // (qw * k1._WARPS_PER_BLOCK))
        assert blocks * qw * k1._WARPS_PER_BLOCK >= b
        # About two blocks per SM, unless the split size stops it first.
        assert blocks * splits <= k1._BLOCKS_PER_SM * H100_SMS + blocks
        assert blocks * splits >= min(k1._BLOCKS_PER_SM * H100_SMS, blocks * (n // max(1024, k)))


@pytest.mark.parametrize("b,qw", [(1, 1), (13, 1), (31, 1), (32, 4), (64, 4), (257, 4)])
def test_plan_queries_per_warp_fill_a_block(b, qw):
    assert k1._plan(b, 100_000, 20, 16, H100_SMS)[0] == qw


def test_plan_ignores_the_width():
    assert {k1._plan(256, 100_000, 20, d, H100_SMS) for d in (1, 16, 33, 64)} == {(4, 33)}


def _unit(rng, n, d=16):
    return np.array(jax_l2_normalize(rng.normal(size=(n, d)).astype(np.float32)))


def _against_jax(q, dic, k):
    want = jax_fused(jnp.asarray(q), jnp.asarray(dic), k=k, tile_b=8, tile_n=1024,
                     interpret=True)
    s, i = cosine_topk_fused(torch.from_numpy(q), torch.from_numpy(dic), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(s.numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    return i.numpy()


def test_duplicates_across_split_boundaries_tie_in_index_order():
    rng = np.random.default_rng(21)
    n, b = 5000, 8
    _, splits = k1._plan(b, n, 10, 16, H100_SMS)
    inner = np.array(k1._split_bounds(n, splits)[1:-1])
    assert len(inner) >= 2
    dic = _unit(rng, n)
    dic[inner] = dic[inner - 1]  # row s-1 copied onto row s at each boundary
    rows = inner[np.arange(b) % len(inner)]
    got = _against_jax(dic[rows].copy(), dic, 10)
    np.testing.assert_array_equal(got[:, :2], np.stack([rows - 1, rows], axis=1))


def test_every_top_k_inside_one_split():
    rng = np.random.default_rng(22)
    n, b, k = 5000, 16, 10
    _, splits = k1._plan(b, n, k, 16, H100_SMS)
    bounds = k1._split_bounds(n, splits)
    lo, hi = bounds[splits // 2], bounds[splits // 2 + 1]
    centers = _unit(rng, 4)
    q = np.repeat(centers, 4, axis=0) + 0.01 * rng.normal(size=(b, 16)).astype(np.float32)
    near = np.repeat(centers, k, axis=0) + 0.01 * rng.normal(size=(4 * k, 16)).astype(np.float32)
    dic = _unit(rng, n)
    dic[lo : lo + 4 * k] = np.asarray(jax_l2_normalize(near))
    got = _against_jax(q.astype(np.float32), dic, k)
    assert np.all((got >= lo) & (got < hi))
