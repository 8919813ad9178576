"""K3's persistent conv2 planner and the kernel's order of operations, on
the CPU.

The planner (`_plan`, `_work_items`) is pure Python: every (image, tile)
item must be covered exactly once, tile origins and sizes are even so that
no 2x2 pool window straddles two tiles, and a block's shared memory fits
the H100's 227 KB at each C the kernel takes. `_stage0_pool_first` pools
the f32 conv2 output before the normalization, as the kernel does; it must
be bitwise equal to `stage0_fused_reference` and match the JAX Pallas
kernel in interpret mode at ``tests/test_torch_stage0.py``'s tolerance.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.ops.stage0_fused import pack_weights
from latice_tpu.ops.stage0_fused import stage0_fused as jax_stage0_fused
from latice_tpu_torch.ops import stage0_fused_reference

s0 = importlib.import_module("latice_tpu_torch.ops.stage0_fused")  # the module, not the op

SMS = 132  # an H100 SXM's SMs
H100_SMEM = 232_448  # bytes of shared memory one block may use (227 KB)


@pytest.mark.parametrize("c", [16, 32, 64])
def test_shared_memory_fits(c):
    assert s0._smem_bytes(c) <= H100_SMEM
    blocks, _, _ = s0._plan(256, 128, 128, c, SMS)
    per_sm = blocks // SMS
    assert per_sm >= 1 and per_sm * (s0._smem_bytes(c) + 1024) <= 228 * 1024


@pytest.mark.parametrize(
    "b, h, w, c",
    [(256, 128, 128, 32), (64, 128, 128, 16), (64, 128, 128, 64), (1, 128, 128, 32),
     (257, 128, 128, 32), (3, 40, 24, 32), (3, 64, 64, 32), (2, 2, 2, 16)],
)
def test_plan_covers_every_tile_once(b, h, w, c):
    blocks, tile_h, tile_w = s0._plan(b, h, w, c, SMS)
    ty, tx = s0._tile_grid(h, w)
    assert 1 <= blocks <= min(b * ty * tx, 2 * SMS)
    items = [it for block in s0._work_items(b, h, w, blocks) for it in block]
    want = {(i, y * tile_h, x * tile_w) for i in range(b) for y in range(ty) for x in range(tx)}
    assert len(items) == len(want) and set(items) == want
    # Pixels: each of the image's pixels in exactly one tile.
    cover = np.zeros((b, ty * tile_h, tx * tile_w), np.int32)
    for i, y0, x0 in items:
        cover[i, y0 : y0 + tile_h, x0 : x0 + tile_w] += 1
    assert np.all(cover[:, :h, :w] == 1)


@pytest.mark.parametrize("h, w", [(128, 128), (40, 24), (64, 64), (18, 34)])
def test_tiles_keep_pool_windows_whole(h, w):
    _, tile_h, tile_w = s0._plan(4, h, w, 32, SMS)
    assert tile_h % 2 == 0 and tile_w % 2 == 0
    for _, y0, x0 in (it for blk in s0._work_items(4, h, w, 5) for it in blk):
        assert y0 % 2 == 0 and x0 % 2 == 0


def test_work_items_in_kernel_order():
    """Block k walks items k, k + blocks, ...: image-major, tiles row-major."""
    blocks = 5
    work = s0._work_items(2, 40, 64, blocks)  # 3 x 2 tiles an image, 12 items
    assert work[0] == [(0, 0, 0), (0, 32, 32), (1, 32, 0)]
    assert work[4] == [(0, 32, 0), (1, 16, 32)]
    assert sum(len(w) for w in work) == 12


def test_canonical_w2_layout():
    g = torch.Generator().manual_seed(0)
    w2 = torch.randn((32, 32, 3, 3), generator=g)
    t = s0._canonical_w2(w2)
    assert t.dtype == torch.bfloat16 and t.shape == (9, 4, 4, 8, 8) and t.is_contiguous()
    for tap, ci, co in [(0, 0, 0), (5, 17, 30), (8, 31, 9)]:
        want = w2[co, ci, tap // 3, tap % 3].to(torch.bfloat16)
        assert t[tap, ci // 8, co // 8, co % 8, ci % 8] == want


def _inputs(seed, b, c, h, w):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, 1, h, w)).astype(np.float32) / 255.0
    w1 = rng.uniform(-1 / 3, 1 / 3, (c, 1, 3, 3)).astype(np.float32)
    b1 = rng.uniform(-1 / 3, 1 / 3, (c,)).astype(np.float32)
    bound = (9 * c) ** -0.5
    w2 = rng.uniform(-bound, bound, (c, c, 3, 3)).astype(np.float32)
    b2 = rng.uniform(-bound, bound, (c,)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("b, c, h, w", [(2, 16, 32, 32), (3, 32, 40, 24), (1, 64, 16, 16)])
def test_pool_first_is_bitwise_the_reference(b, c, h, w):
    args = [torch.from_numpy(a) for a in _inputs(b + c, b, c, h, w)]
    got = s0._stage0_pool_first(*args)
    want = stage0_fused_reference(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (b, c, h // 2, w // 2)
    assert torch.equal(got, want)


def test_pool_first_matches_jax_pallas_kernel():
    x, w1, b1, w2, b2 = _inputs(7, 4, 8, 32, 32)
    hwio = [np.transpose(w1, (2, 3, 1, 0)), b1, np.transpose(w2, (2, 3, 1, 0)), b2]
    packed = [jnp.asarray(a) for a in pack_weights(*hwio, pack=4)]
    want = np.asarray(jax_stage0_fused(jnp.asarray(np.transpose(x, (0, 2, 3, 1))), *packed,
                                       interpret=True, pack=4), np.float32)
    got = s0._stage0_pool_first(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    got = np.transpose(got.float().numpy(), (0, 2, 3, 1))
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
    assert np.all(np.abs(got - want) <= 1e-2 + 2.0**-7 * np.abs(want))
