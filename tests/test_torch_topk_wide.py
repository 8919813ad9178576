"""K5 (``ops.cosine_topk_wide``): the cosine top-k over a wide bf16 table.

On the CPU: the wrapper runs the plain twin, which is the exact engine's
``topk_lower_index_first(cosine_scores(...))``; the kernel's algorithm
(tiles, splits, each split's running top-k of packed keys and the merge),
written out in torch at small tiles, returns what the twin returns, exact
ties and k larger than a tile included; `IndexPipeline` routes the exact
engine over a bf16 table, and only that, through the wrapper, at any k.

On the card (``-m card``): the kernel against the twin at the DI cell's
table (N = 333,227) for B in {1, 256} and D in {4,096, 16,384}, and at
small odd shapes, k past the shared-memory lists and past a tile
included; one launch a batch on the DI path, counted by the profiler.
The tolerance is ``max(1e-6, 1e-8 * D)``: the tensor cores keep f32 sums
but drop the bits of each step's addends below the running sum's last
place, so over D / 16 steps a score near 1 drifts from cuBLAS's f32 sum by
up to about D / 16 times half its last place (6.6e-5 seen at D = 16,384,
1.0e-5 at 4,096). Every returned row must carry its own score within it,
no row may repeat, no row the twin scores more than it above the k-th
may be missing, and a row may stand elsewhere than the twin's only where
the twin's score there ties a neighbour's within it.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from latice_tpu_torch.index import IndexPipeline, PatternDictionaryIndexer
from latice_tpu_torch.index.knn import cosine_scores, l2_normalize, topk_lower_index_first
from latice_tpu_torch.ops.topk_wide import (
    BN,
    MAX_K,
    MERGE_KEYS,
    cosine_topk_wide,
    cosine_topk_wide_plain,
    plan,
)
from latice_tpu_torch.utils.profiling import recorded

TIE = 1e-5


def _tol(d: int) -> float:
    return max(1e-6, 1e-8 * d)


def _unit_bf16(gen: torch.Generator, n: int, d: int, device="cpu") -> torch.Tensor:
    x = torch.randn(n, d, generator=gen, device=device)
    return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).bfloat16()


def _key(s: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The kernel's key: the f32 score's order above the reversed row."""
    bits = s.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return ordered * (1 << 32) + ((1 << 32) - 1 - cols.to(torch.int64))


def _emulate(q: torch.Tensor, t: torch.Tensor, k: int, bn: int, sms: int):
    """K5's algorithm in torch: splits of ``bn``-row tiles sized as `plan`
    sizes them, each tile's scores entering each query's list of its
    split's best k keys (the best remaining score over the lowest slot,
    while it beats the lowest key), then the merge's sort of the splits'
    keys."""
    b = q.shape[0]
    n = t.shape[0]
    n_tiles = math.ceil(n / bn)
    most = max(1, min(n_tiles, sms // plan(b, n, k, sms)["q_chunks"], MERGE_KEYS // k))
    per = math.ceil(n_tiles / most)
    splits = math.ceil(n_tiles / per)
    lowest = torch.iinfo(torch.int64).min
    part = torch.full((b, splits, k), lowest, dtype=torch.int64)
    for split in range(splits):
        best = torch.full((b, k), lowest, dtype=torch.int64)
        for tile in range(split * per, min((split + 1) * per, n_tiles)):
            cols = torch.arange(tile * bn, min((tile + 1) * bn, n))
            s = q.float() @ t[cols].float().T
            while True:
                top_s = s.max(1).values
                top_c = torch.where(s == top_s[:, None], cols[None, :], 2**31 - 1).min(1).values
                top = _key(top_s, top_c)
                kth, slot = best.min(1)
                need = (top_s > -math.inf) & (top > kth)
                if not need.any():
                    break
                rows = need.nonzero()[:, 0]
                best[rows, slot[rows]] = top[rows]
                s = torch.where(cols[None, :] == top_c[:, None], -math.inf, s)
        part[:, split] = best
    keys = part.reshape(b, -1).sort(1, descending=True).values[:, :k]
    hi = (keys >> 32).to(torch.int32)
    bits = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi)
    return bits.view(torch.float32), (1 << 32) - 1 - (keys & ((1 << 32) - 1))


def _assert_same(got, want, q, t, tol=TIE):
    """``got`` (B, k) against the twin's best ``k + 1`` or more (``want``)
    of queries ``q`` over table ``t``, by the rules of the module note."""
    gv, gi = (x.cpu() for x in got)
    wv, wi = (x.cpu() for x in want)
    k = gi.shape[1]
    assert gv.dtype == torch.float32 and gi.dtype == torch.int64 and wi.shape[1] > k
    assert (gv[:, :-1] >= gv[:, 1:]).all()
    ordered = gi.sort(1).values
    assert (ordered[:, 1:] != ordered[:, :-1]).all(), "a row repeats"
    own = torch.stack([(q[b].float() * t[gi[b].to(t.device)].float()).sum(1).cpu()
                       for b in range(len(gi))])
    assert (own - gv).abs().max() <= tol, "a row carries another score than its own"
    assert (gv - wv[:, :k]).abs().max() <= tol
    present = (wi[:, :k, None] == gi[:, None, :]).any(2)
    must = wv[:, :k] > gv[:, -1:] + tol
    assert (present | ~must).all(), f"{int((must & ~present).sum())} rows missing"
    near = torch.zeros_like(wv, dtype=torch.bool)
    close = (wv[:, 1:] - wv[:, :-1]).abs() <= tol
    near[:, 1:] |= close
    near[:, :-1] |= close
    moved = gi != wi[:, :k]
    assert not (moved & ~near[:, :k]).any(), f"{int((moved & ~near[:, :k]).sum())} rows moved"
    assert (~moved).all(1).float().mean() > 0.5


@pytest.fixture(scope="module", autouse=True)
def _restore_rng():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


@pytest.mark.parametrize("b,n,d,k,bn", [
    (5, 300, 64, 20, 16),  # k larger than a tile
    (70, 1000, 48, 64, 128),  # two query tiles, the largest k
    (3, 37, 16, 20, 8),  # splits that hold fewer rows than k
])
def test_the_kernels_algorithm_returns_the_twins_answer(b, n, d, k, bn):
    gen = torch.Generator().manual_seed(b * 1000 + n)
    t = _unit_bf16(gen, n, d)
    t[11] = t[10]  # exact ties: the lower row first
    t[n - 1] = t[3]
    q = _unit_bf16(gen, b, d)
    q[0] = t[10]
    want = cosine_topk_wide_plain(q, t, k)
    got = _emulate(q, t, k, bn, sms=8)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    assert torch.equal(got[1], want[1])
    assert want[1][0, 0] == 10 and want[1][0, 1] == 11


def test_cpu_call_is_the_exact_engine():
    gen = torch.Generator().manual_seed(3)
    t, q = _unit_bf16(gen, 500, 96), _unit_bf16(gen, 7, 96)
    t[200] = t[100]
    q[1] = t[100]
    before = cosine_topk_wide.launches
    got = cosine_topk_wide(q, t, 20)
    want = topk_lower_index_first(cosine_scores(q, t), 20)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][1, 0] == 100 and got[1][1, 1] == 200
    assert cosine_topk_wide.launches == before  # the twin is no launch


def test_refusals():
    t = torch.zeros(10, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must lie in"):
        cosine_topk_wide(t[:2], t, 11)
    with pytest.raises(ValueError, match="one CUDA device"):
        cosine_topk_wide(t[:2].to("meta"), t.to("meta"), 5)
    # The CPU route is the twin at any k; the card's limit is the kernel's.
    gen = torch.Generator().manual_seed(6)
    big, q = _unit_bf16(gen, 2_000, 16), _unit_bf16(gen, 2, 16)
    got = cosine_topk_wide(q, big, MAX_K + 1)
    want = topk_lower_index_first(cosine_scores(q, big), MAX_K + 1)
    assert torch.equal(got[1], want[1])


def test_plan_fills_one_wave_and_covers_the_table():
    for b, n, k in [(256, 333_227, 20), (1, 333_227, 20), (5, 50, 20), (1024, 100_000, 20),
                    (128, 333_227, 20), (129, 1_000, 64),
                    (100_000, 5_000, 20), (256, 333_227, MAX_K), (3, 129, 129)]:
        p = plan(b, n, k, 132)
        n_tiles = math.ceil(n / BN)
        assert (p["splits"] - 1) * p["tiles_per_split"] < n_tiles <= p["splits"] * p["tiles_per_split"]
        assert p["consumers"] == (1 if b <= 128 else 2)
        assert p["q_chunks"] == math.ceil(b / (128 * p["consumers"]))
        assert p["splits"] * p["q_chunks"] <= max(132, p["q_chunks"])
        m = p["merge_keys"]
        assert p["splits"] * k <= m <= MERGE_KEYS and m & (m - 1) == 0 and m < 2 * p["splits"] * k
    assert plan(256, 333_227, 20, 132)["splits"] >= 128


@pytest.mark.parametrize("engine,search_dtype,top_n,routed", [
    ("exact", "bfloat16", 20, True),
    ("exact", "bfloat16", 65, True),
    ("exact", "float32", 20, False),
    ("approx", "bfloat16", 20, False),
])
def test_pipeline_routes_the_exact_bf16_search(monkeypatch, engine, search_dtype, top_n, routed):
    rng = np.random.default_rng(4)
    vectors = rng.normal(size=(300, 24)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    euler = rng.uniform(0, 90, size=(300, 3))
    calls = []

    def spy(q, table, k):
        calls.append((q.dtype, table.dtype, k))
        return cosine_topk_wide_plain(q, table, k)

    from latice_tpu_torch.index import pipeline as pipeline_mod

    monkeypatch.setattr(pipeline_mod, "cosine_topk_wide", spy)
    pipe = IndexPipeline(None, vectors, euler, top_n=top_n, batch_size=8, engine=engine,
                         search_dtype=search_dtype, device="cpu",
                         feature_fn=lambda x: x.flatten(1)[:, :24].contiguous())
    x = rng.random((20, 8, 8)).astype(np.float32)
    res = pipe(x)
    assert len(res.success) == 20
    assert bool(calls) == routed
    if routed:
        assert calls[0] == (torch.bfloat16, torch.bfloat16, top_n) and len(calls) == 3
        q = l2_normalize(torch.from_numpy(np.ascontiguousarray(x.reshape(20, -1)[:, :24])))
        t = torch.from_numpy(vectors).bfloat16()
        want = topk_lower_index_first(cosine_scores(q.bfloat16(), t), top_n + 1)
        _assert_same((torch.from_numpy(res.scores).float(), torch.from_numpy(res.indices)), want,
                     q.bfloat16(), t)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _blocked_twin(q, t, k, rows=32_768):
    """The twin over row blocks of the table (its f32 copy of a 10.9 GB
    table would be 21.8 GB), merged in the same order."""
    vals, idx = [], []
    for i in range(0, len(t), rows):
        v, j = cosine_topk_wide_plain(q, t[i : i + rows], min(k, len(t[i : i + rows])))
        vals.append(v)
        idx.append(j + i)
    v, pos = topk_lower_index_first(torch.cat(vals, 1), k)
    return v, torch.cat(idx, 1).gather(1, pos)


@pytest.mark.card
@pytest.mark.parametrize("d", [4_096, 16_384])
@pytest.mark.parametrize("b", [1, 256])
def test_card_kernel_matches_the_twin_at_the_cells_table(card, b, d):
    gen = torch.Generator(device=card).manual_seed(b + d)
    t = torch.cat([_unit_bf16(gen, 16_384, d, card) for _ in range(20)])
    t = torch.cat([t, _unit_bf16(gen, 333_227 - len(t), d, card)])
    q = _unit_bf16(gen, b, d, card)
    q[0] = t[333_000]
    before = cosine_topk_wide.launches
    got = cosine_topk_wide(q, t, 20)
    assert cosine_topk_wide.launches == before + 1
    torch.cuda.synchronize()
    _assert_same(got, _blocked_twin(q, t, 24), q, t, _tol(d))
    assert got[1][0, 0] == 333_000


@pytest.mark.card
@pytest.mark.parametrize("b,n,d,k", [(5, 1000, 104, 20), (1, 300, 16, 20), (130, 5000, 256, 64),
                                     (3, 40, 24, 20), (300, 20_000, 1024, 20),
                                     (7, 3000, 520, 200), (2, 129, 64, 128)])
def test_card_kernel_matches_the_twin_at_odd_shapes(card, b, n, d, k):
    gen = torch.Generator(device=card).manual_seed(n)
    t = _unit_bf16(gen, n, d, card)
    t[11] = t[10]
    q = _unit_bf16(gen, b, d, card)
    q[0] = t[10]
    got = cosine_topk_wide(q, t, k)
    _assert_same(got, cosine_topk_wide_plain(q, t, k + 1), q, t, _tol(d))
    assert got[1][0, 0] == 10 and got[1][0, 1] == 11


@pytest.mark.card
def test_card_refuses_what_the_kernel_does_not_take(card):
    t = torch.zeros(2_000, 24, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="at most 1024"):
        cosine_topk_wide(t[:2], t, MAX_K + 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        cosine_topk_wide(t[:2, :20].contiguous(), t[:, :20].contiguous(), 5)


@pytest.mark.card
def test_card_di_path_launches_k5_once_a_batch(card):
    rng = np.random.default_rng(5)
    stack = rng.integers(0, 256, (600, 32, 32), dtype=np.uint8)
    di = PatternDictionaryIndexer(stack, rng.uniform(0, 90, (600, 3)), batch_size=16, device=card)
    queries = rng.integers(0, 256, (40, 32, 32), dtype=np.uint8)  # batches of 16, 16 and 8
    di(queries)  # builds the kernels
    before = cosine_topk_wide.launches
    with profile(activities=[ProfilerActivity.CUDA]):
        result = di(queries)
    assert cosine_topk_wide.launches == before + 3
    counters = recorded().counters
    assert counters["search.k5_launches"] == counters["index.batches"] == 3
    # The twin on the same features (the card's and the CPU's f32 features
    # may round to bf16 apart).
    q = l2_normalize(torch.from_numpy(di.pipeline.encode(queries)).to(card)).bfloat16()
    table = di.pipeline.search.table
    _assert_same((torch.from_numpy(result.scores).float(), torch.from_numpy(result.indices)),
                 cosine_topk_wide_plain(q, table, 21), q, table, _tol(32 * 32))
