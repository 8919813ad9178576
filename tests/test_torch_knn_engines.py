"""The port's search engines against latice_tpu's: int8, approx, blocked,
streamed, bf16 search, through `knn`, `IndexPipeline` and the DB.

* int8: the quantized dictionary and `cosine_topk_int8` equal JAX's,
  indices and scores exactly, ties included (the queries are normalized in
  XLA's CPU order, so they round to the same integers).
* blocked and streamed: JAX's `cosine_topk`'s indices exactly, scores
  within 1e-6 (f32 and bf16 chunks, a memmap, N not a multiple of the
  block, an anti-correlated dictionary).
* approx: recall@10 > 0.9 against JAX's exact top-k at 4,096 x 16; every
  candidate is its bin's maximum; the bin count follows XLA's formula.
* the pipeline at inplanes 2 on each engine against JAX's `IndexPipeline`
  with the same weights; the DB's approx and int8 engines.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index import IndexPipeline as JaxPipeline
from latice_tpu.index import LatentVectorDatabaseConfig as JaxDbConfig
from latice_tpu.index import TpuLatentVectorDatabase
from latice_tpu.index import knn as jknn
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu_torch.index import (
    IndexPipeline,
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
    cosine_topk_approx,
    cosine_topk_blocked,
    cosine_topk_int8,
    cosine_topk_streamed,
    quantize_dictionary_int8,
)
from latice_tpu_torch.index.knn import approx_bins, approx_topk, topk_lower_index_first
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _jax_unit(x):
    return np.array(jknn.l2_normalize(jnp.asarray(x, jnp.float32)))


# -- selection order ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 7, 40])
def test_topk_order_is_lax_top_k(k):
    """Many equal scores, -0.0 beside +0.0, -inf: the same order as lax.top_k."""
    rng = np.random.default_rng(1)
    s = rng.integers(-3, 4, size=(9, 40)).astype(np.float32) / 4
    s[0, :5] = [0.0, -0.0, -0.0, 0.0, -np.inf]
    s[1, 10:] = -np.inf
    want_s, want_i = jax.lax.top_k(jnp.asarray(s), k)
    got_s, got_i = topk_lower_index_first(torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# -- int8 ---------------------------------------------------------------------


def test_quantize_matches_jax():
    rng = np.random.default_rng(2)
    d = _jax_unit(rng.normal(size=(500, 16)))
    d[0, :4] = [0.5 / 127, -0.5 / 127, 1.5 / 127, 1.0]  # halves round to even
    want, scale = jknn.quantize_dictionary_int8(d)
    got_np, got_scale = quantize_dictionary_int8(d)
    got_t, _ = quantize_dictionary_int8(torch.from_numpy(d))
    assert got_np.dtype == np.int8 and got_t.dtype == torch.int8
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert got_scale == scale


INT8_CASES = {
    "random": dict(n=2000, b=64, k=10, dup=0),
    "duplicated_rows": dict(n=600, b=40, k=20, dup=8),
    "few_queries": dict(n=301, b=3, k=5, dup=3),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_cosine_topk_int8_matches_jax(case):
    c = INT8_CASES[case]
    rng = np.random.default_rng(3)
    d = _jax_unit(rng.normal(size=(c["n"], 16)))
    if c["dup"]:
        # Each block of rows repeats one row: every score in it ties.
        d = np.repeat(d[: c["n"] // c["dup"] + 1], c["dup"], axis=0)[: c["n"]]
    q = rng.normal(size=(c["b"], 16)).astype(np.float32) * 3.0
    dq, _ = jknn.quantize_dictionary_int8(d)
    want_s, want_i = jknn.cosine_topk_int8(jnp.asarray(q), jnp.asarray(dq), c["k"])
    got_s, got_i = cosine_topk_int8(torch.from_numpy(q), torch.from_numpy(dq), c["k"])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if c["dup"]:
        assert (np.diff(np.asarray(want_s), axis=1) == 0).any()  # ties are there


def test_cosine_topk_int8_padded_rows_are_ignored():
    rng = np.random.default_rng(4)
    d = _jax_unit(-rng.normal(size=(13, 16)) - 3.0)  # every score negative
    dq, _ = quantize_dictionary_int8(torch.from_numpy(d))
    padded = torch.cat([dq, torch.zeros((3, 16), dtype=torch.int8)])
    q = torch.from_numpy(np.abs(rng.normal(size=(4, 16))).astype(np.float32))
    want = cosine_topk_int8(q, dq, 13)
    got = cosine_topk_int8(q, padded, 13, n_valid=13)
    assert (want[0] < 0).all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- blocked and streamed -----------------------------------------------------

SEARCH_CASES = {
    "divisible": dict(n=1024, b=5, k=10, block=256, anti=False),
    "not_divisible": dict(n=333, b=3, k=7, block=128, anti=False),
    "anti_correlated": dict(n=333, b=4, k=7, block=128, anti=True),
    "one_block": dict(n=100, b=6, k=20, block=4096, anti=False),
}


def _search_data(case):
    c = SEARCH_CASES[case]
    rng = np.random.default_rng(5)
    if c["anti"]:
        # Every row points away from every query: a zero pad row would score 0
        # and win.
        base = rng.normal(size=16).astype(np.float32)
        q = base + rng.normal(size=(c["b"], 16)).astype(np.float32) * 0.05
        d = _jax_unit(-base + rng.normal(size=(c["n"], 16)).astype(np.float32) * 0.05)
    else:
        q = rng.normal(size=(c["b"], 16)).astype(np.float32)
        d = _jax_unit(rng.normal(size=(c["n"], 16)))
    want_s, want_i = jknn.cosine_topk(jnp.asarray(q), jnp.asarray(d), c["k"])
    if c["anti"]:
        assert np.all(np.asarray(want_s) < 0)
    return c, q, d, np.asarray(want_s), np.asarray(want_i)


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_blocked_matches_jax_exact(case):
    c, q, d, want_s, want_i = _search_data(case)
    got_s, got_i = cosine_topk_blocked(torch.from_numpy(q), torch.from_numpy(d), c["k"],
                                       block_size=c["block"])
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-6)
    js, ji = jknn.cosine_topk_blocked(jnp.asarray(q), jnp.asarray(d), c["k"],
                                      block_size=c["block"])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("source", ["numpy", "memmap", "tensor"])
@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_streamed_f32_matches_jax_exact(case, source, tmp_path):
    c, q, d, want_s, want_i = _search_data(case)
    if source == "memmap":
        mm = np.lib.format.open_memmap(tmp_path / "d.npy", mode="w+", dtype=np.float32,
                                       shape=d.shape)
        mm[:] = d
        mm.flush()
        table = np.load(tmp_path / "d.npy", mmap_mode="r")
    elif source == "tensor":
        table = torch.from_numpy(d)
    else:
        table = d
    got_s, got_i = cosine_topk_streamed(q, table, c["k"], chunk_rows=c["block"], device="cpu")
    assert got_s.device.type == "cpu"
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-6)


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_streamed_bf16_matches_jax_streamed(case):
    """bf16 rows (a CPU tensor: numpy has no bf16) against JAX's streamed
    engine on the same bf16 rows; both round the queries to bf16."""
    c, q, d, _, _ = _search_data(case)
    d16 = torch.from_numpy(d).to(torch.bfloat16)
    d16_np = d16.float().numpy().astype(jnp.bfloat16)
    want_s, want_i = jknn.cosine_topk_streamed(jnp.asarray(q), d16_np, c["k"],
                                               chunk_rows=c["block"])
    got_s, got_i = cosine_topk_streamed(torch.from_numpy(q), d16, c["k"], chunk_rows=c["block"])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)


# -- approx -------------------------------------------------------------------


@pytest.mark.parametrize(
    "n, k, recall, want",
    [
        (4096, 10, 0.95, (256, 16)),  # M = 9 / -ln 0.95 = 175; 4096 // 175 = 23 -> width 16
        (1_000_000, 10, 0.95, (245, 4096)),
        (1_000_000, 20, 0.95, (489, 2048)),  # M = 370 -> width 2048
        (100_000, 20, 0.99, (3125, 32)),  # M = 19 / -ln 0.99 = 1890 -> width 32
        (128, 10, 0.95, (128, 1)),  # at most 128 scores: not binned
        (4096, 10, 1.0, (4096, 1)),
        (300, 10, 0.95, (300, 1)),  # 300 // 175 = 1: width 1
    ],
)
def test_approx_bins_follow_xla_formula(n, k, recall, want):
    if want[1] > 1:
        m = min(max(int((1 - k) / math.log(recall)), 128), n)
        assert want[1] == 2 ** int(math.floor(math.log2(n // m)))
        assert want[0] == -(-n // want[1])
    assert approx_bins(n, k, recall) == want


def test_approx_bins_refuse_bad_targets():
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="recall_target"):
            approx_bins(4096, 10, bad)


def test_approx_recall_against_jax_exact():
    rng = np.random.default_rng(6)
    d = _jax_unit(rng.normal(size=(4096, 16)))
    q = d[:16]
    _, want_i = jknn.cosine_topk(jnp.asarray(q), jnp.asarray(d), 10)
    got_s, got_i = cosine_topk_approx(torch.from_numpy(q), torch.from_numpy(d), 10)
    recall = np.mean([len(set(got_i[b].tolist()) & set(np.asarray(want_i[b]).tolist())) / 10
                      for b in range(16)])
    assert recall > 0.9, recall
    assert (got_i[:, 0].numpy() == np.arange(16)).all()  # each query's own row
    assert (np.diff(got_s.numpy(), axis=1) <= 0).all()  # best first


def test_approx_keeps_one_maximum_per_bin():
    """The TPU algorithm, not a relabelled exact top-k: each candidate is
    the maximum of its bin (rows j with equal j % M), and no two share one."""
    rng = np.random.default_rng(7)
    scores = torch.from_numpy(rng.normal(size=(8, 5000)).astype(np.float32))
    bins, width = approx_bins(5000, 10, 0.95)
    assert width > 1
    vals, idx = approx_topk(scores, 10, 0.95)
    padded = torch.nn.functional.pad(scores, (0, bins * width - 5000), value=-math.inf)
    bin_max = padded.view(8, width, bins).amax(dim=1)
    np.testing.assert_array_equal(vals.numpy(), scores.gather(1, idx).numpy())
    np.testing.assert_array_equal(vals.numpy(), bin_max.gather(1, idx % bins).numpy())
    assert all(len(set((row % bins).tolist())) == 10 for row in idx)
    # The top-10 maxima of the bins, best first.
    np.testing.assert_array_equal(vals.numpy(), torch.topk(bin_max, 10).values.numpy())


# -- the pipeline -------------------------------------------------------------

CLUSTERS, PER_CLUSTER, FILLER, TOP_N = 6, 12, 400, 10


@pytest.fixture(scope="module")
def plane():
    """JAX weights at inplanes 2 (carried into the port), and a dictionary
    built around the latents of six anchor patterns: each cluster holds the
    anchor's own latent and 11 rows at growing angles from it (scores 1,
    0.995, 0.990, ... to the anchor), with orientations within 0.4° of its
    grain's (every third cluster spread 8°, so its consensus fails), plus
    400 random filler rows. Queries are the anchors plus faint noise."""
    rng = np.random.default_rng(8)
    jm = JaxVAE(inplanes=2, latent_dim=16)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(1)
    )["params"]
    tm = VariationalAutoEncoderRawData(2, 16)
    tm.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), 2, 16))
    enc = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="encode")[0])

    anchors = rng.uniform(size=(CLUSTERS, 128, 128)).astype(np.float32)
    lat = _unit(np.asarray(enc(params, jnp.asarray(anchors[..., None]))))
    rows, orients = [], []
    grains = rng.uniform([20, 30, 20], [160, 150, 160], size=(CLUSTERS, 3))
    for c in range(CLUSTERS):
        noise = rng.normal(size=(PER_CLUSTER, 16))
        noise -= (noise @ lat[c])[:, None] * lat[c]  # orthogonal to the anchor
        noise = _unit(noise)
        t = np.concatenate([[0.0], 0.1 + 0.04 * np.arange(PER_CLUSTER - 1)])
        rows.append(_unit(lat[c] + t[:, None] * noise))
        spread = 8.0 if c % 3 == 2 else 0.4
        orients.append(grains[c] + rng.uniform(-1, 1, size=(PER_CLUSTER, 3)) * spread)
    rows.append(_unit(rng.normal(size=(FILLER, 16))))
    orients.append(rng.uniform([0, 20, 0], [340, 160, 340], size=(FILLER, 3)))
    dictionary = np.concatenate(rows).astype(np.float32)
    orientations = np.concatenate(orients)
    perm = rng.permutation(len(dictionary))  # clusters spread over the bins
    dictionary, orientations = dictionary[perm], orientations[perm]
    anchor_rows = np.argsort(perm)[np.arange(CLUSTERS) * PER_CLUSTER]
    queries = np.clip(anchors + rng.normal(size=anchors.shape) * 0.002, 0, 1).astype(np.float32)
    return dict(jm=jm, params=params, tm=tm, dictionary=dictionary, orientations=orientations,
                queries=queries, anchor_rows=anchor_rows)


KNOBS = dict(top_n=TOP_N, orientation_threshold=3.0, min_required_matches=8, batch_size=8)


def _pipes(plane, **kw):
    jp = JaxPipeline(plane["jm"], plane["params"], plane["dictionary"], plane["orientations"],
                     **KNOBS, **kw)
    tp = IndexPipeline(plane["tm"], plane["dictionary"], plane["orientations"], device="cpu",
                       **KNOBS, **kw)
    return jp(plane["queries"]), tp(plane["queries"])


def _misorientation_deg(a, b):
    from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle

    qa, qb = (from_euler_zxz_deg(torch.from_numpy(np.asarray(x, np.float64))) for x in (a, b))
    return np.rad2deg(misorientation_angle(qa, qb).numpy())


def test_pipeline_exact_matches_jax(plane):
    want, got = _pipes(plane, engine="exact")
    # The scenario: every top-k score stands more than 1e-4 from the next.
    assert np.diff(-want.scores, axis=1).min() > 1e-4
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    np.testing.assert_array_equal(got.success, want.success)
    assert want.success.any() and not want.success.all()
    ok = want.success
    assert _misorientation_deg(got.mean_orientation[ok], want.mean_orientation[ok]).max() < 1e-3


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


def test_pipeline_int8_matches_jax(plane):
    want, got = _pipes(plane, engine="int8")
    exact, _ = _pipes(plane, engine="exact")
    np.testing.assert_array_equal(got.indices[:, 0], want.indices[:, 0])
    np.testing.assert_array_equal(got.indices[:, 0], plane["anchor_rows"])
    assert _recall(got.indices, exact.indices) >= 0.9
    np.testing.assert_array_equal(got.success, want.success)


def test_pipeline_bf16_search_matches_jax(plane):
    want, got = _pipes(plane, engine="exact", search_dtype="bfloat16")
    np.testing.assert_allclose(got.scores, want.scores, atol=4e-3)
    np.testing.assert_array_equal(got.indices[:, 0], want.indices[:, 0])
    np.testing.assert_array_equal(got.indices[:, 0], plane["anchor_rows"])
    tp = IndexPipeline(plane["tm"], plane["dictionary"], plane["orientations"], device="cpu",
                       search_dtype="bfloat16", **KNOBS)
    assert tp.search.table.dtype == torch.bfloat16  # cast once, at construction


def test_pipeline_approx_matches_jax_where_candidates_agree(plane):
    want, got = _pipes(plane, engine="approx")
    n = len(plane["dictionary"])
    assert approx_bins(n, TOP_N, 0.95)[1] > 1  # the port bins here
    assert _recall(got.indices, want.indices) >= 0.9
    same = np.array([set(g) == set(w) for g, w in zip(got.indices, want.indices)])
    assert same.any()
    np.testing.assert_array_equal(got.success[same], want.success[same])
    ok = same & want.success
    assert _misorientation_deg(got.mean_orientation[ok], want.mean_orientation[ok]).max() < 1e-3


def test_pipeline_rejects_unknown_search_dtype(plane):
    with pytest.raises(ValueError, match="search_dtype"):
        IndexPipeline(plane["tm"], plane["dictionary"], plane["orientations"], device="cpu",
                      search_dtype="float16")


# -- the database -------------------------------------------------------------


@pytest.mark.parametrize("engine", ["int8", "approx"])
def test_db_engine_matches_jax(tmp_path, engine):
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(1500, 16))
    orients = rng.uniform(0, 360, (1500, 3))
    jdb = TpuLatentVectorDatabase(JaxDbConfig(npz_path=str(tmp_path / "j.npz"), engine=engine))
    tdb = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=str(tmp_path / "t.npz"), engine=engine),
        device="cpu",
    )
    for db in (jdb, tdb):
        db.add_vectors(vecs, orients)
    queries = vecs[:20] + rng.normal(size=(20, 16)) * 0.01
    js, ji = jdb.query_similar_batch(queries, 10)
    ts, ti = tdb.query_similar_batch(queries, 10)
    assert ts.dtype == np.float64 and ti.dtype == np.int64
    if engine == "int8":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
    else:
        np.testing.assert_array_equal(ti[:, 0], np.arange(20))
        assert _recall(ti, ji) >= 0.9
    res = tdb.find_best_orientation(vecs[3], top_n=5, min_required_matches=1)
    np.testing.assert_array_equal(res.candidate_orientations[0], orients[3])


def test_db_int8_cache_dropped_on_add_delete_and_load(tmp_path):
    """The database's search stage (the int8 table, quantized once) is built
    at the first query and dropped whenever the dictionary changes."""
    rng = np.random.default_rng(10)
    path = str(tmp_path / "c.npz")
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=path, engine="int8"),
                                   device="cpu")
    vecs = rng.normal(size=(50, 16))
    db.add_vectors(vecs, rng.uniform(0, 360, (50, 3)))
    assert db._stages is None
    db.query_similar(vecs[0], 3)
    search = db._stages[0]
    assert search.engine == "int8" and search.table.dtype == torch.int8
    assert search.table.shape == (56, 16) and search.n == 50  # padded to a multiple of 8
    db.query_similar(vecs[1], 3)
    assert db._stages[0] is search  # quantized once
    # A new row must be found at once: a stale table would miss it.
    new = rng.normal(size=(1, 16))
    db.add_vectors(new, np.zeros((1, 3)))
    assert db._stages is None
    assert db.query_similar(new[0], 1)[1][0] == 50
    db.save()
    db.load()
    assert db._stages is None
    db.query_similar(vecs[1], 3)
    db.delete_persistence()
    assert db._stages is None and db.get_count() == 0
