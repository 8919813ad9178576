"""The port's `parallel` package against latice_tpu's.

A port mesh in these tests is four CPU entries (`make_mesh(devices=["cpu"] *
4)`), the counterpart of a 4-device JAX mesh over the suite's virtual CPU
devices (tests/conftest.py). The same seeded numpy inputs go through
`latice_tpu.parallel.sharded_cosine_topk` and the port's:

* exact and fused (the port's plain K1 twin): indices equal, scores within
  1e-6 of JAX's, padded tables and all-negative scores included;
* int8: JAX's sharded int8 indices exactly and its scores within 1e-6 (as
  tests/parallel/test_parallel.py holds JAX's sharded against unsharded:
  the shard_map divides by 127**2 where the unsharded program multiplies by
  the reciprocal, one ulp apart), and the port's unsharded int8 bit for
  bit;
* approx: recall@10 >= 0.9 against the exact top-k, as JAX's own tests hold
  its approx engine;
* a bf16 table (exact, and approx at 128 rows a shard): f32 queries times
  the bf16 shards, indices equal to JAX's and scores within 1e-5.

`dp_dispatch_plan`'s cases are tests/parallel/test_parallel.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index import l2_normalize as jax_l2_normalize
from latice_tpu.index import quantize_dictionary_int8 as jax_quantize
from latice_tpu.parallel import make_mesh as jax_make_mesh
from latice_tpu.parallel import shard_dictionary as jax_shard_dictionary
from latice_tpu.parallel import sharded_cosine_topk as jax_sharded_topk
from latice_tpu_torch import parallel
from latice_tpu_torch.index import cosine_topk, cosine_topk_int8, quantize_dictionary_int8
from latice_tpu_torch.parallel import (
    dp_dispatch_plan,
    make_mesh,
    replicate,
    shard_batch,
    shard_dictionary,
    sharded_cosine_topk,
)
from latice_tpu_torch.parallel.mesh import Mesh, check_mesh_device, gather_rows, map_blocks

ENGINES = ("exact", "fused", "approx", "int8")


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= 4, "conftest provides 8 virtual CPU devices"
    return jax_make_mesh(4)


def _unit(x):
    return np.array(jax_l2_normalize(jnp.asarray(x)))


def test_all_matches_jax():
    import latice_tpu.parallel as jax_parallel

    assert parallel.__all__ == jax_parallel.__all__


class TestDispatchPlan:
    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_plan_matches_padded_batch_math(self, n_dev):
        n_items = 4 * n_dev + 3
        plan = dp_dispatch_plan(n_items, 2 * n_dev, n_dev)
        assert plan["n_batches"] == 3
        assert plan["rows_per_device"] == 2
        assert plan["padded_items"] == 6 * n_dev
        assert plan["tail_pad"] == 6 * n_dev - n_items
        assert plan["parallel_efficiency_ppm"] == int(round(1e6 * n_items / (6 * n_dev)))

    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_plan_full_map_scan(self, n_dev):
        plan = dp_dispatch_plan(65_536, 1024, n_dev)
        assert plan["n_batches"] == 64
        assert plan["rows_per_device"] == 1024 // n_dev
        assert plan["tail_pad"] == 0
        assert plan["parallel_efficiency_ppm"] == 1_000_000

    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_plan_equals_jax(self, n_dev):
        from latice_tpu.parallel import dp_dispatch_plan as jax_plan

        for n_items, batch in ((4 * n_dev + 3, 2 * n_dev), (1000, 16 * n_dev), (1, n_dev)):
            assert dp_dispatch_plan(n_items, batch, n_dev) == jax_plan(n_items, batch, n_dev)

    def test_plan_rejects_indivisible(self):
        with pytest.raises(ValueError, match="divide"):
            dp_dispatch_plan(100, 10, 3)
        with pytest.raises(ValueError, match="positive"):
            dp_dispatch_plan(0, 4, 2)


class TestMesh:
    def test_make_mesh_size_and_axis(self, mesh):
        assert isinstance(mesh, Mesh)
        assert mesh.size == 4 and mesh.axis_names == ("data",)
        assert mesh.devices == (torch.device("cpu"),) * 4
        assert make_mesh(2, devices=["cpu"] * 4, axis_name="batch").axis_names == ("batch",)

    def test_make_mesh_too_many(self):
        with pytest.raises(ValueError, match="Requested 5 devices but only 4 available"):
            make_mesh(5, devices=["cpu"] * 4)

    def test_make_mesh_over_missing_cards_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the refusal is for machines without one")
        with pytest.raises(ValueError, match="Requested 2 devices but only 0 available"):
            make_mesh(2)
        with pytest.raises(ValueError, match="no device"):
            make_mesh()

    def test_mesh_device_checks(self, mesh):
        assert check_mesh_device(mesh, None) == torch.device("cpu")
        assert check_mesh_device(mesh, "cpu") == torch.device("cpu")
        with pytest.raises(ValueError, match="first device"):
            check_mesh_device(mesh, "meta")
        with pytest.raises(TypeError, match="Mesh"):
            check_mesh_device(object(), None)

    def test_shard_batch_divisibility(self, mesh):
        with pytest.raises(ValueError, match="divisible"):
            shard_batch(np.zeros((7, 4), np.float32), mesh)

    @pytest.mark.parametrize("source", ["numpy", "tensor", "readonly"])
    def test_shard_batch_placement_and_gather(self, mesh, source):
        x = np.arange(16.0, dtype=np.float32).reshape(16, 1)
        if source == "tensor":
            x = torch.from_numpy(x)
        elif source == "readonly":
            x.setflags(write=False)
        blocks = shard_batch(x, mesh)
        assert len(blocks) == 4 and all(b.shape == (4, 1) for b in blocks)
        np.testing.assert_array_equal(gather_rows(blocks, mesh).numpy(), np.asarray(x))

    def test_replicate_copies_every_entry(self, mesh):
        lin = torch.nn.Linear(2, 3)
        t = torch.ones(3)
        reps = replicate({"m": lin, "t": t, "a": np.zeros(2), "k": 5}, mesh)
        assert len(reps) == 4
        assert all(r["m"] is not lin and r["t"] is not t and r["k"] == 5 for r in reps)
        assert reps[0]["t"].data_ptr() != reps[1]["t"].data_ptr()
        reps[1]["m"].weight.data.zero_()
        assert lin.weight.abs().sum() > 0
        batch_of, copy_of = parallel.data_parallel_sharding(mesh)
        assert len(batch_of(np.zeros((8, 2)))) == 4 and len(copy_of(t)) == 4
        assert len(parallel.replicate_state({"w": t}, mesh)) == 4

    def test_map_blocks_gathers_tuples(self, mesh):
        x = np.arange(8.0, dtype=np.float32)
        tables = replicate((torch.tensor(2.0),), mesh)
        doubled, plus = map_blocks(lambda b, c: (b * c, b + c), [x], tables, mesh)
        np.testing.assert_array_equal(doubled.numpy(), 2 * x)
        np.testing.assert_array_equal(plus.numpy(), x + 2)


class TestShardDictionary:
    @pytest.mark.parametrize("source", ["numpy", "tensor"])
    def test_nondivisible_padded_with_zero_rows(self, mesh, source):
        d = np.random.default_rng(0).normal(size=(1001, 16)).astype(np.float32)
        sd = shard_dictionary(d if source == "numpy" else torch.from_numpy(d), mesh)
        assert sd.shape == (1004, 16) and sd.shard_rows == 251 and len(sd.shards) == 4
        host = torch.cat(sd.shards).numpy()
        np.testing.assert_array_equal(host[:1001], d)
        np.testing.assert_array_equal(host[1001:], 0.0)
        # JAX pads the same rows.
        jax_sd = jax_shard_dictionary(d, jax_make_mesh(4))
        assert jax_sd.shape == sd.shape

    def test_int8_table_keeps_its_dtype(self, mesh):
        dq, _ = quantize_dictionary_int8(np.zeros((10, 8), np.float32))
        sd = shard_dictionary(dq, mesh)
        assert sd.dtype == torch.int8 and sd.shape == (12, 8)


def _negative_setup(rng, n=1001, b=5):
    base = rng.normal(size=16).astype(np.float32)
    q = base + rng.normal(size=(b, 16)).astype(np.float32) * 0.05
    d = _unit(-base + rng.normal(size=(n, 16)).astype(np.float32) * 0.05)
    return q, d


def _recall(got, ref):
    return np.mean([len(set(g) & set(r)) / len(r) for g, r in zip(got, ref)])


class TestShardedSearch:
    @pytest.mark.parametrize("engine", ["exact", "fused"])
    @pytest.mark.parametrize("n, k", [(1024, 10), (1000, 7), (1001, 7), (6, 5)])
    def test_exact_engines_match_jax(self, mesh, jax_mesh, engine, n, k):
        rng = np.random.default_rng(n + k)
        d = _unit(rng.normal(size=(n, 16)).astype(np.float32))
        q = rng.normal(size=(5, 16)).astype(np.float32)
        s_ref, i_ref = jax_sharded_topk(
            jnp.asarray(q), jax_shard_dictionary(d, jax_mesh), k, jax_mesh, n_valid=n,
            engine=engine,
        )
        s, i = sharded_cosine_topk(q, shard_dictionary(d, mesh), k, mesh, n_valid=n,
                                   engine=engine)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-6)
        # And the port's own unsharded search.
        s1, i1 = cosine_topk(torch.from_numpy(q), torch.from_numpy(d), k)
        np.testing.assert_array_equal(i.numpy(), i1.numpy())

    @pytest.mark.parametrize("engine", ["exact", "fused", "int8"])
    def test_negative_similarity_padded_dictionary(self, mesh, jax_mesh, engine):
        """Pad rows must lose to genuine negative-score matches (every real
        cosine is < 0 here, so a zero pad row scoring 0 would win)."""
        q, d = _negative_setup(np.random.default_rng(1))
        table = d
        if engine == "int8":
            table = quantize_dictionary_int8(d)[0]
        s, i = sharded_cosine_topk(q, shard_dictionary(table, mesh), 7, mesh, n_valid=1001,
                                   engine=engine)
        assert (s.numpy() < 0).all() and (i.numpy() < 1001).all()
        jt = np.asarray(jax_quantize(d)[0]) if engine == "int8" else d
        s_ref, i_ref = jax_sharded_topk(
            jnp.asarray(q), jax_shard_dictionary(jt, jax_mesh), 7, jax_mesh, n_valid=1001,
            engine=engine,
        )
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("engine, n", [("exact", 8192), ("approx", 512)])
    def test_bf16_table_matches_jax(self, mesh, jax_mesh, engine, n):
        """A bf16 table multiplied by the f32 queries, as JAX's sharded
        search does: indices equal, scores within 1e-5 (rounding the
        queries to bf16 too moves the scores by ~1e-3). The approx case
        keeps each shard at 128 rows, where both engines select exactly."""
        rng = np.random.default_rng(n)
        d = _unit(rng.normal(size=(n, 16)).astype(np.float32))
        q = rng.normal(size=(64, 16)).astype(np.float32)
        s_ref, i_ref = jax_sharded_topk(
            jnp.asarray(q), jax_shard_dictionary(jnp.asarray(d, jnp.bfloat16), jax_mesh),
            20, jax_mesh, n_valid=n, engine=engine,
        )
        table = shard_dictionary(torch.from_numpy(d).bfloat16(), mesh)
        assert table.dtype == torch.bfloat16
        s, i = sharded_cosine_topk(q, table, 20, mesh, n_valid=n, engine=engine)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)

    def test_ties_keep_the_lower_global_index(self, mesh):
        """Duplicate rows on different shards: the merge keeps lax.top_k's
        order, the lower global index first."""
        rng = np.random.default_rng(2)
        d = _unit(rng.normal(size=(40, 16)).astype(np.float32))
        d[25] = d[3]
        d[37] = d[3]
        q = d[3:4] * 2.0
        for engine in ("exact", "fused"):
            _, i = sharded_cosine_topk(q, shard_dictionary(d, mesh), 3, mesh, engine=engine)
            assert i[0].tolist() == [3, 25, 37], engine

    def _engine_setup(self, n=1000, b=16):
        rng = np.random.default_rng(n)
        d = _unit(rng.normal(size=(n, 16)).astype(np.float32))
        q = d[:b] + rng.normal(size=(b, 16)).astype(np.float32) * 0.05
        return d, q

    def test_int8_matches_jax_and_unsharded(self, mesh, jax_mesh):
        d, q = self._engine_setup(n=1024)
        dq = quantize_dictionary_int8(d)[0]
        np.testing.assert_array_equal(dq, np.asarray(jax_quantize(d)[0]))
        s, i = sharded_cosine_topk(q, shard_dictionary(dq, mesh), 10, mesh, engine="int8")
        s_ref, i_ref = jax_sharded_topk(
            jnp.asarray(q), jax_shard_dictionary(dq, jax_mesh), 10, jax_mesh, engine="int8"
        )
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-6)
        s1, i1 = cosine_topk_int8(torch.from_numpy(q), torch.from_numpy(dq), 10)
        np.testing.assert_array_equal(i.numpy(), i1.numpy())
        np.testing.assert_array_equal(s.numpy(), s1.numpy())
        # int8 scores carry ~0.5% quantization error, not more.
        np.testing.assert_allclose(s.numpy()[:, 0], 1.0, atol=0.1)

    def test_approx_recall(self, mesh):
        d, q = self._engine_setup(n=4096)
        _, i_ref = cosine_topk(torch.from_numpy(q), torch.from_numpy(d), 10)
        _, i = sharded_cosine_topk(q, shard_dictionary(d, mesh), 10, mesh, n_valid=len(d),
                                   engine="approx", recall_target=0.95)
        assert _recall(i.numpy(), i_ref.numpy()) >= 0.9

    @pytest.mark.parametrize("engine", ENGINES)
    def test_every_engine_finds_self_matches(self, mesh, engine):
        d, _ = self._engine_setup(n=999)
        table = quantize_dictionary_int8(d)[0] if engine == "int8" else d
        _, i = sharded_cosine_topk(d[::50], shard_dictionary(table, mesh), 5, mesh,
                                   n_valid=999, engine=engine)
        np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(0, 999, 50))

    def test_unknown_engine_raises(self, mesh):
        d, q = self._engine_setup(n=64, b=2)
        with pytest.raises(ValueError, match="unknown sharded engine"):
            sharded_cosine_topk(q, shard_dictionary(d, mesh), 5, mesh, engine="hnsw")

    def test_shard_count_must_match_the_mesh(self, mesh):
        d, q = self._engine_setup(n=64, b=2)
        sd = shard_dictionary(d, make_mesh(devices=["cpu"] * 2))
        with pytest.raises(ValueError, match="shards"):
            sharded_cosine_topk(q, sd, 5, mesh)
