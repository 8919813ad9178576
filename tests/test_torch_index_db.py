"""The port's latent database against latice_tpu's TpuLatentVectorDatabase.

Same vectors and orientations on both sides: 12 grains of 25 latents each
(a grain's latents near one another, its orientations spread by 0.4° or,
for every fourth grain, by 8°), so that queries near a tight grain reach
consensus and queries near a loose one do not. Search and consensus run on
the CPU (``device="cpu"``: the fused engine is the kernel's plain twin).

Indices, success, similar indices and phases equal; scores within 1e-6;
orientations within 1e-3° of misorientation. Also: the empty and the
undersized index, multi-phase dictionaries, the "rad" unit of the chroma
backend, the FAISS and chroma compatibility classes, and npz files written
by one package and read by the other, ``sim_meta`` included.
"""

import numpy as np
import pytest
import torch

from latice_tpu.index import LatentVectorDatabaseConfig as JaxConfig
from latice_tpu.index import TpuLatentVectorDatabase
from latice_tpu.index.chroma_db import ChromaLatentVectorDatabase as JaxChroma
from latice_tpu.index.chroma_db import LatentVectorDatabaseConfig as JaxChromaConfig
from latice_tpu.index.faiss_db import FaissLatentVectorDatabase as JaxFaiss
from latice_tpu.index.faiss_db import FaissLatentVectorDatabaseConfig as JaxFaissConfig
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.index import (
    ChromaLatentVectorDatabase,
    FaissLatentVectorDatabase,
    FaissLatentVectorDatabaseConfig,
    LatentVectorDatabaseBase,
    LatentVectorDatabaseConfig,
    OrientationResult,
    TorchLatentVectorDatabase,
)
from latice_tpu_torch.index.chroma_db import LatentVectorDatabaseConfig as ChromaConfig

D, GRAINS, PER = 16, 12, 25


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(GRAINS, 1, D))
    vecs = (centers + 0.05 * rng.normal(size=(GRAINS, PER, D))).reshape(-1, D).astype(np.float32)
    grain_euler = rng.uniform([10, 30, 10], [170, 150, 170], size=(GRAINS, 1, 3))
    spread = np.where(np.arange(GRAINS) % 4 == 3, 8.0, 0.4)[:, None, None]
    orients = (grain_euler + rng.uniform(-1, 1, (GRAINS, PER, 3)) * spread).reshape(-1, 3)
    phases = np.repeat(np.arange(GRAINS) % 2, PER).astype(np.int32)
    q_idx = rng.integers(0, GRAINS, 30)
    queries = (centers[q_idx, 0] + 0.05 * rng.normal(size=(30, D))).astype(np.float32)
    return dict(vecs=vecs, orients=orients, phases=phases, queries=queries)


def _mis_deg(a, b):
    qa = from_euler_zxz_deg(torch.from_numpy(np.asarray(a, np.float64)))
    qb = from_euler_zxz_deg(torch.from_numpy(np.asarray(b, np.float64)))
    return np.rad2deg(misorientation_angle(qa, qb).numpy())


def _pair(tmp_path, data, phases=False, **cfg):
    """(JAX db, port db) holding the same entries; ``cfg`` goes to both
    configs."""
    kw = dict(phases=data["phases"]) if phases else {}
    jax_db = TpuLatentVectorDatabase(JaxConfig(npz_path=str(tmp_path / "j.npz"), **cfg))
    jax_db.add_vectors(data["vecs"], data["orients"], **kw)
    port = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=str(tmp_path / "p.npz"), **cfg), device="cpu"
    )
    port.add_vectors(data["vecs"], data["orients"], **kw)
    return jax_db, port


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.success == w.success
        np.testing.assert_allclose(g.distances, w.distances, atol=1e-6)
        np.testing.assert_array_equal(g.candidate_orientations, w.candidate_orientations)
        np.testing.assert_array_equal(g.similar_indices, w.similar_indices)
        assert g.phase == w.phase
        assert _mis_deg(g.best_orientation, w.best_orientation) < 1e-3
        if w.mean_orientation is None:
            assert g.mean_orientation is None
        else:
            assert _mis_deg(g.mean_orientation, w.mean_orientation) < 1e-3


CASES = {
    "device": dict(engine="device"),
    "fused": dict(engine="fused"),
    "rad": dict(angle_unit="rad"),
    "two_phase": dict(phase_symmetries=["432", "622"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_matches_jax(tmp_path, data, case):
    cfg = dict(CASES[case])
    jax_db, port = _pair(tmp_path, data, phases=case == "two_phase", **cfg)
    threshold = 0.05 if case == "rad" else 3.0  # 0.05 rad ≈ 2.9°
    kw = dict(top_n=20, orientation_threshold=threshold, min_required_matches=18)
    q = data["queries"]
    want = jax_db.find_best_orientations_batch(q, batch_size=16, **kw)
    got = port.find_best_orientations_batch(q, batch_size=16, **kw)
    assert 0 < sum(r.success for r in want) < len(q)
    _assert_results_equal(got, want)
    _assert_results_equal([port.find_best_orientation(q[3], **kw)],
                          [jax_db.find_best_orientation(q[3], **kw)])

    dense_w = jax_db.find_best_orientations_dense(q, batch_size=16, **kw)
    dense_g = port.find_best_orientations_dense(q, batch_size=16, **kw)
    assert sorted(dense_g) == sorted(dense_w)
    for key in ("success", "n_similar", "indices") + (("phase",) if "phase" in dense_w else ()):
        np.testing.assert_array_equal(dense_g[key], dense_w[key])
    np.testing.assert_allclose(dense_g["scores"], dense_w["scores"], atol=1e-6)
    assert _mis_deg(dense_g["best_orientation"], dense_w["best_orientation"]).max() < 1e-3
    ok = dense_w["success"]
    np.testing.assert_array_equal(np.isnan(dense_g["mean_orientation"]),
                                  np.isnan(dense_w["mean_orientation"]))
    assert _mis_deg(dense_g["mean_orientation"][ok], dense_w["mean_orientation"][ok]).max() < 1e-3


def test_query_similar_matches_jax(tmp_path, data):
    jax_db, port = _pair(tmp_path, data)
    s_w, i_w = jax_db.query_similar_batch(data["queries"], 7)
    s_g, i_g = port.query_similar_batch(data["queries"], 7)
    np.testing.assert_array_equal(i_g, i_w)
    np.testing.assert_allclose(s_g, s_w, atol=1e-6)
    assert s_g.dtype == np.float64 and i_g.dtype == np.int64
    s1, i1 = port.query_similar(data["queries"][0], 5)
    np.testing.assert_array_equal(i1, i_w[0, :5])
    with pytest.raises(ValueError, match="dimension"):
        port.query_similar(np.zeros(D + 1, np.float32))


def test_empty_and_undersized_index(tmp_path, data):
    jax_db = TpuLatentVectorDatabase(JaxConfig(npz_path=str(tmp_path / "j.npz")))
    port = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=str(tmp_path / "p.npz")), device="cpu"
    )
    q = data["queries"][:2]
    s, i = port.query_similar(q[0])
    assert s.size == 0 and i.size == 0
    want, got = jax_db.find_best_orientation(q[0]), port.find_best_orientation(q[0])
    assert got.success is want.success is False
    assert np.isnan(got.best_orientation).all() and got.candidate_orientations.size == 0
    dense = port.find_best_orientations_dense(q)
    assert dense["indices"].shape == (2, 0) and not dense["success"].any()

    jax_db.add_vectors(data["vecs"][:5], data["orients"][:5])
    port.add_vectors(data["vecs"][:5], data["orients"][:5])
    s_w, i_w = jax_db.query_similar(q[0], 20)
    s_g, i_g = port.query_similar(q[0], 20)
    assert len(i_g) == 5
    np.testing.assert_array_equal(i_g, i_w)
    r_w = jax_db.find_best_orientations_batch(q, top_n=20, min_required_matches=1)
    r_g = port.find_best_orientations_batch(q, top_n=20, min_required_matches=1)
    _assert_results_equal(r_g, r_w)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_round_trip(tmp_path, data, writer):
    path = str(tmp_path / "db.npz")
    meta = {"size": 128, "pc": [0.5, 0.5, 0.6], "structure": "fcc"}
    cfg = dict(npz_path=path, phase_symmetries=["432", "622"])
    if writer == "jax":
        src = TpuLatentVectorDatabase(JaxConfig(**cfg))
    else:
        src = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(**cfg), device="cpu")
    src.add_vectors(data["vecs"], data["orients"], phases=data["phases"])
    src.sim_meta = meta
    src.save()
    if writer == "jax":
        dst = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=path), device="cpu")
    else:
        dst = TpuLatentVectorDatabase(JaxConfig(npz_path=path))
    np.testing.assert_array_equal(dst._vectors, src._vectors)
    np.testing.assert_array_equal(dst._orientations, src._orientations)
    np.testing.assert_array_equal(dst._phases, src._phases)
    assert dst._has_phases and dst.config.phase_symmetries == ["432", "622"]
    assert dst.sim_meta == meta


def test_create_from_files_and_delete(tmp_path, data):
    np.save(tmp_path / "lat.npy", data["vecs"])
    np.save(tmp_path / "ang.npy", data["orients"])
    port = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=str(tmp_path / "p.npz")), device="cpu"
    )
    port.create_from_files(tmp_path / "lat.npy", tmp_path / "ang.npy")
    assert (tmp_path / "p.npz").exists() and port.get_count() == GRAINS * PER
    assert port.sim_meta is None
    port.delete_persistence()
    assert not (tmp_path / "p.npz").exists() and port.get_count() == 0
    assert isinstance(port, LatentVectorDatabaseBase)


def test_faiss_compat_matches_jax(tmp_path, data):
    jax_db = JaxFaiss(JaxFaissConfig(npz_path=str(tmp_path / "jf.npz")))
    port = FaissLatentVectorDatabase(
        FaissLatentVectorDatabaseConfig(npz_path=str(tmp_path / "pf.npz")), device="cpu"
    )
    for db in (jax_db, port):
        db.add_vectors(data["vecs"], data["orients"])
    assert port.config.angle_unit == "deg"
    kw = dict(top_n=20, orientation_threshold=3.0)
    _assert_results_equal(port.find_best_orientations_batch(data["queries"], **kw),
                          jax_db.find_best_orientations_batch(data["queries"], **kw))


def test_chroma_compat_matches_jax(tmp_path, data):
    """Radians thresholds, the closest match as best orientation, cosine
    distances, and persistence under the collection name."""
    jcfg = JaxChromaConfig(collection_name="c", dimension=D, persist_directory=str(tmp_path / "j"))
    jax_db = JaxChroma(jcfg)
    port = ChromaLatentVectorDatabase(
        ChromaConfig(collection_name="c", dimension=D, persist_directory=str(tmp_path / "p")),
        device="cpu",
    )
    for db in (jax_db, port):
        db.add_vectors(data["vecs"], data["orients"])
    assert (tmp_path / "p" / "c.npz").exists() and port.config.angle_unit == "rad"
    want = jax_db.query_similar(data["queries"][0], 6)
    got = port.query_similar(data["queries"][0], 6)
    assert got["ids"] == want["ids"] and got["metadatas"] == want["metadatas"]
    np.testing.assert_allclose(got["distances"], want["distances"], atol=1e-6)
    kw = dict(top_n=20, orientation_threshold=0.05)
    r_w = jax_db.find_best_orientations_batch(data["queries"], **kw)
    r_g = port.find_best_orientations_batch(data["queries"], **kw)
    _assert_results_equal(r_g, r_w)
    for r in r_g:
        np.testing.assert_array_equal(r.best_orientation, r.candidate_orientations[0])
    reopened = ChromaLatentVectorDatabase(
        ChromaConfig(collection_name="c", dimension=D, persist_directory=str(tmp_path / "p")),
        device="cpu",
    )
    assert reopened.get_count() == GRAINS * PER
    reopened.delete_collection()
    assert not (tmp_path / "p" / "c.npz").exists()


def test_result_top_n_orientations():
    r = OrientationResult(
        query_vector=np.zeros(2), best_orientation=np.zeros(3),
        candidate_orientations=np.arange(12.0).reshape(4, 3),
        distances=np.array([0.9, 0.2, 0.5, 0.7]),
    )
    np.testing.assert_array_equal(r.get_top_n_orientations(2), [[3, 4, 5], [6, 7, 8]])


def test_engines_of_later_slices_raise_and_device_defaults_to_cuda(tmp_path, data):
    from latice_tpu_torch import native

    # The host engine, once refused here, answers without any device (and
    # raises ImportError only where g++ cannot build it).
    cfg = LatentVectorDatabaseConfig(npz_path=str(tmp_path / "native.npz"), engine="native")
    host = TorchLatentVectorDatabase(cfg)
    host.add_vectors(data["vecs"], data["orients"])
    if native.available():
        exact = TorchLatentVectorDatabase(
            LatentVectorDatabaseConfig(npz_path=str(tmp_path / "exact.npz")), device="cpu")
        exact.add_vectors(data["vecs"], data["orients"])
        got = host.query_similar_batch(data["queries"])
        want = exact.query_similar_batch(data["queries"])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    else:
        with pytest.raises(ImportError, match="native library"):
            host.query_similar_batch(data["queries"])
    for engine in ("approx", "int8"):  # ported: accepted
        cfg = LatentVectorDatabaseConfig(npz_path=str(tmp_path / f"{engine}.npz"), engine=engine)
        assert TorchLatentVectorDatabase(cfg).config.engine == engine
    with pytest.raises(ValueError, match="unknown engine"):
        TorchLatentVectorDatabase(LatentVectorDatabaseConfig(engine="hnsw"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=str(tmp_path / "x.npz")))
    db.add_vectors(data["vecs"], data["orients"])
    db.save()  # host work needs no device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        db.query_similar(data["queries"][0])


@pytest.mark.parametrize("engine", ["device", "fused", "approx", "int8", "native"])
def test_queries_take_the_pipeline_consensus_once_a_chunk(tmp_path, data, monkeypatch, engine):
    """Every engine's consensus is `CandidateConsensus`'s call of
    `ops.candidate_consensus_fused` (K4 on the card), once a chunk, over
    tables built once for the dictionary; ``similar_indices`` is the mask
    it returns."""
    from latice_tpu_torch import native
    from latice_tpu_torch.index import db as db_module
    from latice_tpu_torch.index import pipeline as pipeline_module

    port = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=str(tmp_path / "p.npz"), engine=engine), device="cpu"
    )
    port.add_vectors(data["vecs"], data["orients"])
    if engine == "native" and not native.available():
        with pytest.raises(ImportError, match="native library"):
            port.find_best_orientations_batch(data["queries"], batch_size=16)
        return
    calls, real = [], pipeline_module.candidate_consensus_fused

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr(pipeline_module, "candidate_consensus_fused", counted)
    kw = dict(top_n=20, orientation_threshold=3.0, min_required_matches=18)
    results = port.find_best_orientations_batch(data["queries"], batch_size=16, **kw)
    assert calls == [(16, 20), (14, 20)]  # 30 queries in chunks of 16
    tables = port._stages
    dense = port.find_best_orientations_dense(data["queries"], batch_size=16, **kw)
    assert len(calls) == 4 and port._stages is tables
    assert not hasattr(db_module, "consensus_orientations")
    np.testing.assert_array_equal(dense["n_similar"], [len(r.similar_indices) for r in results])
    np.testing.assert_array_equal(dense["success"], [r.success for r in results])
