"""The port's main path end to end against the reference's semantics.

* The port's f32 `IndexPipeline` on the CPU against
  ``reference_find_best_orientation`` (a literal numpy/scipy port of the
  reference consensus, loaded from ``tests/index/test_e2e_torch_parity.py``)
  fed by the reference architecture in torch with the same weights: the
  same candidate set and success, mean orientations within 1e-4°.
* The port's Chroma and FAISS compatibility classes on the reference's
  golden scenario (``tests/index/test_compat_backends.py``).

Every weight is a seeded numpy draw loaded into the model; nothing here
reads torch's global RNG.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.crystal.symmetry import CUBIC_SYMMETRY
from latice_tpu_torch.index import IndexPipeline
from latice_tpu_torch.index.chroma_db import ChromaLatentVectorDatabase
from latice_tpu_torch.index.chroma_db import LatentVectorDatabaseConfig as ChromaConfig
from latice_tpu_torch.index.faiss_db import (
    FaissLatentVectorDatabase,
    FaissLatentVectorDatabaseConfig,
)
from latice_tpu_torch.models import VariationalAutoEncoderRawData

TESTS = Path(__file__).resolve().parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_e2e = _load("_e2e_torch_parity", TESTS / "index" / "test_e2e_torch_parity.py")
reference_find_best_orientation = _e2e.reference_find_best_orientation
build_reference_torch_model = _e2e.build_reference_torch_model
QUAT_SYM = R.from_quat(np.asarray(CUBIC_SYMMETRY))

INPLANES, LATENT = 8, 16
KW = dict(top_n=20, orientation_threshold=3.0, min_required_matches=18, max_iterations=3)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Building a torch module draws from the global RNG (its weights are
    then overwritten here); leave that RNG as this module found it, so that
    tests in other files which build models unseeded see the same state."""
    with torch.random.fork_rng(devices=[]):
        yield


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """A state dict for ``model`` drawn from ``numpy.random.default_rng(seed)``:
    every weight and bias uniform in ±1/sqrt(fan_in) of its layer, torch's
    default bounds."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            fan_in, _ = torch.nn.init._calculate_fan_in_and_fan_out(module.weight)
            bound = fan_in**-0.5
            for leaf in ("weight", "bias"):
                shape = getattr(module, leaf).shape
                out[f"{name}.{leaf}"] = torch.from_numpy(
                    rng.uniform(-bound, bound, size=shape).astype(np.float32)
                )
    return out


@pytest.fixture(scope="module", params=[0, 1, 2], ids=lambda s: f"weights{s}")
def plane(request):
    """The reference-architecture torch model and the port's model with the
    same seeded weights, and the e2e test's dictionary: 20 near-duplicates
    of a base pattern oriented within 0.5° of [30, 45, 60] (two of them
    expressed through a cubic symmetry operator, which the reference's raw
    misorientation check excludes), 40 noise patterns, and 6 noisy queries
    of the base."""
    ref = build_reference_torch_model(INPLANES, LATENT).eval()
    sd = seeded_state_dict(ref, request.param)
    ref.load_state_dict(sd)
    port = VariationalAutoEncoderRawData(INPLANES, LATENT)
    port.load_state_dict(sd)  # the reference layout loads unchanged

    rng = np.random.default_rng(42)
    base = rng.uniform(size=(128, 128)).astype(np.float32)
    cluster = base + rng.normal(size=(20, 128, 128)).astype(np.float32) * 0.005
    cluster_orients = np.array([30.0, 45.0, 60.0]) + rng.uniform(-0.5, 0.5, size=(20, 3))
    for i in range(2):
        rot = R.from_euler("zxz", cluster_orients[i], degrees=True)
        cluster_orients[i] = (QUAT_SYM[7] * rot).as_euler("zxz", degrees=True)
    noise = rng.uniform(size=(40, 128, 128)).astype(np.float32)
    orientations = np.concatenate(
        [cluster_orients, rng.uniform([0, 20, 0], [340, 160, 340], size=(40, 3))]
    )
    patterns = np.concatenate([cluster, noise])
    queries = (base + rng.normal(size=(6, 128, 128)).astype(np.float32) * 0.01).astype(np.float32)
    with torch.no_grad():
        def encode(x):
            return ref.mu(ref.encoder(torch.from_numpy(x[:, None])).flatten(1)).numpy()

        dict_latents, query_latents = encode(patterns), encode(queries)
    return dict(port=port, orientations=orientations, queries=queries,
                dict_latents=dict_latents, query_latents=query_latents)


def _mis_deg(a, b):
    return np.degrees(
        (R.from_euler("zxz", a, degrees=True).inv() * R.from_euler("zxz", b, degrees=True))
        .magnitude()
    )


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_pipeline_matches_reference_consensus(plane, dtype):
    queries = plane["queries"]
    if dtype == "uint8":
        queries = np.round(np.clip(queries, 0, 1) * 255).astype(np.uint8)
        with torch.no_grad():
            q_lat = plane["port"].encode(torch.from_numpy(queries[:, None]).float() / 255.0)[0]
        query_latents = q_lat.numpy()
    else:
        query_latents = plane["query_latents"]
    dict_n = plane["dict_latents"] / np.linalg.norm(plane["dict_latents"], axis=1, keepdims=True)
    pipe = IndexPipeline(plane["port"], dict_n, plane["orientations"], batch_size=8,
                         device="cpu", **KW)
    got = pipe(queries)
    assert pipe.model.compute_dtype == torch.float32
    for b in range(len(queries)):
        success, mean, indices = reference_find_best_orientation(
            query_latents[b], plane["dict_latents"], plane["orientations"], **KW
        )
        assert success, "the reference consensus succeeds in this setup"
        assert bool(got.success[b])
        assert set(got.indices[b].tolist()) == set(indices.tolist())
        assert _mis_deg(got.mean_orientation[b], mean) < 1e-4, (got.mean_orientation[b], mean)


def test_port_latents_match_reference_model(plane):
    """The port's f32 encoder is the reference's with the same weights."""
    with torch.no_grad():
        mu = plane["port"].eval().encode(torch.from_numpy(plane["queries"][:, None]))[0]
    np.testing.assert_allclose(mu.numpy(), plane["query_latents"], atol=1e-4)


# -- compatibility backends on the golden scenario -----------------------------------

# The reference golden-test orientations (its test_chroma_db.py:317-327).
GOLDEN = np.array(
    [
        [30.0, 45.0, 60.0],
        [32.0, 44.0, 61.0],
        [31.0, 46.0, 59.0],
        [29.0, 45.0, 58.0],
        [28.0, 43.0, 62.0],
        [90.0, 90.0, 90.0],
    ]
)


def _golden(db):
    """Six entries that rank in GOLDEN's order for a query of ones."""
    base = np.ones(16)
    db.add_vectors(np.stack([base + i * 0.05 * np.arange(16) for i in range(6)]), GOLDEN)
    return db, base


def _chroma(tmp_path):
    return _golden(ChromaLatentVectorDatabase(
        ChromaConfig(persist_directory=str(tmp_path / "store")), device="cpu"))


def _faiss(tmp_path):
    return _golden(FaissLatentVectorDatabase(
        FaissLatentVectorDatabaseConfig(npz_path=str(tmp_path / "f.npz")), device="cpu"))


def test_chroma_golden_find_best_orientation(tmp_path):
    """Radians threshold: success with the mean near [30, 45, 60] and the
    closest match as best orientation; then the failure mode."""
    db, q = _chroma(tmp_path)
    result = db.find_best_orientation(q, top_n=6, orientation_threshold=0.3,
                                      min_required_matches=3, max_iterations=2)
    assert result.success is True
    assert result.candidate_orientations.shape == (6, 3)
    mean = result.mean_orientation
    assert 25 < mean[0] < 35 and 40 < mean[1] < 50 and 55 < mean[2] < 65
    np.testing.assert_array_equal(result.best_orientation, result.candidate_orientations[0])
    np.testing.assert_array_equal(result.candidate_orientations, GOLDEN)

    failure = db.find_best_orientation(q, top_n=6, orientation_threshold=0.01,
                                       min_required_matches=5, max_iterations=2)
    assert failure.success is False and failure.mean_orientation is None
    assert failure.candidate_orientations.shape == (6, 3)


def test_chroma_golden_query_and_persistence(tmp_path):
    db, q = _chroma(tmp_path)
    results = db.query_similar(q, n_results=4)
    assert set(results) == {"ids", "distances", "metadatas"}
    assert len(results["metadatas"][0]) == 4
    assert {"orientation_str", "phi1", "Phi", "phi2"} <= set(results["metadatas"][0][0])
    d = results["distances"][0]
    assert d == sorted(d) and d[0] >= 0
    with pytest.raises(ValueError, match="Expected query vector of dimension"):
        db.query_similar(np.ones(8))
    assert (tmp_path / "store" / "latent_vectors.npz").exists()
    assert ChromaLatentVectorDatabase(
        ChromaConfig(persist_directory=str(tmp_path / "store")), device="cpu").get_count() == 6


def test_faiss_golden_degree_thresholds(tmp_path):
    db, q = _faiss(tmp_path)
    sims, idx = db.query_similar(q, n_results=3)
    assert idx[0] == 0 and sims[0] == max(sims)
    result = db.find_best_orientation(q, top_n=6, orientation_threshold=5.0,
                                      min_required_matches=3, max_iterations=2)
    assert result.success
    np.testing.assert_array_equal(result.best_orientation, result.mean_orientation)
    tight = db.find_best_orientation(q, top_n=6, orientation_threshold=0.3,
                                     min_required_matches=3, max_iterations=2)
    assert not tight.success


def test_golden_means_match_reference_consensus(tmp_path):
    """Both backends' golden means against the literal reference consensus
    on the same vectors (degrees for FAISS; radians, the chroma backend's
    unit, for Chroma)."""
    vecs = np.stack([np.ones(16) + i * 0.05 * np.arange(16) for i in range(6)])
    for make, threshold, ref_threshold in ((_faiss, 5.0, 5.0),
                                           (_chroma, 0.3, np.degrees(0.3))):
        db, q = make(tmp_path / make.__name__)
        res = db.find_best_orientation(q, top_n=6, orientation_threshold=threshold,
                                       min_required_matches=3, max_iterations=2)
        success, mean, indices = reference_find_best_orientation(
            q, vecs, GOLDEN, top_n=6, orientation_threshold=ref_threshold,
            min_required_matches=3, max_iterations=2)
        assert success and res.success
        assert _mis_deg(res.mean_orientation, mean) < 1e-4
