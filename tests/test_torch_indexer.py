"""The port's DiffractionPatternIndexer against latice_tpu's, in float32.

Same weights (JAX ``init`` carried across by `flax_params_to_state_dict`),
the same ``.npy`` pattern stack and angle file. Latents within 1e-4, the
repo's torch-parity tolerance; dictionary builds (single- and multi-phase)
give the same database; batch indexing the same candidates and results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index import DiffractionPatternIndexer as JaxIndexer
from latice_tpu.index import IndexerConfig as JaxIndexerConfig
from latice_tpu.index import LatentVectorDatabaseConfig as JaxDBConfig
from latice_tpu.index import TpuLatentVectorDatabase
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu_torch.index import (
    DiffractionPatternIndexer,
    IndexerConfig,
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
)
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict

INPLANES, LATENT, N = 2, 8, 20


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("indexer")
    rng = np.random.default_rng(0)
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(1)
    )["params"]
    tm = VariationalAutoEncoderRawData(INPLANES, LATENT)
    tm.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), INPLANES,
                                                 LATENT))
    paths = []
    for phase in range(2):
        pats = rng.uniform(size=(N, 128, 128)).astype(np.float32)
        angles = rng.uniform([0, 20, 0], [340, 140, 340], size=(N, 3))
        p, a = tmp / f"p{phase}.npy", tmp / f"a{phase}.txt"
        np.save(p, pats)
        a.write_text(f"eu\n{N}\n" + "".join(f"{x[0]} {x[1]} {x[2]}\n" for x in angles))
        paths.append((str(p), str(a)))
    return dict(jm=jm, params=params, tm=tm, paths=paths, tmp=tmp)


def _indexers(setup, phase_symmetries=None):
    p, a = setup["paths"][0]
    kw = dict(pattern_path=p, angles_path=a, batch_size=8, latent_dim=LATENT)
    jax_db = TpuLatentVectorDatabase(
        JaxDBConfig(npz_path=str(setup["tmp"] / "none_j.npz"), dimension=LATENT,
                    phase_symmetries=phase_symmetries)
    )
    port_db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=str(setup["tmp"] / "none_p.npz"), dimension=LATENT,
                                   phase_symmetries=phase_symmetries),
        device="cpu",
    )
    jax_ix = JaxIndexer(setup["jm"], setup["params"], db=jax_db, config=JaxIndexerConfig(**kw))
    port_ix = DiffractionPatternIndexer(setup["tm"], db=port_db,
                                        config=IndexerConfig(device="cpu", **kw))
    return jax_ix, port_ix


def test_encode_matches_jax(setup):
    jax_ix, port_ix = _indexers(setup)
    pats = np.load(setup["paths"][1][0])[:11]  # not a multiple of the batch
    np.testing.assert_allclose(port_ix.encode_patterns_batch(pats),
                               jax_ix.encode_patterns_batch(pats), atol=1e-4)
    np.testing.assert_allclose(port_ix.encode_pattern(pats[0]), jax_ix.encode_pattern(pats[0]),
                               atol=1e-4)
    np.testing.assert_allclose(port_ix.encode_pattern(pats[0][..., None]),
                               port_ix.encode_pattern(pats[0]), atol=0)


def test_build_export_and_index_match_jax(setup, tmp_path):
    jax_ix, port_ix = _indexers(setup)
    jax_ix.build_dictionary(progress=False)
    port_ix.build_dictionary(progress=False)
    np.testing.assert_allclose(port_ix.db._vectors, jax_ix.db._vectors, atol=1e-4)
    np.testing.assert_array_equal(port_ix.db._orientations, jax_ix.db._orientations)

    lat, ang = port_ix.export_latents(tmp_path / "l.npy", tmp_path / "o.npy")
    jlat, jang = jax_ix.export_latents(progress=False)
    np.testing.assert_allclose(lat, jlat, atol=1e-4)
    np.testing.assert_array_equal(np.load(tmp_path / "o.npy"), jang)
    np.testing.assert_array_equal(np.load(tmp_path / "l.npy"), lat)

    queries = np.load(setup["paths"][0][0])[:6]  # the dictionary's own patterns
    kw = dict(top_n=5, min_required_matches=1)
    want = jax_ix.index_patterns_batch(queries, **kw)
    got = port_ix.index_patterns_batch(queries, **kw)
    for g, w in zip(got, want):
        assert g.success == w.success
        np.testing.assert_allclose(g.distances, w.distances, atol=1e-4)
        np.testing.assert_array_equal(g.candidate_orientations[0], w.candidate_orientations[0])
        np.testing.assert_allclose(g.best_orientation, w.best_orientation, atol=1e-3)
    one = port_ix.index_pattern(queries[2], top_n=5)
    np.testing.assert_array_equal(one.candidate_orientations, got[2].candidate_orientations)


def test_multiphase_build_matches_jax(setup):
    jax_ix, port_ix = _indexers(setup, phase_symmetries=["432", "622"])
    jax_ix.build_multiphase_dictionary(setup["paths"], progress=False)
    port_ix.build_multiphase_dictionary(setup["paths"], progress=False)
    np.testing.assert_array_equal(port_ix.db._phases, jax_ix.db._phases)
    np.testing.assert_array_equal(port_ix.db._phases, np.repeat([0, 1], N))
    np.testing.assert_allclose(port_ix.db._vectors, jax_ix.db._vectors, atol=1e-4)


def test_timer_and_refusals(setup):
    phases = []

    class Timer:
        def phase(self, name):
            phases.append(name)
            return torch.autograd.profiler.record_function(name)

    _, port_ix = _indexers(setup)
    port_ix.timer = Timer()
    port_ix.db.add_vectors(np.eye(LATENT, dtype=np.float32), np.zeros((LATENT, 3)))
    port_ix.index_pattern(np.load(setup["paths"][0][0])[0])
    assert phases == ["encode", "search"]
    # mesh= takes a parallel.Mesh (tests/test_torch_parallel_paths.py runs it).
    with pytest.raises(TypeError, match="Mesh"):
        DiffractionPatternIndexer(setup["tm"], config=IndexerConfig(device="cpu"), mesh=object())
    with pytest.raises(ValueError, match="must be configured"):
        port_ix._make_datamodule(None, None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffractionPatternIndexer(setup["tm"])
