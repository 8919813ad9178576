"""Every ``mesh=`` path of the port on a mesh of four CPU entries, against
the port's one-device result, and the pipeline and pattern DI also against
latice_tpu's on a 4-device JAX mesh (the suite's virtual CPU devices).

Holds, each the JAX package's rule for its path (`dryrun_multichip`,
tests/parallel/test_parallel.py):

* `IndexPipeline` (every engine, with and without ``preprocess``): indices
  equal, scores within 1e-5; against JAX's mesh pipeline on the same
  weights, indices equal and scores within 1e-5.
* `DiffractionPatternIndexer`: latents within 1e-5, the built dictionary's
  angles equal.
* `IndexService`: ``/healthz`` reports ``mesh_devices``; ``/index`` and
  ``/encode`` equal the unsharded service's.
* Pattern DI: indices equal to the resident indexer's and to JAX's mesh DI,
  scores within 1e-5, in f32 and with the default bf16 table.
* `HoughIndexer`: the band score at least the one-device score minus 0.01
  (each grid block refines its own candidates, so the merged winner can
  only rank as well or better), orientations where the scores tie; against
  JAX's mesh `HoughIndexer`, Euler triples within 1e-3 degrees and band
  scores within 1.2e-3.
* `SphericalIndexer`, its ambiguity diagnostic and the multi-phase class:
  scores within 1e-5.
* HR-EBSD's remap, shifts and map: ``a`` within 1e-6.
* The dynamical master and the Monte Carlo: bit for bit.

Small sizes: 32x32 encoder inputs at inplanes 2, 64x64 detectors, L=8,
17-pixel masters with 15 beams, 4,096 walkers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index import IndexPipeline as JaxPipeline
from latice_tpu.index import PatternDictionaryIndexer as JaxPatternDI
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.parallel import make_mesh as jax_make_mesh
from latice_tpu_torch import hrebsd as th
from latice_tpu_torch import sim as tsim
from latice_tpu_torch.data import BandDetector, PreprocessConfig
from latice_tpu_torch.index import (
    DiffractionPatternIndexer,
    HoughIndexer,
    IndexerConfig,
    IndexPipeline,
    LatentVectorDatabaseConfig,
    MultiPhaseSphericalIndexer,
    PatternDictionaryIndexer,
    SphericalIndexer,
    SphericalIndexerConfig,
    TorchLatentVectorDatabase,
)
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.parallel import make_mesh
from latice_tpu_torch.serve import IndexService
from latice_tpu_torch.sim.dynamical import lambert_master_directions

INPLANES, LATENT, STAGES, HW, SIZE = 2, 16, 3, 4, 32
N_DICT, N_QUERY, BATCH = 96, 13, 8


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
def latent():
    """JAX weights (and the port model carrying them), a dictionary of the
    model's own latents of seeded patterns, and queries near them."""
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT, n_stages=STAGES, bottleneck_hw=HW)
    params = jax.jit(jm.init)(
        {"params": jax.random.key(0)}, jnp.zeros((1, SIZE, SIZE, 1)), jax.random.key(1)
    )["params"]
    model = VariationalAutoEncoderRawData(INPLANES, LATENT, STAGES, HW)
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params), INPLANES, LATENT, STAGES, HW))
    model.eval()
    rng = np.random.default_rng(3)
    dict_pats = rng.uniform(size=(N_DICT, SIZE, SIZE)).astype(np.float32)
    with torch.no_grad():
        mu = model.encode(torch.from_numpy(dict_pats)[:, None])[0].numpy()
    vecs = mu / np.linalg.norm(mu, axis=1, keepdims=True)
    orients = rng.uniform([0, 20, 0], [340, 140, 340], size=(N_DICT, 3))
    queries = dict_pats[:N_QUERY] + rng.normal(size=(N_QUERY, SIZE, SIZE)).astype(
        np.float32) * 0.02
    return dict(jm=jm, params=params, model=model, pats=dict_pats, vecs=vecs,
                orients=orients, queries=queries)


KW = dict(top_n=5, orientation_threshold=3.0, min_required_matches=1, batch_size=BATCH)


@pytest.mark.parametrize("engine", ["exact", "fused", "approx", "int8"])
@pytest.mark.parametrize("preprocess", [None, PreprocessConfig(dynamic_sigma=4.0, clip_sigma=4.0)],
                         ids=["raw", "preprocess"])
def test_pipeline_matches_one_device(latent, mesh, engine, preprocess):
    kw = dict(KW, engine=engine, preprocess=preprocess, device="cpu")
    one = IndexPipeline(latent["model"], latent["vecs"], latent["orients"], **kw)
    four = IndexPipeline(latent["model"], latent["vecs"], latent["orients"], mesh=mesh, **kw)
    a, b = one(latent["queries"]), four(latent["queries"])
    np.testing.assert_array_equal(b.indices, a.indices)
    np.testing.assert_allclose(b.scores, a.scores, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b.success, a.success)
    np.testing.assert_allclose(four.encode(latent["queries"]), one.encode(latent["queries"]),
                               rtol=0, atol=1e-5)
    assert len(four._replicas) == 4 and four.search.table.shape[0] % 4 == 0


def test_pipeline_matches_jax_mesh_pipeline(latent, mesh):
    jax_mesh = jax_make_mesh(4)
    want = JaxPipeline(latent["jm"], latent["params"], latent["vecs"], latent["orients"],
                       mesh=jax_mesh, **KW)(latent["queries"][..., None])
    got = IndexPipeline(latent["model"], latent["vecs"], latent["orients"], mesh=mesh,
                        device="cpu", **KW)(latent["queries"])
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.success, want.success)


def test_pipeline_mesh_checks(latent, mesh):
    with pytest.raises(ValueError, match="divide"):
        IndexPipeline(latent["model"], latent["vecs"], latent["orients"], mesh=mesh,
                      device="cpu", batch_size=6)
    with pytest.raises(ValueError, match="first device"):
        IndexPipeline(latent["model"], latent["vecs"], latent["orients"], mesh=mesh,
                      device="meta")


def test_indexer_build_matches_one_device(latent, mesh, tmp_path):
    np.save(tmp_path / "d.npy", latent["pats"][:21])
    (tmp_path / "d.txt").write_text(
        "eu\n21\n" + "".join(f"{a} {b} {c}\n" for a, b, c in latent["orients"][:21]))
    out = []
    for m in (None, mesh):
        cfg = IndexerConfig(pattern_path=tmp_path / "d.npy", angles_path=tmp_path / "d.txt",
                            batch_size=BATCH, device="cpu", latent_dim=LATENT,
                            image_size=(SIZE, SIZE))
        ix = DiffractionPatternIndexer(latent["model"], config=cfg, mesh=m)
        ix.build_dictionary()
        out.append((ix.db, ix.encode_patterns_batch(latent["queries"])))
    (db1, lat1), (db4, lat4) = out
    np.testing.assert_allclose(lat4, lat1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(db4._vectors), np.asarray(db1._vectors), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(db4._orientations), np.asarray(db1._orientations))
    with pytest.raises(ValueError, match="divide"):
        DiffractionPatternIndexer(latent["model"], config=IndexerConfig(device="cpu",
                                                                      batch_size=6), mesh=mesh)


def test_service_over_mesh(latent, mesh):
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path="/nonexistent/none.npz", dimension=LATENT),
        device="cpu")
    db.add_vectors(latent["vecs"], latent["orients"])
    kw = dict(KW, image_size=(SIZE, SIZE), device="cpu")
    one = IndexService(latent["model"], db, **kw)
    four = IndexService(latent["model"], db, mesh=mesh, **kw)
    assert four.health()["mesh_devices"] == 4 and one.health()["mesh_devices"] == 0
    a, b = one.index(latent["queries"]), four.index(latent["queries"])
    assert b["success"] == a["success"] and b["n_similar"] == a["n_similar"]
    np.testing.assert_allclose(b["orientations"], a["orientations"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(four.encode(latent["queries"])["latents"],
                               one.encode(latent["queries"])["latents"], rtol=0, atol=1e-5)


def test_pattern_di_matches_resident_and_jax(latent, mesh):
    rng = np.random.default_rng(5)
    pats, angles = latent["pats"][:64], latent["orients"][:64]
    queries = pats[:BATCH + 3] + rng.normal(size=(BATCH + 3, SIZE, SIZE)).astype(np.float32) * 0.05
    kw = dict(top_n=3, min_required_matches=1, batch_size=BATCH, search_dtype="float32")
    one = PatternDictionaryIndexer(pats, angles, device="cpu", **kw)(queries)
    four = PatternDictionaryIndexer(pats, angles, mesh=mesh, device="cpu", **kw)(queries)
    np.testing.assert_array_equal(four.indices, one.indices)
    np.testing.assert_allclose(four.scores, one.scores, rtol=0, atol=1e-5)
    want = JaxPatternDI(pats, angles, mesh=jax_make_mesh(4), **kw)(queries)
    np.testing.assert_array_equal(four.indices, want.indices)
    np.testing.assert_allclose(four.scores, want.scores, rtol=0, atol=1e-5)


def test_pattern_di_bf16_matches_jax_mesh(latent, mesh):
    """The default ``search_dtype="bfloat16"``: each bf16 shard multiplied
    by the f32 query features, as JAX's mesh DI does. Both indexers take
    JAX's bf16 feature rows: the two builds' f32 features are one ulp apart
    in places, which flips a few bf16 roundings of the table (38 of 65,536
    here, scores 1.1e-5 apart) and would hide what this holds."""
    from latice_tpu.index.pattern_di import build_pattern_dictionary as jax_build

    rng = np.random.default_rng(6)
    pats, angles = latent["pats"][:64], latent["orients"][:64]
    rows = np.asarray(jax_build(pats, dtype=jnp.bfloat16)).astype(np.float32)
    queries = pats[:BATCH + 3] + rng.normal(size=(BATCH + 3, SIZE, SIZE)).astype(np.float32) * 0.05
    kw = dict(top_n=5, min_required_matches=1, batch_size=BATCH)
    four = PatternDictionaryIndexer(rows, angles, mesh=mesh, device="cpu", **kw)(queries)
    want = JaxPatternDI(rows, angles, mesh=jax_make_mesh(4), **kw)(queries)
    np.testing.assert_array_equal(four.indices, want.indices)
    np.testing.assert_allclose(four.scores, want.scores, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def band_patterns():
    from scipy.spatial.transform import Rotation as R

    q = np.roll(R.random(12, random_state=4).as_quat(), 1, axis=1)
    geom = tsim.DetectorGeometry(shape=(64, 64))
    return geom, tsim.simulate_patterns(q, geom, device="cpu")


def test_hough_over_mesh(band_patterns, mesh):
    geom, pats = band_patterns
    det = BandDetector(height=64, width=64, n_theta=90, n_rho=64, k=8, band_width_px=5.0,
                       batch_size=8, device="cpu")
    kw = dict(grid_resolution_deg=6.0, n_bands=8, tolerance_deg=4.0, batch_size=8,
              grid_chunk=128, detector=det)
    one = HoughIndexer(tsim.cubic_reflectors(), geom, device="cpu", **kw)(pats)
    ix = HoughIndexer(tsim.cubic_reflectors(), geom, mesh=mesh, **kw)
    four = ix(pats)
    assert len(ix._blocks) == 4 and ix._grid_q.shape[0] % (4 * 128) == 0
    assert (four.band_score >= one.band_score - 0.01).all()
    tie = np.abs(four.band_score - one.band_score) < 1e-5
    assert tie.mean() > 0.5
    np.testing.assert_allclose(four.eulers_deg[tie], one.eulers_deg[tie], atol=1e-3)


def test_hough_over_mesh_matches_jax_mesh(band_patterns, mesh):
    """The same 12 patterns through JAX's mesh `HoughIndexer` on 4 devices:
    Euler triples within 1e-3 degrees, band scores within 1.2e-3 (the bf16
    Radon product's rounding; 1.14e-3 measured)."""
    from latice_tpu.data.hough import BandDetector as JaxDetector
    from latice_tpu.index import HoughIndexer as JaxHough
    from latice_tpu.sim import DetectorGeometry as JaxGeometry
    from latice_tpu.sim import cubic_reflectors as jax_cubic_reflectors

    geom, pats = band_patterns
    det_kw = dict(height=64, width=64, n_theta=90, n_rho=64, k=8, band_width_px=5.0,
                  batch_size=8)
    kw = dict(grid_resolution_deg=6.0, n_bands=8, tolerance_deg=4.0, batch_size=8,
              grid_chunk=128)
    four = HoughIndexer(tsim.cubic_reflectors(), geom, mesh=mesh,
                        detector=BandDetector(device="cpu", **det_kw), **kw)(pats)
    jax_ix = JaxHough(jax_cubic_reflectors(), JaxGeometry(shape=(64, 64)), mesh=jax_make_mesh(4),
                      detector=JaxDetector(**det_kw), **kw)
    # The JAX mesh solve is a `shard_map` run op by op unless jitted (~80 s
    # for these 12 patterns on the CPU); jitted it is the same program.
    jax_ix._solve = jax.jit(jax_ix._solve)
    want = jax_ix(pats)
    np.testing.assert_allclose(four.eulers_deg, np.asarray(want.eulers_deg), rtol=0, atol=1e-3)
    np.testing.assert_allclose(four.band_score, np.asarray(want.band_score), rtol=0, atol=1.2e-3)


@pytest.fixture(scope="module")
def sphere_setup():
    from scipy.spatial.transform import Rotation as R

    master = tsim.make_kinematical_master(size=129)
    geom = tsim.DetectorGeometry(shape=(64, 64))
    q = np.roll(R.random(10, random_state=6).as_quat(), 1, axis=1)
    pats = tsim.render_from_master(master, q, geom, device="cpu")
    cfg = SphericalIndexerConfig(bandwidth=8, chunk=8, detector_bin=2)
    tables = __import__("latice_tpu_torch.index.spherical", fromlist=["x"]).projection_tables(
        8, geom, 2)
    return master, geom, pats, cfg, tables


@pytest.mark.parametrize("refine", ["newton", "parabolic", False])
def test_spherical_over_mesh(sphere_setup, mesh, refine):
    master, geom, pats, cfg, tables = sphere_setup
    cfg = dataclasses.replace(cfg, refine=refine)
    one = SphericalIndexer(master, geom, cfg, tables=tables, device="cpu")
    four = SphericalIndexer(master, geom, cfg, mesh=mesh, tables=tables)
    a, b = one.index_patterns(pats), four.index_patterns(pats)
    np.testing.assert_allclose(b.scores, a.scores, rtol=0, atol=1e-5)
    if refine is False:
        amb_a, amb_b = one.ambiguity(pats, n_cells=8), four.ambiguity(pats, n_cells=8)
        np.testing.assert_allclose(amb_b.score_gap, amb_a.score_gap, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(amb_b.has_rival, amb_a.has_rival)


def test_multiphase_spherical_over_mesh(sphere_setup, mesh):
    master, geom, pats, cfg, tables = sphere_setup
    masters = [master, master[::-1].copy()]
    one = MultiPhaseSphericalIndexer(masters, geom, cfg, tables=tables, device="cpu")
    four = MultiPhaseSphericalIndexer(masters, geom, cfg, mesh=mesh, tables=tables)
    a, b = one.index_patterns(pats), four.index_patterns(pats)
    np.testing.assert_allclose(b.phase_scores, a.phase_scores, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b.phase, a.phase)
    with pytest.raises(ValueError, match="chunk=6 must divide"):
        SphericalIndexer(master, geom, dataclasses.replace(cfg, chunk=6), mesh=mesh,
                         tables=tables)


@pytest.fixture(scope="module")
def strain_scan():
    """A reference and 10 targets remapped through small seeded
    deformations (64x64 detector, 32x32 ROIs)."""
    geom = tsim.DetectorGeometry(shape=(64, 64))
    ref = tsim.simulate_patterns(np.array([[1.0, 0.1, 0.2, 0.05]]) / 1.0259, geom,
                                 device="cpu")[0]
    a = np.random.default_rng(7).normal(scale=2e-3, size=(10, 3, 3))
    targets = th.remap_patterns(np.repeat(ref[None], 10, axis=0), -a, geom, chunk=2,
                                device="cpu")
    return geom, ref, targets, a


def test_hrebsd_over_mesh(strain_scan, mesh):
    geom, ref, targets, a = strain_scan
    centers = th.default_roi_centers(geom, roi_size=32)
    np.testing.assert_allclose(
        th.remap_patterns(targets, a, geom, chunk=4, mesh=mesh),
        th.remap_patterns(targets, a, geom, chunk=4, device="cpu"), rtol=0, atol=1e-6)
    s4, q4 = th.measure_roi_shifts(ref, targets, centers, roi_size=32, chunk=4, mesh=mesh,
                                   deformation=a, geometry=geom)
    s1, q1 = th.measure_roi_shifts(ref, targets, centers, roi_size=32, chunk=4, device="cpu",
                                   deformation=a, geometry=geom)
    np.testing.assert_allclose(s4, s1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(q4, q1, rtol=0, atol=1e-6)
    kw = dict(roi_size=32, chunk=4, remap_iterations=1)
    four = th.hrebsd_map(targets, ref, geom, mesh=mesh, **kw)
    one = th.hrebsd_map(targets, ref, geom, device="cpu", **kw)
    np.testing.assert_allclose(four.a, one.a, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="chunk=6 must divide"):
        th.remap_patterns(targets, a, geom, chunk=6, mesh=mesh)


def test_dynamical_master_over_mesh(mesh):
    structure = tsim.cubic_structure()
    beams = tsim.dynamical_beams(structure, n_beams=15, max_hkl=2)
    kw = dict(size=17, beams=beams, chunk=64)
    one = tsim.dynamical_master_pattern(structure, device="cpu", **kw)
    four = tsim.dynamical_master_pattern(structure, mesh=mesh, **kw)
    np.testing.assert_array_equal(four, one)
    mesh2 = make_mesh(devices=["cpu"] * 2)
    d = lambert_master_directions(9)
    np.testing.assert_array_equal(
        tsim.channeling_intensities(d, beams, chunk=16, mesh=mesh2,
                                    depth_centers_nm=np.array([10.0, 30.0]),
                                    depth_weights=np.array([0.7, 0.3])),
        tsim.channeling_intensities(d, beams, chunk=16, device="cpu",
                                    depth_centers_nm=np.array([10.0, 30.0]),
                                    depth_weights=np.array([0.7, 0.3])))


def test_monte_carlo_over_mesh(mesh):
    structure = tsim.cubic_structure()
    kw = dict(n_electrons=4096 + 100, n_steps=40, chunk=1024, seed=3)
    one = tsim.simulate_bse_monte_carlo(structure, device="cpu", **kw)
    four = tsim.simulate_bse_monte_carlo(structure, mesh=mesh, **kw)
    np.testing.assert_array_equal(four.exit_energy_kev, one.exit_energy_kev)
    np.testing.assert_array_equal(four.max_depth_nm, one.max_depth_nm)
    np.testing.assert_array_equal(four.depth_weights, one.depth_weights)
    beams_kw = dict(size=9, n_beams=15, max_hkl=2, chunk=32)
    np.testing.assert_array_equal(
        tsim.mc_weighted_master_pattern(structure, one, mesh=mesh, **beams_kw),
        tsim.mc_weighted_master_pattern(structure, one, device="cpu", **beams_kw))
