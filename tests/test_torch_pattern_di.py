"""The port's pattern-space dictionary indexing against latice_tpu's, on the
CPU, over a kinematical dictionary (the JAX renderer's fcc patterns at
32x32 on a 6-degree grid of the cubic fundamental zone) and noisy rendered
queries:

* NCC features and dictionary rows within 1e-6 of JAX's, binned or not,
  uint8 or float;
* the resident indexer's indices equal to JAX's except where two candidate
  scores lie within 1e-6 (a near tie), and mean orientations within 1e-4
  degrees;
* uint8 queries index as their float /255; a bf16 table gives JAX's bf16
  top-1 and the f32 top-1; int8 and approx keep a recall@10 of 0.9 or more
  against exact (the engines' own bound, tests/test_torch_knn_engines.py);
  a dictionary preprocess matches JAX's;
* the streamed indexer equals the resident one over the same rows,
  multi-phase and consensus weights included (bitwise in one chunk; within
  roundoff over chunks of 256 rows); the fused engine is refused.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.crystal import sample_fundamental_zone
from latice_tpu.data import PreprocessConfig as JaxPreprocessConfig
from latice_tpu.index import pattern_di as jdi
from latice_tpu.sim import DetectorGeometry, cubic_reflectors, simulate_patterns
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.data import PreprocessConfig
from latice_tpu_torch.index import pattern_di as tdi

FEATURE_ATOL = 1e-6
NEAR_TIE = 1e-6
ORIENT_DEG = 1e-4
KNOBS = dict(top_n=10, orientation_threshold=8.0, min_required_matches=3, batch_size=16)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def plane():
    rng = np.random.default_rng(0)
    geom = DetectorGeometry(shape=(32, 32))
    refl = cubic_reflectors("fcc", max_hkl=2, min_d=1.0)
    quats = sample_fundamental_zone("432", 6.0)
    angles = R.from_quat(np.roll(quats, -1, axis=1)).as_euler("zxz", degrees=True)
    dictionary = simulate_patterns(angles, geom, refl, angles_in_degrees=True)
    truth = rng.normal(size=(40, 4)).astype(np.float32)
    queries = simulate_patterns(truth / np.linalg.norm(truth, axis=1, keepdims=True), geom, refl)
    queries = queries + rng.normal(size=queries.shape).astype(np.float32) * 0.05
    return dict(dictionary=dictionary, angles=angles, queries=queries.astype(np.float32))


def _mis_deg(a, b):
    qa, qb = (from_euler_zxz_deg(torch.from_numpy(np.asarray(x, np.float64))) for x in (a, b))
    return np.rad2deg(misorientation_angle(qa, qb).numpy())


def _tied(scores):
    """Rows with two candidate scores within `NEAR_TIE` (their order is
    roundoff's)."""
    return (np.abs(np.diff(scores, axis=1)) < NEAR_TIE).any(axis=1)


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


def _same_result(got, want):
    """Indices equal except on near-tied rows; success equal and the mean
    orientations within `ORIENT_DEG` wherever the candidates are equal."""
    same = (got.indices == want.indices).all(axis=1)
    assert (same | _tied(want.scores)).all()
    assert same.mean() > 0.9
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    np.testing.assert_array_equal(got.success[same], want.success[same])
    ok = same & want.success
    assert ok.sum() >= 10
    assert _mis_deg(got.mean_orientation[ok], want.mean_orientation[ok]).max() < ORIENT_DEG


@pytest.mark.parametrize("bin_factor", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_features_and_rows_match_jax(plane, bin_factor, dtype):
    x = plane["queries"]
    if dtype == "uint8":
        x = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    xf = x.astype(np.float32)
    got = tdi.ncc_feature_fn(bin_factor)(torch.from_numpy(xf)).numpy()
    want = np.asarray(jdi.ncc_feature_fn(bin_factor)(xf[..., None]))
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL)
    rows = tdi.build_pattern_dictionary(x, bin_factor, batch_size=16, device="cpu")
    want_rows = jdi.build_pattern_dictionary(x, bin_factor, batch_size=16)
    assert rows.shape == want_rows.shape == (len(x), 1024 // bin_factor**2)
    np.testing.assert_allclose(rows, want_rows, atol=FEATURE_ATOL)
    with pytest.raises(ValueError, match="does not divide"):
        tdi.ncc_feature_fn(5)(torch.from_numpy(xf))


@pytest.mark.parametrize("bin_factor", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_resident_matches_jax(plane, bin_factor, dtype):
    d, q = plane["dictionary"], plane["queries"]
    if dtype == "uint8":
        d, q = (np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8) for a in (d, q))
    kw = dict(KNOBS, bin_factor=bin_factor, search_dtype="float32")
    want = jdi.PatternDictionaryIndexer(d, plane["angles"], **kw)(q)
    got = tdi.PatternDictionaryIndexer(d, plane["angles"], device="cpu", **kw)(q)
    _same_result(got, want)


def test_uint8_queries_index_as_float(plane):
    di = tdi.PatternDictionaryIndexer(plane["dictionary"], plane["angles"], device="cpu",
                                      search_dtype="float32", **KNOBS)
    u8 = np.clip(np.round(plane["queries"] * 255.0), 0, 255).astype(np.uint8)
    a, b = di(u8), di(u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(a.indices[~_tied(b.scores)], b.indices[~_tied(b.scores)])
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)


def test_bf16_table(plane):
    d, a, q = plane["dictionary"], plane["angles"], plane["queries"]
    port = tdi.PatternDictionaryIndexer(d, a, device="cpu", **KNOBS)  # bf16 is the default
    assert port.pipeline.search.table.dtype == torch.bfloat16
    got = port(q)
    want = jdi.PatternDictionaryIndexer(d, a, **KNOBS)(q)
    f32 = tdi.PatternDictionaryIndexer(d, a, device="cpu", search_dtype="float32", **KNOBS)(q)
    np.testing.assert_array_equal(got.indices[:, 0], want.indices[:, 0])
    np.testing.assert_array_equal(got.indices[:, 0], f32.indices[:, 0])
    np.testing.assert_allclose(got.scores, want.scores, atol=2e-3)
    # Precomputed bf16 rows (a CPU tensor, numpy has no bf16) index the same.
    rows = tdi.build_pattern_dictionary(d, dtype=torch.bfloat16, device="cpu")
    assert isinstance(rows, torch.Tensor) and rows.dtype == torch.bfloat16
    pre = tdi.PatternDictionaryIndexer(rows, a, device="cpu", **KNOBS)(q)
    np.testing.assert_array_equal(pre.indices, got.indices)


@pytest.mark.parametrize("engine", ["int8", "approx"])
def test_int8_and_approx_recall(plane, engine):
    d, a, q = plane["dictionary"], plane["angles"], plane["queries"]
    exact = tdi.PatternDictionaryIndexer(d, a, device="cpu", search_dtype="float32", **KNOBS)(q)
    got = tdi.PatternDictionaryIndexer(d, a, device="cpu", engine=engine, search_dtype="float32",
                                       **KNOBS)(q)
    want = jdi.PatternDictionaryIndexer(d, a, engine=engine, search_dtype="float32", **KNOBS)(q)
    assert _recall(got.indices, exact.indices) >= 0.9
    assert _recall(got.indices, want.indices) >= 0.9


def test_dictionary_preprocess_matches_jax(plane):
    d, a, q = plane["dictionary"], plane["angles"], plane["queries"]
    spec = dict(hot_pixel_threshold=5.0, dynamic_sigma=4.0)
    want = jdi.PatternDictionaryIndexer(
        d, a, search_dtype="float32", preprocess=JaxPreprocessConfig(**spec),
        dict_preprocess=JaxPreprocessConfig(**spec), **KNOBS)(q)
    got = tdi.PatternDictionaryIndexer(
        d, a, search_dtype="float32", preprocess=PreprocessConfig(**spec),
        dict_preprocess=PreprocessConfig(**spec), device="cpu", **KNOBS)(q)
    _same_result(got, want)


@pytest.mark.parametrize(
    "kw",
    [dict(search_dtype="float32"), dict(search_dtype="bfloat16"),
     dict(search_dtype="float32", phases=True, consensus_weight_power=4.0),
     dict(search_dtype="float32", phases=True, consensus_weight_power=4.0, chunk_rows=256)],
    ids=["f32", "bf16", "multiphase-weighted", "multiphase-weighted-chunked"],
)
def test_streamed_equals_resident(plane, kw):
    d, a, q = plane["dictionary"], plane["angles"], plane["queries"]
    kw = dict(kw)
    dtype = torch.bfloat16 if kw.pop("search_dtype") == "bfloat16" else torch.float32
    if kw.pop("phases", False):
        kw.update(dictionary_phases=np.random.default_rng(1).integers(0, 2, len(d)),
                  phase_symmetries=["432", "622"])
    rows = tdi.build_pattern_dictionary(d, dtype=dtype, device="cpu")
    chunk_rows = kw.pop("chunk_rows", 131072)
    resident = tdi.PatternDictionaryIndexer(
        rows, a, device="cpu",
        search_dtype="bfloat16" if dtype == torch.bfloat16 else "float32", **KNOBS, **kw)(q)
    streamed = tdi.StreamedPatternDI(rows, a, device="cpu", chunk_rows=chunk_rows, **KNOBS,
                                     **kw)(q)
    if chunk_rows < len(d):
        # Chunks are products of other shapes, whose sums the CPU orders
        # otherwise: equal within roundoff.
        _same_result(streamed, resident)
        return
    for field in resident._fields:
        got, want = getattr(streamed, field), getattr(resident, field)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)
    if "dictionary_phases" in kw:
        assert set(np.unique(resident.phase)) == {0, 1}


def test_refusals(plane):
    d, a = plane["dictionary"], plane["angles"]
    with pytest.raises(ValueError, match="fused engine"):
        tdi.PatternDictionaryIndexer(d, a, engine="fused", device="cpu")
    with pytest.raises(ValueError, match=r"\(N, D\) feature rows"):
        tdi.StreamedPatternDI(d, a, device="cpu")
    with pytest.raises(ValueError, match="rows vs"):
        tdi.StreamedPatternDI(d.reshape(len(d), -1), a[:5], device="cpu")
    with pytest.raises(ValueError, match="bin_factor"):
        tdi.ncc_feature_fn(0)
