"""The consensus kernel K4 (``ops.candidate_consensus_fused``): on the CPU,
its wrapper runs the plain twin and `CandidateConsensus` returns what the
JAX package's pipeline computes, in the port's dtypes; on the card, the
kernel against that twin, and the index path's one launch a batch with no
sync in the consensus.

Candidate sets are drawn from a dictionary of clusters, each within ~2.5°
of its centre, with outliers and shuffled trial references, so that both
success and failure occur at a 3° threshold. ``success``, ``n_similar``
and ``phase`` must be equal in every row whose trial
misorientations all lie more than 1e-4° from the threshold (f32 rounding
could flip a comparison nearer than that), and the orientations within
1e-3°.

JAX is imported only inside the CPU cases: the card tests run where JAX is
absent, with
``python -m pytest tests/test_torch_consensus_fused.py -m card --noconftest``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from latice_tpu_torch.crystal import (
    from_euler_zxz_deg,
    misorientation_angle,
    quat_mul,
    to_euler_zxz_deg,
)
from latice_tpu_torch.index import IndexPipeline
from latice_tpu_torch.index.pipeline import CandidateConsensus
from latice_tpu_torch.ops import _build
from latice_tpu_torch.ops.consensus_fused import (
    candidate_consensus_fused,
    candidate_consensus_fused_plain,
)
from latice_tpu_torch.utils.profiling import recorded

THRESHOLD = 3.0
MARGIN_DEG = 1e-4


def _unit(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _dictionary(rng, clusters: int, per: int) -> np.ndarray:
    """``(clusters * per, 3)`` zxz degrees: clusters of rotations within
    ~2.5° of a random centre."""
    axis = rng.normal(size=(clusters * per, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = np.deg2rad(rng.uniform(0, 2.5, size=(clusters * per, 1))) / 2
    small = np.concatenate([np.cos(half), np.sin(half) * axis], axis=1)
    centres = np.repeat(_unit(rng, clusters), per, axis=0)
    quats = quat_mul(torch.from_numpy(small), torch.from_numpy(centres))
    return to_euler_zxz_deg(quats).numpy()


def _case(seed: int, b: int, k: int, phases: bool, per: int = 60, clusters: int = 40):
    """A `CandidateConsensus`'s dictionary and a batch of its candidates:
    ``(euler, phase ids or None, scores (b, k), indices (b, k))``."""
    rng = np.random.default_rng(seed)
    euler = _dictionary(rng, clusters, per)
    phase = rng.integers(0, 2, size=len(euler)).astype(np.int32) if phases else None
    if phase is not None:
        phase[: clusters // 2 * per] = 0  # half the clusters single-phase, so some succeed
    idx = np.empty((b, k), np.int64)
    for r in range(b):
        c = rng.integers(clusters)
        members = rng.choice(per, size=rng.integers(k // 2, k + 1), replace=False) + c * per
        outliers = rng.choice(len(euler), size=k - len(members), replace=False)
        row = np.concatenate([members, outliers])
        idx[r] = row[rng.permutation(k)]
    scores = np.sort(rng.uniform(0.2, 1.0, size=(b, k)), axis=1)[:, ::-1].astype(np.float32)
    return euler, phase, torch.from_numpy(scores.copy()), torch.from_numpy(idx)


def _jax_call(euler, phase, scores, indices, cc: CandidateConsensus):
    """What the JAX package's ``IndexPipeline`` computes from the same
    candidates (``latice_tpu/index/pipeline.py``): the rows gathered, its
    consensus, the weights, the Euler angles and the top-1 fallback."""
    import jax.numpy as jnp

    from latice_tpu.crystal import from_euler_zxz_deg as jax_from_euler
    from latice_tpu.crystal import stack_symmetry_tables as jax_stack
    from latice_tpu.crystal import to_euler_zxz_deg as jax_to_euler
    from latice_tpu.index.consensus import consensus_orientations as jax_consensus

    quats = jax_from_euler(jnp.asarray(euler, jnp.float32))
    if phase is not None:
        quats = jnp.concatenate([quats, jnp.asarray(phase, jnp.float32)[:, None]], axis=1)
    cand_rows = jnp.take(quats, jnp.asarray(indices.numpy().astype(np.int32)), axis=0)
    cand_quats = cand_rows[..., :4]
    cand_phases = None if phase is None else cand_rows[..., 4].astype(jnp.int32)
    s = jnp.asarray(scores.numpy())
    cand_weights = None
    if cc.weight_power is not None:
        pos = jnp.maximum(s, 0.0)
        top = jnp.maximum(jnp.max(pos, axis=-1, keepdims=True), jnp.float32(1e-30))
        cand_weights = (pos / top) ** cc.weight_power
    cons = jax_consensus(
        cand_quats, cc.threshold, min_required_matches=cc.min_matches,
        max_iterations=min(cc.max_iterations, indices.shape[1]), angle_unit=cc.angle_unit,
        cand_phases=cand_phases, sym_tables=None if phase is None else jax_stack(["432", "622"]),
        cand_weights=cand_weights,
    )
    best = jnp.where(cons.success[:, None], cons.mean_euler, jax_to_euler(cand_quats[:, 0]))
    out = dict(mean=cons.mean_euler, best=best, success=cons.success,
               n_similar=cons.similar_mask.sum(axis=1), similar_mask=cons.similar_mask)
    if phase is not None:
        out["phase"] = jnp.where(cons.success, cons.phase, cand_phases[:, 0])
    return {k: np.asarray(v) for k, v in out.items()}


def _margin_rows(cc: CandidateConsensus, indices, iters: int, radians: bool) -> np.ndarray:
    """Rows whose trial misorientations all lie more than `MARGIN_DEG` from
    the threshold, in float64."""
    q = cc.quats.cpu()[indices.cpu()][..., :4].double()
    mis = np.rad2deg(misorientation_angle(q[:, :iters, None, :], q[:, None, :, :]).numpy())
    threshold = np.rad2deg(cc.threshold) if radians else cc.threshold
    return (np.abs(mis - threshold) > MARGIN_DEG).all(axis=(1, 2))


def _angle_deg(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    qa = from_euler_zxz_deg(a.double().cpu())
    qb = from_euler_zxz_deg(b.double().cpu())
    return np.rad2deg(misorientation_angle(qa, qb).numpy())


def _consensus(euler, phase, device, k, **kw) -> CandidateConsensus:
    kw.setdefault("min_required_matches", k // 2 + 2)
    return CandidateConsensus(
        euler, torch.device(device), dictionary_phases=phase,
        phase_symmetries=None if phase is None else ["432", "622"],
        orientation_threshold=kw.pop("threshold", THRESHOLD), **kw,
    )


CPU_CASES = [
    dict(phases=False),
    dict(phases=True),
    dict(phases=False, consensus_weight_power=4.0),
    dict(phases=True, consensus_weight_power=256.0, max_iterations=1),
    dict(phases=False, angle_unit="rad", threshold=float(np.deg2rad(THRESHOLD))),
    dict(phases=True, index_dtype=torch.int32, max_iterations=5),
]


@pytest.mark.parametrize("case", CPU_CASES, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_cpu_call_is_the_previous_call(case):
    """On CPU tensors `CandidateConsensus` runs the plain twin, no kernel,
    and returns what it returned before the kernel: the JAX package's
    pipeline outputs, in the port's dtypes, with ``success``, ``n_similar``,
    the chosen trial's mask and ``phase`` equal away from the threshold and
    the orientations within 1e-3 degrees."""
    case = dict(case)
    phases, index_dtype = case.pop("phases"), case.pop("index_dtype", torch.int64)
    k = 12
    euler, phase, scores, idx = _case(5, 24, k, phases, per=20, clusters=8)
    cc = _consensus(euler, phase, "cpu", k, **case)
    idx = idx.to(index_dtype)
    before = candidate_consensus_fused.launches
    got = cc(scores, idx)
    assert candidate_consensus_fused.launches == before
    want_types = dict(mean_euler=(torch.float32, (24, 3)), best=(torch.float32, (24, 3)),
                      success=(torch.bool, (24,)), n_similar=(torch.int64, (24,)),
                      similar_mask=(torch.bool, (24, k)), indices=(index_dtype, (24, k)),
                      scores=(torch.float32, (24, k)))
    if phases:
        want_types["phase"] = (torch.int32, (24,))
    else:
        assert got.phase is None
    assert {f: (getattr(got, f).dtype, tuple(getattr(got, f).shape)) for f in want_types} == (
        want_types)
    assert got.indices is idx and got.scores is scores
    want = _jax_call(euler, phase, scores, idx, cc)
    keep = _margin_rows(cc, idx, min(cc.max_iterations, k), cc.angle_unit == "rad")
    assert keep.mean() > 0.9
    assert 0 < int(want["success"].sum()) < len(scores)  # both branches
    np.testing.assert_array_equal(got.success.numpy()[keep], want["success"][keep])
    np.testing.assert_array_equal(got.n_similar.numpy()[keep], want["n_similar"][keep])
    np.testing.assert_array_equal(got.similar_mask.numpy()[keep], want["similar_mask"][keep])
    if phases:
        np.testing.assert_array_equal(got.phase.numpy()[keep], want["phase"][keep])
    ok = keep & want["success"]
    mean_gap = _angle_deg(got.mean_euler[ok], torch.from_numpy(want["mean"][ok]))
    assert mean_gap.max(initial=0.0) < 1e-3
    assert _angle_deg(got.best[keep], torch.from_numpy(want["best"][keep])).max() < 1e-3


def test_sources_list_the_kernel():
    assert "consensus_fused" in _build.SOURCES
    assert (_build.CSRC / "consensus_fused.cu").exists()


def _bad(name):
    euler, _, scores, idx = _case(6, 4, 6, False, per=10, clusters=4)
    cc = _consensus(euler, None, "cpu", 6)
    args = dict(scores=scores, indices=idx, rows=cc.quats, sym_tables=cc.sym_tables,
                orientation_threshold=3.0, min_required_matches=3, max_iterations=3)
    if name == "unit":
        args["angle_unit"] = "grad"
    elif name == "shapes":
        args["indices"] = idx[:, :5]
    elif name == "empty_k":
        args["scores"], args["indices"] = scores[:, :0], idx[:, :0]
    elif name == "float_indices":
        args["indices"] = idx.float()
    elif name == "row_width":
        args["rows"] = cc.quats[:, :3]
    elif name == "row_dtype":
        args["rows"] = cc.quats.double()
    elif name == "tables":
        args["sym_tables"] = cc.sym_tables[0]
    elif name == "iterations":
        args["max_iterations"] = 0
    elif name == "devices":
        args["scores"] = scores.to("meta")
    return args


@pytest.mark.parametrize(
    "name",
    ["unit", "shapes", "empty_k", "float_indices", "row_width", "row_dtype", "tables",
     "iterations", "devices"],
)
def test_bad_inputs_raise(name):
    with pytest.raises(ValueError):
        candidate_consensus_fused(**_bad(name))


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


CARD_CASES = [
    dict(b=256, k=20, phases=False),
    dict(b=256, k=20, phases=True),
    dict(b=255, k=20, phases=False, consensus_weight_power=4.0),
    dict(b=256, k=50, phases=True, consensus_weight_power=256.0),
    dict(b=1, k=20, phases=False, angle_unit="rad", threshold=float(np.deg2rad(THRESHOLD))),
    dict(b=255, k=50, phases=False, max_iterations=1),
    dict(b=256, k=20, phases=True, max_iterations=1, index_dtype=torch.int32),
    dict(b=255, k=50, phases=True, max_iterations=40, consensus_weight_power=4.0),
    dict(b=256, k=50, phases=False, angle_unit="rad", threshold=float(np.deg2rad(THRESHOLD))),
]


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_card_kernel_matches_the_plain_twin(card, case):
    case = dict(case)
    b, k, phases = case.pop("b"), case.pop("k"), case.pop("phases")
    index_dtype = case.pop("index_dtype", torch.int64)
    case.setdefault("max_iterations", 3)
    euler, phase, scores, idx = _case(b * 7 + k, b, k, phases)
    cc = _consensus(euler, phase, card, k, **case)
    scores, idx = scores.to(card), idx.to(card, index_dtype)
    args = (scores, idx, cc.quats, cc.sym_tables, cc.threshold, cc.min_matches,
            cc.max_iterations, cc.angle_unit, cc.weight_power)
    before = candidate_consensus_fused.launches
    got = candidate_consensus_fused(*args)
    assert candidate_consensus_fused.launches == before + 1
    want = candidate_consensus_fused_plain(*args)
    torch.cuda.synchronize()
    assert (got.phase is None) == (want.phase is None) == (not phases)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
    assert got.indices is idx and got.scores is scores
    keep = _margin_rows(cc, idx, min(cc.max_iterations, k), cc.angle_unit == "rad")
    assert keep.mean() > 0.9
    success = want.success.cpu().numpy()
    if b > 1:
        assert 0 < success.sum() < b  # both branches
    for field in ("success", "n_similar", "similar_mask") + (("phase",) if phases else ()):
        np.testing.assert_array_equal(getattr(got, field).cpu().numpy()[keep],
                                      getattr(want, field).cpu().numpy()[keep])
    ok = keep & success
    assert _angle_deg(got.mean_euler[ok], want.mean_euler[ok]).max(initial=0.0) < 1e-3
    assert _angle_deg(got.best[keep], want.best[keep]).max(initial=0.0) < 1e-3


@pytest.mark.card
def test_card_tables_beyond_shared_memory_raise(card):
    euler, _, scores, idx = _case(6, 4, 6, False, per=10, clusters=4)
    cc = _consensus(euler, None, card, 6)
    tables = cc.sym_tables.repeat(129, 1, 1)  # 129 x 24 operators: 48 KB and 384 bytes
    before = candidate_consensus_fused.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        candidate_consensus_fused(scores.to(card), idx.to(card), cc.quats, tables, 3.0, 3, 3)
    assert candidate_consensus_fused.launches == before


@pytest.mark.card
def test_card_pipeline_launches_once_a_batch_with_no_consensus_sync(card):
    rng = np.random.default_rng(0)
    rows, dim, side, batch = 512, 8, 16, 8
    vectors = rng.normal(size=(rows, dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    pipe = IndexPipeline(
        None, vectors, _dictionary(rng, 16, 32), top_n=20, min_required_matches=4,
        batch_size=batch, engine="fused", device=card,
        feature_fn=lambda x: x.flatten(1)[:, :dim].contiguous(),
    )
    queries = rng.integers(0, 256, (20, side, side), dtype=np.uint8)  # batches of 8, 8 and 4
    pipe(queries)  # builds the kernels
    before = candidate_consensus_fused.launches
    with profile(activities=[ProfilerActivity.CUDA]):
        result = pipe(queries)
    assert candidate_consensus_fused.launches == before + 3
    spans = [s for s in recorded().spans if s.name == "index:consensus"]
    assert len(spans) == 3 and all(s.syncs == 0 for s in spans)
    assert len(result.success) == 20


@pytest.mark.card
@pytest.mark.parametrize("engine", ["device", "fused", "approx", "int8", "native"])
def test_card_database_launches_once_a_chunk_with_no_consensus_sync(card, engine):
    """The latent database's queries take the pipeline's consensus stage:
    one K4 launch a chunk whatever the engine, no stream sync inside it, and
    each row's similar indices as many as its ``n_similar``."""
    from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase

    rng = np.random.default_rng(1)
    dim = 16
    # The latents cluster as the orientations do: 16 clusters of 32 rows.
    vectors = np.repeat(rng.normal(size=(16, dim)), 32, axis=0)
    vectors = (vectors + 0.1 * rng.normal(size=vectors.shape)).astype(np.float32)
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path="/nonexistent/db.npz", dimension=dim, engine=engine),
        device=card,
    )
    db.add_vectors(vectors, _dictionary(rng, 16, 32))
    queries = vectors[:20] + 0.01 * rng.normal(size=(20, dim)).astype(np.float32)
    kw = dict(top_n=20, min_required_matches=8, batch_size=8)  # chunks of 8, 8 and 4
    db.find_best_orientations_batch(queries, **kw)  # builds the kernels
    before = candidate_consensus_fused.launches
    with profile(activities=[ProfilerActivity.CUDA]):
        results = db.find_best_orientations_batch(queries, **kw)
    assert candidate_consensus_fused.launches == before + 3
    spans = [s for s in recorded().spans if s.name == "index:consensus"]
    assert len(spans) == 3 and all(s.syncs == 0 for s in spans)
    dense = db.find_best_orientations_dense(queries, **kw)
    assert candidate_consensus_fused.launches == before + 6
    np.testing.assert_array_equal(dense["n_similar"], [len(r.similar_indices) for r in results])
    np.testing.assert_array_equal(dense["success"], [r.success for r in results])
    assert 0 < dense["success"].sum() < 20 and all(r.distances.shape == (20,) for r in results)
