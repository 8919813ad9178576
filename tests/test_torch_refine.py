"""The port's autodiff orientation refinement against latice_tpu's, on the
CPU, on patterns rendered at known orientations (64x64, fcc with
max_hkl 2) and starts perturbed by a known misorientation.

Adam's sign-normalized steps can turn a roundoff-sized gradient difference
into an lr-sized step near the optimum, so the bounds were set from the
measured distances. From starts 1 to 1.5 degrees off, where the gradient
stands far above roundoff, the port's refined orientations lie within
1.3e-5 degrees of JAX's (clean and noisy, 5 to 40 steps) and its final NCC
within 1.8e-6: held to 1e-4 degrees and 1e-4. From the exact orientation
the gradient is roundoff from the first step, and each side walks its own
lr-sized path (measured 0.047 degrees apart); each stays within the JAX
test's 0.05 degrees of the truth, so the two are held to 0.1 degrees, twice
that, and the NCC to 1e-4. The port is also held to the JAX tests' own
accuracy bounds (tests/sim/test_refine.py)."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu import sim as jsim
from latice_tpu_torch import sim as tsim

ORIENT_DEG = 1e-4
AT_OPTIMUM_DEG = 0.1
NCC_ATOL = 1e-4
CHUNK = 8  # one chunk for the six patterns: the JAX side compiles once per step count


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _mis_deg(qa, qb):
    ra, rb = (R.from_quat(np.roll(q, -1, axis=-1)) for q in (qa, qb))
    return np.degrees((ra.inv() * rb).magnitude())


def _perturb(quats, deg, rng):
    axes = rng.normal(size=(len(quats), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    q = R.from_rotvec(np.radians(deg) * axes) * R.from_quat(np.roll(quats, -1, axis=-1))
    return np.roll(q.as_quat(), 1, axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """The inputs of tests/sim/test_refine.py, drawn in its order from its
    seed, so its bounds apply to them: the truth, the 1.5-degree starts, the
    noise and 1.0-degree starts of the noisy case, and the 1.0-degree starts
    of the candidate case."""
    rng = np.random.default_rng(0)
    truth = rng.normal(size=(6, 4)).astype(np.float32)
    truth /= np.linalg.norm(truth, axis=1, keepdims=True)
    models = {
        "jax": (jsim.DetectorGeometry(shape=(64, 64)),
                jsim.cubic_reflectors("fcc", max_hkl=2, min_d=1.0)),
        "port": (tsim.DetectorGeometry(shape=(64, 64)),
                 tsim.cubic_reflectors("fcc", max_hkl=2, min_d=1.0)),
    }
    patterns = jsim.simulate_patterns(truth, *models["jax"])
    starts = {"clean": _perturb(truth, 1.5, rng)}
    noise = rng.normal(size=patterns.shape).astype(np.float32) * 0.1
    starts["noisy"] = _perturb(truth, 1.0, rng)
    starts["candidate"] = _perturb(truth, 1.0, rng)
    return models, truth, patterns, noise, starts


def _both(fn_name, patterns, init, models, **kw):
    want = getattr(jsim, fn_name)(patterns, init, *models["jax"], chunk=CHUNK, **kw)
    got = getattr(tsim, fn_name)(patterns, init, *models["port"], chunk=CHUNK, device="cpu",
                                 **kw)
    return got, want


@pytest.mark.parametrize(
    "steps, case",
    [(5, "clean"), (40, "clean"), (40, "noisy"), (15, "exact")],
    ids=["5-steps", "40-steps", "40-steps-noisy", "exact-start"],
)
def test_refine_matches_jax_and_its_bounds(setup, steps, case):
    models, truth, patterns, noise, starts = setup
    x = patterns + noise if case == "noisy" else patterns
    init = truth if case == "exact" else starts[case]
    (q, ncc), (jq, jncc) = _both("refine_orientations", x, init, models, steps=steps)
    assert q.shape == (6, 4) and ncc.shape == (6,) and q.dtype == ncc.dtype == np.float32
    assert _mis_deg(q, jq).max() < (AT_OPTIMUM_DEG if case == "exact" else ORIENT_DEG)
    np.testing.assert_allclose(ncc, jncc, atol=NCC_ATOL, rtol=0)
    err0, err1 = _mis_deg(init, truth), _mis_deg(q, truth)
    if steps == 40 and case == "clean":  # test_converges_below_grid_resolution
        assert err0.min() > 1.4 and np.median(err1) < 0.15
        assert (err1 < err0 / 3).all() and (ncc > 0.95).all()
    if case == "noisy":  # test_noisy_patterns_still_converge
        assert np.median(err1) < 0.3 and (ncc > 0.5).all() and (ncc < 0.999).all()
    if case == "exact":  # test_exact_init_stays_put
        assert err1.max() < 0.05 and (ncc > 0.99).all()


def test_candidates_match_jax(setup):
    """A wrong top-1 and a perturbed truth at k=1: the NCC re-rank picks
    column 1 on both sides (test_candidate_reranking_overrules_wrong_top1)."""
    models, truth, patterns, _, starts = setup
    cand = np.stack([np.roll(truth, 2, axis=0), starts["candidate"]], axis=1)
    (q, ncc, best_k), (jq, jncc, jbest_k) = _both("refine_candidates", patterns, cand, models,
                                                  steps=25)
    np.testing.assert_array_equal(best_k, jbest_k)
    assert (best_k == 1).all()
    assert _mis_deg(q, jq).max() < ORIENT_DEG
    np.testing.assert_allclose(ncc, jncc, atol=NCC_ATOL, rtol=0)
    assert np.median(_mis_deg(q, truth)) < 0.2 and (ncc > 0.95).all()


def test_chunks_and_inference_mode(setup):
    """Chunks of 2 give the one-chunk result, also when the caller runs
    under torch.inference_mode (the gradient is taken all the same)."""
    models, truth, patterns, _, _ = setup
    init = _perturb(truth, 1.0, np.random.default_rng(3))
    a, _ = tsim.refine_orientations(patterns, init, *models["port"], steps=10, chunk=2,
                                    device="cpu")
    with torch.inference_mode():
        b, _ = tsim.refine_orientations(patterns, init, *models["port"], steps=10, chunk=8,
                                        device="cpu")
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_validation(setup):
    models, truth, patterns, _, _ = setup
    g, r = models["port"]
    with pytest.raises(ValueError, match="B, H, W"):
        tsim.refine_orientations(patterns[0], truth[:1], g, r, device="cpu")
    with pytest.raises(ValueError, match="init_quats"):
        tsim.refine_orientations(patterns, truth[:2], g, r, device="cpu")
    with pytest.raises(ValueError, match="geometry renders"):
        tsim.refine_orientations(patterns[:, :32], truth, g, r, device="cpu")
    with pytest.raises(ValueError, match="B, K, 4"):
        tsim.refine_candidates(patterns, truth, g, r, device="cpu")
    with pytest.raises(ValueError, match="K >= 1"):
        tsim.refine_candidates(patterns, np.zeros((6, 0, 4)), g, r, device="cpu")
