"""examples/accuracy_benchmark_torch.py against examples/accuracy_benchmark.py.

The JAX script's ``main`` fixes its sizes (4,096 entries, 600 steps at
B=256, inplanes 32, 40 refine steps, an L=64 sphere on a 513 master), so
the JAX side here follows it stage by stage at a small size with its own
``render_patterns`` and the JAX package: an 8-point grid (512 entries,
4.3-degree spacing), 3 train steps at B=8, inplanes 2, 32 queries per
stage, pipeline batches of 32, and an f32 model (the script's bf16 model is
the card's; f32 makes the two frameworks comparable to roundoff). The
JAX pipelines run the script's search and consensus on latents from one
jitted encoder (``feature_fn``), which is the script's
``IndexPipeline(model, params, ...)`` with the encode compiled once rather
than once per pipeline. The twin's ``main`` runs at the same sizes on the
CPU from JAX's ``params0`` (carried across by `flax_params_to_state_dict`)
and JAX's step noise, ``normal(fold_in(key 3, step), (B, 16))``; its own
numpy draw of ``params0`` (`jax_init_state_dict`) is held separately.

The ``--kinematical`` and ``--dynamical`` stages after pattern DI are
held as functions of their inputs, the same inputs on both sides: 8
noisy off-grid kinematical renders (the script's draws), the top-4 of a
pattern DI over a 6-point kinematical grid, the sphere at L=8 on a
65-pixel kinematical master, refinement at 3 steps in chunks of 8, and a
33-pixel Bloch-wave master in place of the 201-pixel one.

Holds:

* the cosine renders, noise included, bit for bit (the same numpy draws);
  the ``--kinematical`` and ``--dynamical`` renders within 1e-5,
  `simulate_patterns`' and `render_from_master`'s bound in
  tests/test_torch_sim.py and tests/test_torch_master.py;
* `jax_init_state_dict`: JAX's ``model.init(key 0)`` weights, every leaf
  within 1e-6;
* the loss after 3 steps at rtol 1e-5;
* every printed pipeline stage (random weights, trained, the four
  off-grid consensus powers, pattern DI): scores within 1e-5 before
  training and within 5e-4 after it (Adam's first steps turn gradient
  roundoff into weights ~4e-5 apart; 1.8e-4 measured), indices equal but
  for swaps between neighbours whose scores lie within twice that and at
  the last rank (a swap with the first rank cut off), success equal,
  median and p90 errors within 1e-3 degrees;
* the spherical row's errors, from the twin's sphere, as the script takes
  them (its quaternion roll and symmetry-reduced misorientation): median
  and p90 within 1e-3 degrees;
* both refinement rows against JAX's refinement on the same queries and
  candidates: median and p90 errors within 1e-3 degrees, the median NCC
  within 1e-4 (tests/test_torch_refine.py's bounds), the overruled share
  equal;
* the ``--dynamical`` fitted bands: the same bands, weights within 1e-6
  (tests/test_torch_master_fit.py's bound).
"""

import contextlib
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from examples import accuracy_benchmark as jax_gate_script
from examples import accuracy_benchmark_torch as gate
from examples.common_torch import dictionary_grid, jax_init_state_dict
from latice_tpu_torch.models import flax_params_to_state_dict

GRID, STEPS, B, NQ, INPLANES, LATENT, PIPE_BATCH = 8, 3, 8, 32, 2, 16, 32
ERR_ATOL_DEG = 1e-3
SCORE_ATOL = {"random": 1e-5, "off-grid DI": 1e-5}  # else TRAINED_SCORE_ATOL
TRAINED_SCORE_ATOL = 5e-4
RENDER_ATOL = 1e-5
NCC_ATOL = 1e-4
WEIGHT_ATOL = 1e-6
POWERS = (None, 16, 64, 256)
KIN_GRID, KIN_NQ, KIN_TOP_N = 6, 4, 3
SPHERE_MASTER, SPHERE_L = 65, 8
REFINE_STEPS, REFINE_CHUNK = 3, 8
DYN_MASTER, DYN_BEAMS = 33, 15
REFINE_ROWS = ("refined (consensus init)", "refined (candidates)")


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it (building a model
    draws from it)."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as on one core: the suite runs a worker per
    core, and these small convolutions and refinements run several times
    slower when every worker's threads contend for all the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eps(step):
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(jax.random.key(3), step), (B, LATENT))))


def _figures(res, q_angles):
    """The script's ``eval_pipe`` figures of one result."""
    got = R.from_euler("zxz", np.where(res.success[:, None], res.best_orientation, 0),
                       degrees=True)
    err = np.degrees((got.inv() * R.from_euler("zxz", q_angles, degrees=True)).magnitude())
    err = np.where(res.success, err, np.nan)
    with _quiet():
        return dict(success=float(res.success.mean()), median_err_deg=float(np.nanmedian(err)),
                    p90_deg=float(np.nanpercentile(err, 90)), result=res)


@contextlib.contextmanager
def _quiet():
    """Silence numpy's warnings of medians over rows that all failed, and
    the twin's printed lines."""
    with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


@pytest.fixture(scope="module")
def jax_run():
    """accuracy_benchmark.main's stages at the small size, in JAX."""
    from latice_tpu.index import IndexPipeline, PatternDictionaryIndexer
    from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
    from latice_tpu.train import VAELoss, create_train_state

    render = jax_gate_script.render_patterns
    dict_angles = dictionary_grid(GRID)
    dict_patterns = render(dict_angles)
    model = JaxVAE(inplanes=INPLANES, latent_dim=LATENT)
    init = jax.jit(lambda k0, k1: model.init({"params": k0}, jnp.zeros((1, 128, 128, 1)), k1))
    params0 = init(jax.random.key(0), jax.random.key(1))["params"]
    xd = jnp.asarray(dict_patterns[..., None].astype(np.float32))
    enc = jax.jit(lambda p, x: model.apply({"params": p}, x, method="encode")[0])

    def encode(params, x):
        return np.concatenate([np.asarray(enc(params, x[i : i + NQ]))
                               for i in range(0, len(x), NQ)])

    def encode_dictionary(params):
        lat = encode(params, xd)
        return lat / np.linalg.norm(lat, axis=1, keepdims=True)

    kw = dict(top_n=10, orientation_threshold=5.0, min_required_matches=3,
              batch_size=PIPE_BATCH)

    def pipe(params, vecs, q, **extra):
        """``IndexPipeline(model, params, vecs, ...)(q)``, encoded by ``enc``."""
        lat = encode(params, jnp.asarray(q.astype(np.float32)))
        return IndexPipeline(None, None, vecs, dict_angles, **kw, **extra,
                             feature_fn=lambda x: x.reshape(len(x), -1))(lat[:, None, None, :])

    out = {}
    q_angles = dict_angles[::8][:NQ]
    q = render(q_angles, noise=0.15, seed=9)[..., None]
    out["random"] = _figures(pipe(params0, encode_dictionary(params0), q), q_angles)

    state = create_train_state(model, params0, learning_rate=3e-4)
    loss_fn = VAELoss(kl_lambda=5e-6)

    def step_with_take(state, xd, idx, rng):
        batch = jnp.take(xd, idx, axis=0)
        step_rng = jax.random.fold_in(rng, state.step)

        def loss_of(p):
            z, x_hat, mu, std = state.apply_fn({"params": p}, batch, step_rng)
            return loss_fn(z, x_hat, mu, std, batch)["loss"]

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        return state.apply_gradients(grads=grads), loss

    step = jax.jit(step_with_take)
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        state, loss = step(state, xd, jnp.asarray(rng.integers(0, len(xd), size=B)),
                           jax.random.key(3))
    out["final_loss"] = float(loss)
    vecs = encode_dictionary(state.params)
    out["trained"] = _figures(pipe(state.params, vecs, q), q_angles)
    rng2 = np.random.default_rng(11)
    q_angles = rng2.uniform([1, 41, 1], [29, 69, 29], size=(NQ, 3))
    q = render(q_angles, noise=0.15, seed=13)[..., None]
    for power in POWERS:
        out[f"off-grid power={power}"] = _figures(
            pipe(state.params, vecs, q, consensus_weight_power=power), q_angles)
    out["off-grid DI"] = _figures(PatternDictionaryIndexer(dict_patterns, dict_angles, **kw)(q),
                                  q_angles)
    out["params0"] = jax.tree.map(np.asarray, params0)
    return out


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The twin from JAX's ``params0`` itself (its own numpy draw is 2.4e-7
    away, and three Adam steps amplify even that) with JAX's step noise."""
    sd = flax_params_to_state_dict(jax_run["params0"], INPLANES, LATENT)
    with _quiet():
        return gate.main(device="cpu", grid=GRID, steps=STEPS, batch=B, n_query=NQ,
                         inplanes=INPLANES, latent_dim=LATENT, precision="32", state_dict=sd,
                         eps_fn=_eps, pipe_batch=PIPE_BATCH)


@pytest.fixture(scope="module")
def kinematical_inputs():
    """The later stages' inputs: the script's off-grid query draws at
    ``KIN_NQ``, rendered kinematically with its noise, and a pattern DI's
    top-``KIN_TOP_N`` over a ``KIN_GRID``-point kinematical grid."""
    from latice_tpu_torch.index import PatternDictionaryIndexer

    render = jax_gate_script.render_patterns
    dict_angles = dictionary_grid(KIN_GRID)
    q_angles = np.random.default_rng(11).uniform([1, 41, 1], [29, 69, 29], size=(KIN_NQ, 3))
    q = render(q_angles, noise=0.15, seed=13, mode="kinematical")
    last_res = PatternDictionaryIndexer(
        render(dict_angles, mode="kinematical"), dict_angles, top_n=KIN_TOP_N,
        orientation_threshold=5.0, min_required_matches=3, batch_size=KIN_NQ, device="cpu",
    )(q[..., None])
    return q, q_angles, last_res, dict_angles


@pytest.mark.parametrize("noise, seed, freqs", [
    (0.0, 0, (9.0, 14.0, 6.0)), (0.15, 9, (9.0, 14.0, 6.0)), (0.1, 100, (11.0, 7.0, 16.0))])
def test_cosine_renders_bit_for_bit(noise, seed, freqs):
    angles = dictionary_grid(GRID)[::5]
    want = jax_gate_script.render_patterns(angles, noise=noise, seed=seed, freqs=freqs)
    got = gate.render_patterns(angles, noise=noise, seed=seed, freqs=freqs, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape == (len(angles), 128, 128)
    np.testing.assert_array_equal(got, want)


def test_kinematical_renders_within_simulate_bound():
    angles = dictionary_grid(GRID)[::97]
    want = jax_gate_script.render_patterns(angles, noise=0.15, seed=13, mode="kinematical")
    got = gate.render_patterns(angles, noise=0.15, seed=13, mode="kinematical", device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)
    with pytest.raises(ValueError, match="fcc-Ni"):
        gate.render_patterns(angles, freqs=(11.0, 7.0, 16.0), mode="kinematical", device="cpu")


def test_jax_init_state_dict_is_flax_init(jax_run):
    """The twin's numpy draw of ``model.init({"params": key(0)})``: every
    leaf within 1e-6 of JAX's (erf_inv's last bit; 2.4e-7 measured). The
    untrained demos' draw from key 1 is held through their printed lines
    in tests/test_torch_examples.py."""
    want = flax_params_to_state_dict(jax_run["params0"], INPLANES, LATENT)
    got = jax_init_state_dict(0, INPLANES, LATENT)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_loss_after_training_matches_jax(port_run, jax_run):
    np.testing.assert_allclose(port_run["final_loss"], jax_run["final_loss"], rtol=1e-5)


@pytest.mark.parametrize("tag", ["random", "trained"] + [f"off-grid power={p}" for p in POWERS]
                         + ["off-grid DI"])
def test_stage_figures_match_jax(port_run, jax_run, tag):
    got, want = port_run[tag], jax_run[tag]
    gi, wi = got["result"].indices, want["result"].indices
    ws = want["result"].scores
    atol = SCORE_ATOL.get(tag, TRAINED_SCORE_ATOL)
    np.testing.assert_allclose(got["result"].scores, ws, rtol=0, atol=atol)
    # A rank may swap only with a neighbour whose score ties it; the last
    # rank also with the first one cut off (its score is not returned).
    tie = np.zeros_like(ws, bool)
    close = np.abs(np.diff(ws, axis=1)) <= 2 * atol
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    tie[:, -1] = True
    assert not ((gi != wi) & ~tie).any(), np.argwhere((gi != wi) & ~tie)
    np.testing.assert_array_equal(got["result"].success, want["result"].success)
    assert got["success"] == want["success"]
    for key in ("median_err_deg", "p90_deg"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ERR_ATOL_DEG,
                                   equal_nan=True, err_msg=key)


def test_spherical_row_matches_jax_script(kinematical_inputs):
    """The script's ``--kinematical`` sphere row: the twin's errors of its
    sphere's orientations against the script's own reading of the same
    quaternions."""
    from latice_tpu.crystal.symmetry import symmetry_reduced_misorientation
    from latice_tpu_torch.sim import make_kinematical_master

    q, q_angles, _, _ = kinematical_inputs
    readings = {}
    with _quiet():
        gate.spherical_row(make_kinematical_master(size=SPHERE_MASTER), q, q_angles, readings,
                           bandwidth=SPHERE_L, device="cpu")
    got = readings["spherical"]
    want_q = np.roll(R.from_euler("zxz", q_angles, degrees=True).as_quat(), 1, axis=1)
    sph_err = np.degrees(np.asarray(symmetry_reduced_misorientation(
        jnp.asarray(want_q, jnp.float32),
        jnp.asarray(got["result"].quaternions, jnp.float32),
    )))
    assert np.isfinite(sph_err).all() and len(sph_err) == KIN_NQ
    np.testing.assert_allclose(got["median_err_deg"], np.median(sph_err), rtol=0,
                               atol=ERR_ATOL_DEG)
    np.testing.assert_allclose(got["p90_deg"], np.percentile(sph_err, 90), rtol=0,
                               atol=ERR_ATOL_DEG)


@pytest.fixture(scope="module")
def refine_runs(kinematical_inputs):
    """Both refinement rows, the twin's and the script's (lines 320-372)
    run by the JAX package on the same inputs."""
    from latice_tpu import sim as jsim
    from latice_tpu.crystal import from_euler_zxz_deg

    q, q_angles, last_res, dict_angles = kinematical_inputs
    got = {}
    with _quiet():
        gate.refine_rows(q, q_angles, last_res, dict_angles, got, steps=REFINE_STEPS,
                         chunk=REFINE_CHUNK, device="cpu")
    want_r = R.from_euler("zxz", q_angles, degrees=True)

    def figures(refined_q, ncc):
        err = np.degrees((R.from_quat(np.roll(refined_q, -1, axis=1)).inv() * want_r).magnitude())
        err = np.where(last_res.success, err, np.nan)
        with _quiet():
            return dict(median_err_deg=float(np.nanmedian(err)),
                        p90_deg=float(np.nanpercentile(err, 90)), ncc=float(np.median(ncc)))

    kw = dict(steps=REFINE_STEPS, chunk=REFINE_CHUNK)
    init_q = np.asarray(from_euler_zxz_deg(jnp.asarray(last_res.best_orientation, jnp.float32)))
    want = {REFINE_ROWS[0]: figures(*jsim.refine_orientations(q, init_q, **kw))}
    cand_q = np.asarray(from_euler_zxz_deg(
        jnp.asarray(dict_angles[last_res.indices], jnp.float32).reshape(-1, 3)
    )).reshape(*last_res.indices.shape, 4)
    refined_q, ncc, best_k = jsim.refine_candidates(q, cand_q, **kw)
    want[REFINE_ROWS[1]] = dict(figures(refined_q, ncc), overruled=float(np.mean(best_k != 0)))
    return got, want


@pytest.mark.parametrize("tag", REFINE_ROWS)
def test_refine_rows_match_jax_script(refine_runs, tag):
    got, want = (run[tag] for run in refine_runs)
    for key in ("median_err_deg", "p90_deg"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ERR_ATOL_DEG,
                                   equal_nan=True, err_msg=key)
    np.testing.assert_allclose(got["ncc"], want["ncc"], rtol=0, atol=NCC_ATOL)
    assert got.get("overruled") == want.get("overruled")


def test_dynamical_renders_and_fitted_bands_match_jax(monkeypatch):
    """``--dynamical`` on a small Bloch-wave master put in both scripts'
    caches: the renders, and the bands the refinement fits to the master."""
    from latice_tpu import sim as jsim
    from latice_tpu_torch.sim import cubic_structure, dynamical_master_pattern

    master = dynamical_master_pattern(cubic_structure("fcc", "ni", 3.52), size=DYN_MASTER,
                                      n_beams=DYN_BEAMS, max_hkl=2, device="cpu")
    monkeypatch.setattr(jax_gate_script, "_DYN_MASTER", master)
    monkeypatch.setitem(gate._DYN_MASTER, "cpu", master)
    angles = dictionary_grid(GRID)[::97]
    want = jax_gate_script.render_patterns(angles, noise=0.15, seed=13, mode="dynamical")
    got = gate.render_patterns(angles, noise=0.15, seed=13, mode="dynamical", device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)
    with _quiet():
        bands = gate.fitted_reflectors(gate._dynamical_master("cpu"))
    want_bands, _ = jsim.fit_reflectors_to_master(
        jax_gate_script._dynamical_master(),
        jsim.cubic_reflectors("fcc", a=3.52, kv=20.0, max_hkl=4, min_d=0.6))
    np.testing.assert_array_equal(bands.normals, want_bands.normals)
    np.testing.assert_array_equal(bands.sin_theta, want_bands.sin_theta)
    np.testing.assert_allclose(bands.intensity, want_bands.intensity, rtol=0, atol=WEIGHT_ATOL)
