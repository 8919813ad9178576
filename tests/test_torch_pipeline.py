"""The slice as a whole: the port's IndexPipeline against latice_tpu's.

Same weights (JAX ``init``, carried across by `flax_params_to_state_dict`)
and the same dictionary, built by encoding seeded patterns: grains of 25
noisy copies of one pattern each, labelled with orientations spread around
the grain's, so that noisy queries of a tight grain reach consensus and
queries of a loose grain do not. The JAX side runs ``engine="fused"``
(its Pallas kernel in interpret mode off the TPU); the port runs
``engine="fused"`` (the plain twin on the CPU) and ``engine="exact"``.

Indices, ``success``, ``n_similar`` and ``phase`` equal; scores within
1e-5; best and mean orientations within 1e-3° misorientation; NaN means in
the same rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index import IndexPipeline as JaxPipeline
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.index import IndexPipeline, concat_dense_results
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict

INPLANES, LATENT, GRAINS, PER_GRAIN = 4, 16, 12, 25


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jm = JaxVAE(inplanes=INPLANES, latent_dim=LATENT)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(1)
    )["params"]
    tm = VariationalAutoEncoderRawData(INPLANES, LATENT)
    params_np = jax.tree.map(np.asarray, params)
    tm.load_state_dict(flax_params_to_state_dict(params_np, INPLANES, LATENT))

    bases = rng.uniform(size=(GRAINS, 128, 128)).astype(np.float32)
    noise = rng.normal(scale=0.02, size=(GRAINS, PER_GRAIN, 128, 128)).astype(np.float32)
    patterns = np.clip(bases[:, None] + noise, 0, 1).reshape(-1, 128, 128)
    enc = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="encode")[0])
    latents = np.array(enc(params, jnp.asarray(patterns[..., None])))
    latents /= np.linalg.norm(latents, axis=1, keepdims=True)

    grain_euler = rng.uniform([10, 30, 10], [170, 150, 170], size=(GRAINS, 1, 3))
    spread = np.where(np.arange(GRAINS) % 4 == 3, 8.0, 0.4)[:, None, None]  # every 4th is loose
    orients = (grain_euler + rng.uniform(-1, 1, size=(GRAINS, PER_GRAIN, 3)) * spread).reshape(
        -1, 3
    )
    phases = np.repeat(np.arange(GRAINS) % 2, PER_GRAIN).astype(np.int32)

    q_idx = rng.integers(0, GRAINS, size=40)
    queries = np.clip(
        bases[q_idx] + rng.normal(scale=0.02, size=(40, 128, 128)), 0, 1
    ).astype(np.float32)
    return dict(jm=jm, params=params, tm=tm, latents=latents, orients=orients, phases=phases,
                queries=queries)


def _misorientation_deg(a_deg, b_deg):
    qa = from_euler_zxz_deg(torch.from_numpy(np.asarray(a_deg, np.float64)))
    qb = from_euler_zxz_deg(torch.from_numpy(np.asarray(b_deg, np.float64)))
    return np.rad2deg(misorientation_angle(qa, qb).numpy())


def _assert_same(got, want):
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.success, want.success)
    np.testing.assert_array_equal(got.n_similar, want.n_similar)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    assert _misorientation_deg(got.best_orientation, want.best_orientation).max() < 1e-3
    np.testing.assert_array_equal(np.isnan(got.mean_orientation), np.isnan(want.mean_orientation))
    ok = want.success
    assert _misorientation_deg(got.mean_orientation[ok], want.mean_orientation[ok]).max() < 1e-3
    if want.phase is None:
        assert got.phase is None
    else:
        np.testing.assert_array_equal(got.phase, want.phase)


CASES = {
    "single_phase": dict(),
    "two_phase_weighted": dict(
        dictionary_phases="phases", phase_symmetries=["432", "622"], consensus_weight_power=256
    ),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pipelines(request, setup):
    kw = dict(CASES[request.param])
    if kw.get("dictionary_phases") == "phases":
        kw["dictionary_phases"] = setup["phases"]
    common = dict(top_n=20, orientation_threshold=3.0, min_required_matches=18, batch_size=16)
    jax_pipe = JaxPipeline(
        setup["jm"], setup["params"], setup["latents"], setup["orients"], engine="fused",
        **common, **kw,
    )
    port = {
        engine: IndexPipeline(
            setup["tm"], setup["latents"], setup["orients"], engine=engine, device="cpu",
            **common, **kw,
        )
        for engine in ("fused", "exact")
    }
    return jax_pipe, port


@pytest.mark.parametrize("engine", ["fused", "exact"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_matches_jax_fused_pipeline(setup, pipelines, engine, dtype):
    jax_pipe, port = pipelines
    q = setup["queries"]  # 40 rows: not a multiple of batch_size 16
    if dtype == "uint8":
        q = np.round(q * 255).astype(np.uint8)
    want = jax_pipe(q)
    got = port[engine](q)
    assert 0 < want.success.sum() < len(q)  # successes and failures both present
    _assert_same(got, want)


def test_channel_axis_and_empty_input(setup, pipelines):
    _, port = pipelines
    q = setup["queries"][:5]
    a = port["fused"](q)
    b = port["fused"](q[..., None])
    np.testing.assert_array_equal(a.indices, b.indices)
    empty = port["fused"](np.zeros((0, 128, 128), np.float32))
    assert empty.indices.shape == (0, 20) and empty.success.shape == (0,)
    with pytest.raises(ValueError, match="patterns"):
        port["fused"](np.zeros((2, 128, 128, 3), np.float32))


def test_concat_dense_results(setup, pipelines):
    _, port = pipelines
    q = setup["queries"]
    whole = port["exact"](q)
    parts = concat_dense_results([port["exact"](q[:17]), port["exact"](q[17:])])
    for f in whole._fields:
        a, b = getattr(whole, f), getattr(parts, f)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_encode_matches_jax(setup, pipelines):
    _, port = pipelines
    q = setup["queries"][:6]
    jm, params = setup["jm"], setup["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(q[..., None]), method="encode")[0])
    np.testing.assert_allclose(port["exact"].encode(q), want, atol=1e-4)
