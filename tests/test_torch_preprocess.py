"""The port's pattern preprocessing against latice_tpu's, on the same seeded
numpy stacks: every function within 1e-5 in f32, equalization ties equal,
the median of an even count, the spec grammar, and the full recipe through
both packages' ``IndexPipeline(preprocess=...)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.data import preprocess as jpp
from latice_tpu.index import IndexPipeline as JaxPipeline
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu_torch.data import preprocess as tpp
from latice_tpu_torch.index import IndexPipeline
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


def _raw_stack(n=4, h=64, w=48, seed=0):
    """Band patterns over a vignetted background, with a few hot and dead
    pixels: what the recipe is for."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    vignette = 1.0 - 0.4 * (((yy - h / 2) / h) ** 2 + ((xx - w / 2) / w) ** 2)
    out = np.empty((n, h, w), np.float32)
    for i in range(n):
        a = rng.uniform(0, np.pi, 3)
        bands = sum(np.exp(-(((np.cos(t) * xx + np.sin(t) * yy) % 17 - 8) ** 2) / 4) for t in a)
        out[i] = vignette * (0.4 + 0.2 * bands) + rng.normal(scale=0.02, size=(h, w))
        hot = rng.integers(0, h * w, 6)
        out[i].flat[hot[:3]] = 3.0
        out[i].flat[hot[3:]] = 0.0
    return out


@pytest.fixture(scope="module")
def stack():
    return _raw_stack()


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


LAYOUTS = ["bhw", "bhwc"]


def _layout(x, layout):
    return x[..., None] if layout == "bhwc" else x


FUNCTIONS = {
    "gaussian_blur": lambda m, x, bg: m.gaussian_blur(x, 2.0),
    "gaussian_blur_wide": lambda m, x, bg: m.gaussian_blur(x, 8.0),
    "static_divide": lambda m, x, bg: m.remove_static_background(x, bg, "divide"),
    "static_subtract": lambda m, x, bg: m.remove_static_background(x, bg, "subtract"),
    "dynamic_divide": lambda m, x, bg: m.remove_dynamic_background(x),
    "dynamic_subtract": lambda m, x, bg: m.remove_dynamic_background(x, 5.0, "subtract"),
    "hot_pixels": lambda m, x, bg: m.fix_hot_pixels(x, 5.0),
    "minmax": lambda m, x, bg: m.normalize_patterns(x),
    "zscore": lambda m, x, bg: m.normalize_patterns(x, "zscore"),
    "clip_minmax": lambda m, x, bg: m.normalize_patterns(x, "minmax", clip_sigma=3.0),
    "equalize": lambda m, x, bg: m.equalize_histogram(x),
    "bin2": lambda m, x, bg: m.bin_patterns(x, 2),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_matches_jax(stack, name, layout):
    x = _layout(stack, layout)
    bg = stack.mean(axis=0)
    want = FUNCTIONS[name](jpp, jnp.asarray(x), bg)
    got = FUNCTIONS[name](tpp, torch.from_numpy(x), bg)
    _close(got, want)


def test_blur_matches_scipy(stack):
    from scipy.ndimage import gaussian_filter

    want = np.stack([gaussian_filter(p.astype(np.float64), 3.0, mode="reflect") for p in stack])
    _close(tpp.gaussian_blur(torch.from_numpy(stack), 3.0), want, 1e-5)


def test_median_of_an_even_count_averages_the_middle_two():
    """16 values: the hot-pixel scale is 1.4826 x the mean of the 8th and 9th
    smallest |residual|, as jnp.median takes it (torch.median would take the
    8th)."""
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    med = tpp._per_pattern_median(x)
    assert med.shape == (1, 1, 1, 1) and float(med) == 7.5
    assert float(jnp.median(jnp.arange(16.0))) == 7.5
    odd = tpp._per_pattern_median(torch.arange(9, dtype=torch.float32).reshape(1, 3, 3, 1))
    assert float(odd) == 4.0


def test_equalize_ties_map_equally():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 5, size=(3, 20, 24)).astype(np.float32)  # heavy ties
    got = tpp.equalize_histogram(torch.from_numpy(x)).numpy()
    want = np.asarray(jpp.equalize_histogram(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        for v in np.unique(x[b]):
            vals = np.unique(got[b][x[b] == v])
            assert len(vals) == 1  # one output per input value
            assert vals[0] == np.float32((x[b] <= v).sum()) / np.float32(x[b].size)  # P(X <= x)


def test_estimate_static_background_matches_jax(stack):
    chunks = [stack[:1], stack[1:3], stack[3:]]
    np.testing.assert_array_equal(tpp.estimate_static_background(iter(chunks)),
                                  jpp.estimate_static_background(iter(chunks)))
    np.testing.assert_array_equal(tpp.estimate_static_background(stack[0]),
                                  jpp.estimate_static_background(stack[0]))
    with pytest.raises(ValueError, match="no patterns"):
        tpp.estimate_static_background([])


def test_mode_and_factor_errors():
    x = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="mode"):
        tpp.remove_static_background(x, np.ones((8, 8)), "mul")
    with pytest.raises(ValueError, match="mode"):
        tpp.remove_dynamic_background(x, mode="mul")
    with pytest.raises(ValueError, match="method"):
        tpp.normalize_patterns(x, "l2")
    with pytest.raises(ValueError, match="not divisible"):
        tpp.bin_patterns(x, 3)


# -- the spec grammar (tests/data/test_preprocess.py's cases) --------------------


def test_full_spec(stack, tmp_path):
    path = tmp_path / "bg.npy"
    np.save(path, stack.mean(axis=0))
    spec = f"hotpixels=5, static={path}, static-mode=subtract, dynamic=auto, equalize, clip=4, bin=2"
    got, want = tpp.parse_preprocess_spec(spec), jpp.parse_preprocess_spec(spec)
    for f in ("hot_pixel_threshold", "static_mode", "dynamic_sigma", "dynamic_mode", "equalize",
              "normalize", "clip_sigma", "bin_factor"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.static_background, want.static_background)
    assert got.dynamic_sigma == "auto" and got.bin_factor == 2


@pytest.mark.parametrize(
    "spec, field, value",
    [
        ("dynamic=12.5", "dynamic_sigma", 12.5),
        ("normalize=zscore", "normalize", "zscore"),
        ("static=auto", "static_background", "auto"),
        ("hotpixels=6,equalize", "hot_pixel_threshold", 6.0),
    ],
)
def test_spec_values(spec, field, value):
    assert getattr(tpp.parse_preprocess_spec(spec), field) == value
    assert getattr(jpp.parse_preprocess_spec(spec), field) == value


def test_empty_spec_is_identity():
    assert tpp.parse_preprocess_spec("") == tpp.PreprocessConfig()


@pytest.mark.parametrize(
    "spec, match",
    [
        ("sharpen=3", "unknown preprocess key"),
        ("hotpixels=hot", "bad value"),
        ("static-mode=mul", "static_mode"),
        ("dynamic-mode=mul", "dynamic_mode"),
        ("normalize=l2", "normalize"),
        ("bin=two", "bad value"),
    ],
)
def test_spec_errors(spec, match):
    for mod in (tpp, jpp):
        with pytest.raises(ValueError, match=match):
            mod.parse_preprocess_spec(spec)


def test_static_auto_must_be_resolved():
    with pytest.raises(ValueError, match="estimate_static_background"):
        tpp.make_preprocess_fn(tpp.parse_preprocess_spec("static=auto"))


# -- compiled recipes ------------------------------------------------------------

RECIPES = [
    "hotpixels=6,dynamic=auto,clip=3,equalize",
    "hotpixels=5,static=FRAME,dynamic=auto",
    "static=FRAME,static-mode=subtract,normalize=zscore",
    "dynamic=6,dynamic-mode=subtract,bin=2",
    "clip=4",
]


def _configs(spec, frame_path):
    spec = spec.replace("FRAME", str(frame_path))
    return tpp.parse_preprocess_spec(spec), jpp.parse_preprocess_spec(spec)


@pytest.mark.parametrize("spec", RECIPES)
def test_make_preprocess_fn_matches_jax(stack, spec, tmp_path):
    np.save(tmp_path / "frame.npy", stack.mean(axis=0))
    tcfg, jcfg = _configs(spec, tmp_path / "frame.npy")
    x = stack[..., None]  # the JAX pipeline's NHWC
    want = jax.jit(jpp.make_preprocess_fn(jcfg))(jnp.asarray(x))
    _close(tpp.make_preprocess_fn(tcfg)(torch.from_numpy(x)), want)
    # The pipeline's (B, H, W) layout gives the same values.
    _close(tpp.make_preprocess_fn(tcfg)(torch.from_numpy(stack)), np.asarray(want)[..., 0])


@pytest.mark.parametrize("equalize, tol", [(False, 1e-5), (True, 1e-3)])
def test_recipe_through_the_pipelines(equalize, tol):
    """``hotpixels=6,static=<scan mean>,dynamic=auto,clip=3[,equalize]``
    inside both packages' IndexPipeline, same weights, uint8 input.

    Equalization maps each pixel to its rank: where the stages before it
    differ by f32 roundoff, two nearly equal pixels can swap ranks, each
    moving by 1/16384, so its scores are held to 1e-3 and its top-1 exactly.
    """
    rng = np.random.default_rng(3)
    raw = np.clip(_raw_stack(n=10, h=128, w=128, seed=4) * 200, 0, 255).astype(np.uint8)
    frame = jpp.estimate_static_background(raw.astype(np.float32) / 255.0)
    recipe = dict(hot_pixel_threshold=6.0, static_background=frame, dynamic_sigma="auto",
                  clip_sigma=3.0, equalize=equalize)
    jm = JaxVAE(inplanes=2, latent_dim=8)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(1)
    )["params"]
    tm = VariationalAutoEncoderRawData(2, 8)
    tm.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), 2, 8))
    enc = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="encode")[0])
    pre = jax.jit(jpp.make_preprocess_fn(jpp.PreprocessConfig(**recipe)))
    lat = np.array(enc(params, pre(jnp.asarray(raw[..., None].astype(np.float32) / 255.0))))
    lat /= np.linalg.norm(lat, axis=1, keepdims=True)
    dictionary = np.concatenate([lat, rng.normal(size=(30, 8)).astype(np.float32)])
    dictionary /= np.linalg.norm(dictionary, axis=1, keepdims=True)
    orients = rng.uniform([10, 20, 10], [170, 160, 170], size=(len(dictionary), 3))
    knobs = dict(top_n=5, min_required_matches=1, batch_size=8)
    want = JaxPipeline(jm, params, dictionary, orients,
                       preprocess=jpp.PreprocessConfig(**recipe), **knobs)(raw)
    port = IndexPipeline(tm, dictionary, orients, preprocess=tpp.PreprocessConfig(**recipe),
                         device="cpu", **knobs)
    got = port(raw)
    np.testing.assert_array_equal(got.indices[:, 0], np.arange(10))  # each its own row
    np.testing.assert_array_equal(got.indices[:, 0], want.indices[:, 0])
    np.testing.assert_allclose(got.scores, want.scores, atol=tol)
    np.testing.assert_allclose(port.encode(raw), np.asarray(enc(params, pre(
        jnp.asarray(raw[..., None].astype(np.float32) / 255.0)))), atol=tol * 10)
