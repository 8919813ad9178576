"""The port's public surface against the JAX package's: ``crystal.__all__``,
the ``index`` subcommands, the analysis utilities, and the quaternion and
symmetry functions the analysis plane added, on seeded inputs (CPU).

Tolerances: float32 functions within 1e-6 (one or two ulps of a unit
quaternion), host tables equal.
"""

import argparse
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import latice_tpu.crystal as jc
import latice_tpu.utils as ju
from latice_tpu_torch import crystal as tc
from latice_tpu_torch import utils as tu


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _subcommands(modules) -> dict:
    """Each module registered on one parser: {subcommand: its parser}."""
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd")
    common = argparse.ArgumentParser(add_help=False)
    for mod in modules:
        mod.register(sub, common)
    return sub.choices


def test_crystal_all_equals_jax():
    assert tc.__all__ == jc.__all__
    assert all(hasattr(tc, name) for name in tc.__all__)


def test_index_subcommands_equal_jax():
    """Every subcommand of the JAX package's ``index.py`` is the port's, and
    ``analyze`` takes every JAX flag with its default, plus ``--device``."""
    names = ("_analyze_cmds", "_band_cmds", "_db_cmds", "_di_cmds", "_sim_cmds",
             "_sphere_cmds", "_strain_cmds")
    want = _subcommands([importlib.import_module(f"latice_tpu.cli.{n}") for n in names])
    got = _subcommands([importlib.import_module(f"latice_tpu_torch.cli.{n}") for n in names])
    assert "analyze" in got and set(got) == set(want)
    jax_flags = {a.dest: a.default for a in want["analyze"]._actions}
    port_flags = {a.dest: a.default for a in got["analyze"]._actions}
    assert set(port_flags) - set(jax_flags) == {"device"}
    assert {k: port_flags[k] for k in jax_flags} == jax_flags


def test_utils_exports():
    for name in ("ColorKeyGenerator", "compute_pole_figure", "plot_pole_figure",
                 "plot_odf_sections", "get_color_key", "plot_detection", "plot_latent",
                 "figure_to_array", "log_fig"):
        assert name in tu.__all__ and name in ju.__all__
    assert tu.__all__ == ju.__all__
    assert all(hasattr(tu, name) for name in tu.__all__)


def test_quaternion_gaps_match_jax():
    rng = np.random.default_rng(0)
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0, np.pi, 16)
    got = tc.from_axis_angle(torch.as_tensor(axis, dtype=torch.float32),
                             torch.as_tensor(angle, dtype=torch.float32)).numpy()
    want = np.asarray(jc.from_axis_angle(jnp.asarray(axis, jnp.float32),
                                         jnp.asarray(angle, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_array_equal(tc.quat_to_scipy(torch.as_tensor(q)).numpy(),
                                  np.asarray(jc.quat_to_scipy(jnp.asarray(q))))
    np.testing.assert_array_equal(tc.quat_from_scipy(torch.as_tensor(q)).numpy(),
                                  np.asarray(jc.quat_from_scipy(jnp.asarray(q))))
    # A cluster of rotations: eigh and the power iteration agree with JAX.
    cluster = np.array(jc.from_axis_angle(jnp.asarray(axis, jnp.float32),
                                          jnp.asarray(angle * 0.05, jnp.float32)))
    w = rng.uniform(0.5, 1.0, 16).astype(np.float32)
    for method in ("eigh", "power"):
        got = tc.quat_mean(torch.as_tensor(cluster), torch.as_tensor(w), method=method).numpy()
        want = np.asarray(jc.quat_mean(jnp.asarray(cluster), jnp.asarray(w), method=method))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_symmetry_gaps_match_jax():
    np.testing.assert_array_equal(tc.cubic_symmetry_quats().numpy(),
                                  np.asarray(jc.cubic_symmetry_quats()))
    assert tc.cubic_symmetry_quats(dtype=torch.float64).dtype == torch.float64
    from latice_tpu.crystal import symmetry as js
    from latice_tpu_torch.crystal import symmetry as ts

    for name in ("PI_OVER_180", "K_180_OVER_PI", "SQRT2_INV", "SQRT3_INV", "USE_INVERSION"):
        assert getattr(ts, name) == getattr(js, name)
    axes = np.random.default_rng(1).normal(size=(5, 3))
    for group in ("432", "622", "23"):
        np.testing.assert_array_equal(ts.apply_symmetry_to_axes(axes, group),
                                      js.apply_symmetry_to_axes(axes, group))
    np.testing.assert_array_equal(tc.sample_so3_halton(32), jc.sample_so3_halton(32))
