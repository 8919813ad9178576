"""The six demo twins, examples/*_demo_torch.py, against their JAX demos.

Each JAX demo compiles for tens of seconds on the CPU (raw_data 39 s,
full_workflow 49 s at its smallest flags, end_to_end 28 s of training),
beyond this suite's budget. So the deterministic demos are held to the
lines their JAX demo prints, recorded on the CPU (JAX 0.9.0) with the
command named beside each; the twins start from the same initial weights
(`jax_init_state_dict`, held to JAX's in tests/test_torch_accuracy_gate.py)
and print:

* raw_data (the defaults): every line, equal;
* full_workflow (``--grid 4 --grains 2``, where the JAX demo's first
  assert fails too): every line, equal (the ``.ang`` path aside), and the
  same assertion;
* parent_reconstruction (``--size 48``): every line equal but the mean
  fit, within 0.01 degrees (per-grain fits of ~0.01-0.05 degrees are f32
  arccos near 1, whose resolution is ~0.03 degrees; 0.0016 measured);
* end_to_end (``--inplanes 2``): the trainer draws its own weights, so the
  trained figures are the port's: the dictionary files equal the JAX demo's
  bit for bit, 250 vectors, the batch success and the `PhaseTimer` keys as
  the JAX demo's.

The two trained demos run at a small size (an 8-point grid, 2 steps at B=8,
inplanes 2, f32, an 8x8 scan), and the stages after training are held live
against the JAX package on the twin's own outputs: orientation_map's grain
labels, ECD, mean GOS (0.01 degrees: spreads of ~0.02 degrees are f32
arccos near 1; 0.002 measured), texture index (1e-4 relative) and Schmid
factors (1e-6); multiphase's phase-labeled pipeline on the twin's trained
weights (carried into JAX by `torch_state_dict_to_flax`: indices equal but
at near ties of 1e-5, phases and success equal) and its multi-phase grain
labels. The training loop itself is held to JAX's in
tests/test_torch_accuracy_gate.py.
"""

import contextlib
import io
import warnings

import numpy as np
import pytest
import torch

from examples import end_to_end_demo_torch, full_workflow_demo_torch, multiphase_demo_torch
from examples import orientation_map_demo_torch, parent_reconstruction_demo_torch
from examples import raw_data_demo_torch

SMALL = dict(batch=8, inplanes=2, precision="32")

# python examples/raw_data_demo.py --cpu
JAX_RAW_DATA = """\
scan 4x24, dictionary 24 entries, noise 0.015, untrained encoder
naive (no correction)    top-1 acc   2.1%   median |err|   74.26 deg
preprocess               top-1 acc  59.4%   median |err|    0.00 deg
preprocess + NLPAR       top-1 acc  78.1%   median |err|    0.00 deg
OK: correction recovers the degraded scan"""

# python examples/full_workflow_demo.py --cpu --grid 4 --grains 2
JAX_FULL_WORKFLOW = """\
dictionary: 54 FZ orientations at 14 deg, simulated
indexing: top-1 accuracy 25.0% (untrained encoder)
refined+reranked: 68.8% of pixels correct (re-rank overruled the encoder on 62.5%); \
median error 0.023 deg, ncc median 0.999
grains: truth 2, found 5; majority-partition agreement 75.0%
export: (16 rows) — opens in MTEX/OIM"""
JAX_FULL_WORKFLOW_ASSERT = "re-ranked refinement should win"

# python examples/parent_reconstruction_demo.py --cpu --size 48
JAX_PARENT = dict(n_child=33, n_parents=6, mean_fit_deg=0.04520403, agreement="100.0%")
PARENT_FIT_ATOL_DEG = 0.01
GOS_ATOL_DEG = 0.01  # grain orientation spreads of ~0.02 degrees: f32 arccos near 1

# python examples/end_to_end_demo.py --cpu --inplanes 2
JAX_END_TO_END = dict(vectors=250, batch_success="100%",
                      phases=("build_dictionary", "index_single", "train"))


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


def _run(main, *args, **kw):
    """``main``'s return value and printed lines (warnings of empty medians
    silenced)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = main(*args, **kw)
    return out, buf.getvalue().splitlines()


@pytest.mark.parametrize("name", ["accuracy_benchmark", "end_to_end_demo", "orientation_map_demo",
                                  "multiphase_demo", "raw_data_demo", "full_workflow_demo",
                                  "parent_reconstruction_demo"])
def test_twins_run_on_cuda_unless_asked(name):
    """Without ``--cpu`` (the gate: ``device=``) a twin runs on ``cuda``,
    which raises here, before any work: no fallback to the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    main = importlib.import_module(f"examples.{name}_torch").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main() if name == "accuracy_benchmark" else main([])


def test_raw_data_prints_the_jax_demo_lines():
    out, lines = _run(raw_data_demo_torch.main, ["--cpu"])
    assert lines == JAX_RAW_DATA.splitlines()
    assert out["preprocess + NLPAR"]["top1"] > 0.7


def test_full_workflow_prints_the_jax_demo_lines():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(AssertionError,
                                                        match=JAX_FULL_WORKFLOW_ASSERT):
        full_workflow_demo_torch.main(["--cpu", "--grid", "4", "--grains", "2"])
    lines = buf.getvalue().splitlines()
    export = lines[-1]
    assert export.startswith("export: ")
    assert export.endswith(".ang (16 rows) — opens in MTEX/OIM")
    lines[-1] = "export: (16 rows) — opens in MTEX/OIM"
    assert lines == JAX_FULL_WORKFLOW.splitlines()


def test_parent_reconstruction_matches_jax_demo(tmp_path):
    out, lines = _run(parent_reconstruction_demo_torch.main,
                      ["--cpu", "--size", "48", "--out", str(tmp_path / "pr.png")])
    assert out["n_child"] == JAX_PARENT["n_child"]
    assert out["n_parents"] == JAX_PARENT["n_parents"]
    assert abs(out["mean_fit_deg"] - JAX_PARENT["mean_fit_deg"]) <= PARENT_FIT_ATOL_DEG
    assert lines[0] == f"child segmentation: {JAX_PARENT['n_child']} lath grains"
    assert lines[2] == f"pixel agreement with generating truth: {JAX_PARENT['agreement']}"


def test_end_to_end_runs_the_jax_demo_flow(tmp_path):
    from examples import end_to_end_demo as jax_demo

    out, lines = _run(end_to_end_demo_torch.main,
                      ["--cpu", "--workdir", str(tmp_path / "port"), "--inplanes", "2"])
    (tmp_path / "jax").mkdir()
    jax_demo.make_synthetic_dictionary(tmp_path / "jax")
    for name in ("dict_patterns.npy", "dict_angles.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert out["vectors"] == JAX_END_TO_END["vectors"]
    assert f"   {JAX_END_TO_END['vectors']} vectors" in lines
    assert any(line.endswith(f"success {JAX_END_TO_END['batch_success']}") for line in lines)
    assert {k.split("/")[0] for k in out["phases"]} == set(JAX_END_TO_END["phases"])
    assert np.isfinite(out["final_loss"]) and out["single_success"]


@pytest.fixture(scope="module")
def orientation_map(tmp_path_factory):
    out, lines = _run(orientation_map_demo_torch.main,
                      ["--cpu", "--side", "8", "--out",
                       str(tmp_path_factory.mktemp("om") / "map.png")],
                      grid=8, steps=2, odf_samples=256, **SMALL)
    return out, lines


def test_grain_map_is_the_jax_demos():
    from examples import orientation_map_demo as jax_demo

    for args in ((48, 25, [0, 40, 0], [30, 70, 30], 3), (32, 20, [0, 40, 0], [30, 70, 30], 3)):
        for got, want in zip(orientation_map_demo_torch.make_grain_map(*args),
                             jax_demo.make_grain_map(*args)):
            np.testing.assert_array_equal(got, want)


def test_orientation_map_analysis_matches_jax(orientation_map):
    from latice_tpu.crystal import (
        grain_statistics,
        label_grains,
        make_odf,
        misorientation_maps,
        schmid_factors,
        texture_index,
    )

    out, lines = orientation_map
    res = out["result"]
    euler_grid = res.best_orientation.reshape(8, 8, 3)
    labels, n_grains = label_grains(misorientation_maps(euler_grid, group="432"),
                                    threshold_deg=5.0)
    assert n_grains == out["n_grains"]
    np.testing.assert_array_equal(out["labels"], labels)
    stats = grain_statistics(euler_grid, labels, group="432")
    assert out["mean_ecd_px"] == pytest.approx(float(stats.equivalent_diameter_px.mean()))
    assert out["mean_gos_deg"] == pytest.approx(float(stats.gos_deg.mean()), abs=GOS_ATOL_DEG)
    odf = make_odf(res.best_orientation[res.success], halfwidth_deg=15.0)
    assert out["texture_index"] == pytest.approx(float(texture_index(odf, n=256)), rel=1e-4)
    sf = schmid_factors(euler_grid, (0.0, 0.0, 1.0), family="fcc")
    assert out["schmid_mean"] == pytest.approx(float(np.mean(sf.max_factor)), abs=1e-6)
    assert out["schmid_max"] == pytest.approx(float(np.max(sf.max_factor)), abs=1e-6)
    assert any(line.startswith("grain segmentation: ") for line in lines)


@pytest.fixture(scope="module")
def multiphase():
    return _run(multiphase_demo_torch.main, ["--cpu", "--side", "8", "--steps", "2"], grid=6,
                **SMALL)


def test_multiphase_pipeline_and_grains_match_jax(multiphase):
    import jax

    from latice_tpu.crystal import label_grains, misorientation_maps_multiphase
    from latice_tpu.index import IndexPipeline as JaxPipeline
    from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
    from latice_tpu.models.torch_import import torch_state_dict_to_flax

    out, lines = multiphase
    res, model = out["result"], out["model"]
    params = torch_state_dict_to_flax(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, inplanes=2,
        latent_dim=16)
    want = JaxPipeline(
        JaxVAE(inplanes=2, latent_dim=16), jax.tree.map(np.asarray, params),
        out["vectors"], out["dict_angles"], top_n=10, orientation_threshold=5.0,
        min_required_matches=3, batch_size=64, dictionary_phases=out["dict_phases"],
        phase_symmetries=multiphase_demo_torch.PHASE_GROUPS,
    )(out["scan"][..., None])
    differ = (res.indices != want.indices).any(axis=1)
    gaps = np.abs(np.diff(want.scores, axis=1)).min(axis=1)
    assert not (differ & (gaps > 1e-5)).any()
    np.testing.assert_allclose(res.scores, want.scores, rtol=0, atol=1e-5)
    same = ~differ
    np.testing.assert_array_equal(res.phase[same], want.phase[same])
    np.testing.assert_array_equal(res.success[same], want.success[same])
    labels, n_grains = label_grains(misorientation_maps_multiphase(
        res.best_orientation.reshape(8, 8, 3), np.asarray(res.phase).reshape(8, 8),
        ["432", "622"]), threshold_deg=5.0)
    assert n_grains == out["n_grains"]
    np.testing.assert_array_equal(out["labels"], labels)
    assert any(line.startswith("indexed 64 pixels in ") for line in lines)
