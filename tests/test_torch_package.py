"""The port stands alone: no JAX imports, and no silent CPU fallback."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "latice_tpu")


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


def _example_twins():
    return sorted(p for p in (ROOT / "examples").glob("*_torch.py") if p.stem != "common_torch")


def _port_files():
    return (sorted((ROOT / "latice_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 15
    assert all(f.exists() for f in files)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_example_twins_import_no_jax_script():
    """The seven `examples/*_torch.py` twins exist, and they and the
    module they share, `examples/common_torch.py`, import from `examples`
    only each other, never the JAX scripts beside them."""
    twins = _example_twins()
    assert len(twins) == 7, twins
    for path in twins + [ROOT / "examples" / "common_torch.py"]:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.ImportFrom) and node.module == "examples":
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("examples."):
                names = [node.module.split(".", 1)[1]]
            elif isinstance(node, ast.Import):
                names = [a.name.split(".", 1)[1] for a in node.names
                         if a.name.startswith("examples.")]
            else:
                continue
            assert all(n.endswith("_torch") for n in names), f"{path} imports {names}"


def _cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")


def test_resolve_device_refuses_missing_cuda():
    from latice_tpu_torch import resolve_device

    _cuda_absent()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_entry_points_default_to_cuda():
    from latice_tpu_torch import (
        IndexPipeline,
        IndexService,
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
        VariationalAutoEncoderRawData,
    )

    _cuda_absent()
    model = VariationalAutoEncoderRawData(inplanes=2, latent_dim=4, n_stages=3)
    vecs = np.eye(4, dtype=np.float32)
    orients = np.zeros((4, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IndexPipeline(model, vecs, orients)
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path="/nonexistent/none.npz", dimension=4)
    )
    db.add_vectors(vecs, orients)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IndexService(model, db)

    from latice_tpu_torch import load_checkpoint
    from latice_tpu_torch.train import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_checkpoint("/nonexistent/vae.pt")

    from latice_tpu_torch.data import estimate_noise_sigma, nlpar_denoise
    from latice_tpu_torch.index import (
        PatternDictionaryIndexer,
        StreamedPatternDI,
        build_pattern_dictionary,
    )
    from latice_tpu_torch.sim import refine_candidates, refine_orientations, simulate_patterns

    pats, quats = np.zeros((4, 16, 16), np.float32), np.tile([1.0, 0, 0, 0], (4, 1))
    for call in (
        lambda: simulate_patterns(quats),
        lambda: refine_orientations(pats, quats),
        lambda: refine_candidates(pats, quats[:, None]),
        lambda: nlpar_denoise(pats.reshape(2, 2, 16, 16)),
        lambda: estimate_noise_sigma(pats.reshape(2, 2, 16, 16)),
        lambda: build_pattern_dictionary(pats),
        lambda: build_pattern_dictionary(torch.from_numpy(pats)),
        lambda: PatternDictionaryIndexer(pats, orients),
        lambda: StreamedPatternDI(pats.reshape(4, -1), orients),
        lambda: IndexService(None, None, di_dictionary=(pats, orients)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

    from latice_tpu_torch.data import BandDetector
    from latice_tpu_torch.index import HoughIndexer
    from latice_tpu_torch.sim import (
        DetectorGeometry,
        calibrate_geometry,
        calibrate_scan_geometry,
        cubic_reflectors,
    )

    from latice_tpu_torch import crystal

    euler = np.zeros((2, 2, 3))
    for call in (
        lambda: crystal.misorientation_maps(euler),
        lambda: crystal.grain_statistics(euler, np.zeros((2, 2), np.int64)),
        lambda: crystal.random_disorientation_angles(n=4),
        lambda: crystal.classify_csl_boundaries(euler),
        lambda: crystal.schmid_factors(euler),
        lambda: crystal.texture_component_fractions(euler),
        lambda: crystal.make_odf(euler),
        lambda: crystal.gnd_density(euler),
        lambda: crystal.reconstruct_parents(euler[0], np.zeros((0, 2), np.int64)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

    geom = DetectorGeometry(shape=(16, 16))
    for call in (
        lambda: BandDetector(height=16, width=16, n_theta=8, n_rho=8),
        lambda: HoughIndexer(cubic_reflectors(), geom),
        lambda: calibrate_geometry(pats, quats, geom),
        lambda: calibrate_scan_geometry(pats, quats, np.zeros((4, 2)), geom),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

    from latice_tpu_torch.cli.index import main as index_main

    for argv in (
        ["sample", "--out", "/nonexistent/grid.txt"],
        ["simulate", "--angles", "/nonexistent/grid.txt"],
        ["di", "--dict-patterns", "d.npy", "--dict-angles", "a.txt", "--patterns", "p.npy"],
        ["quality", "--patterns", "/nonexistent/p.npy"],
        ["hough", "--patterns", "/nonexistent/p.npy"],
        ["calibrate", "--patterns", "/nonexistent/p.npy", "--orientations", "o.npy"],
        ["analyze", "--orientations", "/nonexistent/o.npy", "--grid", "2", "2"],
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            index_main(argv)


def test_kernel_wrappers_never_run_plain_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    meta device stands in for a CUDA tensor on a machine without one."""
    from latice_tpu_torch.ops import (
        cosine_topk_fused,
        instance_norm_leaky_relu,
        instance_norm_leaky_relu_backward,
        stage0_fused,
    )

    x = torch.empty((2, 3, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        instance_norm_leaky_relu(x)
    stats = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        instance_norm_leaky_relu_backward(x, stats, stats, torch.empty_like(x))
    q = torch.empty((2, 16), device="meta")
    d = torch.empty((40, 16), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        cosine_topk_fused(q, d, 5)
    w1, w2, b = (torch.empty(s, device="meta") for s in ((32, 1, 3, 3), (32, 32, 3, 3), (32,)))
    with pytest.raises(ValueError, match="unsupported device"):
        stage0_fused(torch.empty((2, 1, 16, 16), device="meta"), w1, b, w2, b)
    assert stage0_fused.launches == 0
    assert instance_norm_leaky_relu.launches == 0
    assert instance_norm_leaky_relu_backward.launches == 0
    assert cosine_topk_fused.launches == 0


def test_unported_options_raise(tmp_path):
    """What the port still refuses: a ``mesh`` that is not a
    `parallel.Mesh` (tests/test_torch_parallel_paths.py runs the real one;
    nothing else refuses since the multi-device slice). The DB's
    ``native`` engine, once refused here, answers on the host (it raises
    ``ImportError`` only where g++ cannot build it). ``--sphere-master``
    and ``/sphere``, and
    ``strain``, ``--strain-ref`` and ``/strain``, once refused here, run:
    each flag alone builds a zero-training service whose plane answers, and
    ``/strain`` without a reference answers 400 with the JAX message."""
    from latice_tpu_torch import (
        IndexPipeline,
        IndexService,
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
        VariationalAutoEncoderRawData,
    )
    from latice_tpu_torch.cli import serve as serve_cli
    from latice_tpu_torch.cli.index import main as index_main

    model = VariationalAutoEncoderRawData(inplanes=2, latent_dim=4, n_stages=3)
    vecs, orients = np.eye(4, dtype=np.float32), np.zeros((4, 3))
    with pytest.raises(TypeError, match="Mesh"):
        IndexPipeline(model, vecs, orients, device="cpu", mesh=object())
    from latice_tpu_torch import native

    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=str(tmp_path / "n.npz"), dimension=4,
                                   engine="native"))
    db.add_vectors(vecs, orients)
    if native.available():
        scores, indices = db.query_similar(vecs[2], n_results=2)
        assert indices[0] == 2 and scores[0] == pytest.approx(1.0)
    else:
        with pytest.raises(ImportError, match="native library"):
            db.query_similar(vecs[2], n_results=2)
    ref = np.random.default_rng(1).random((128, 128)).astype(np.float32)
    np.save(tmp_path / "p.npy", np.stack([ref, np.roll(ref, 1, axis=1)]))
    with pytest.raises(SystemExit, match="out of range"):
        index_main(["strain", "--patterns", str(tmp_path / "p.npy"), "--ref", "3",
                    "--device", "cpu"])
    index_main(["strain", "--patterns", str(tmp_path / "p.npy"), "--ref", "0", "--remap", "0",
                "--out", str(tmp_path / "s.npz"), "--device", "cpu"])
    # A one-pixel roll of the columns: every ROI moves by one column.
    np.testing.assert_allclose(np.load(tmp_path / "s.npz")["shifts_px"][1], [[0.0, 1.0]] * 21,
                               atol=0.05)
    np.save(tmp_path / "ref.npy", ref)
    strain = serve_cli.build_service(serve_cli.parse_args(
        ["--hough", "--strain-ref", str(tmp_path / "ref.npy"), "--device", "cpu"]))
    assert strain.health()["planes"] == ["hough", "strain"] and strain.pipeline is None
    from latice_tpu_torch.sim import make_kinematical_master

    np.save(tmp_path / "m.npy", make_kinematical_master(size=65))
    sphere = serve_cli.build_service(serve_cli.parse_args(
        ["--sphere-master", str(tmp_path / "m.npy"), "--sphere-bandwidth", "8",
         "--device", "cpu"]))
    assert sphere.health()["planes"] == ["sphere"] and sphere.pipeline is None
    reply = sphere.sphere(np.random.default_rng(0).random((2, 128, 128), np.float32))
    assert reply["n"] == 2 and len(reply["orientations"]) == 2
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path="/nonexistent/none.npz", dimension=4), device="cpu"
    )
    db.add_vectors(vecs, orients)
    # /strain without a strain reference answers 400 with this message.
    with pytest.raises(ValueError, match="without a strain reference"):
        IndexService(model, db, device="cpu").strain(np.zeros((1, 32, 32), np.float32))
    with pytest.raises(ValueError, match="unknown engine"):
        IndexPipeline(model, vecs, orients, device="cpu", engine="hnsw")


def _query_with(flags, tmp_path):
    """``cli.index query`` with ``flags`` over a 4-pattern kinematical
    dictionary (its simulate provenance beside it) at inplanes 2; the
    orientations it saves."""
    from latice_tpu_torch.cli.index import main as index_main

    angles = tmp_path / "a.txt"
    angles.write_text("eu\n4\n10 20 30\n40 50 60\n70 80 20\n15 35 55\n")
    pats = str(tmp_path / "d.npy")
    small = ["--inplanes", "2", "--latent-dim", "4", "--batch-size", "4", "--device", "cpu"]
    index_main(["simulate", "--angles", str(angles), "--out", pats, "--max-hkl", "2",
                "--min-d", "1.0", "--device", "cpu"])
    db = str(tmp_path / "db.npz")
    index_main(["build", "--patterns", pats, "--angles", str(angles), "--db", db] + small)
    out = str(tmp_path / "o.npy")
    index_main(["query", "--patterns", pats, "--db", db, "--out", out, "--top-n", "2",
                "--min-matches", "1"] + small + flags)
    return np.load(out)


@pytest.mark.parametrize(
    "kw",
    [
        dict(engine="approx"),
        dict(engine="int8"),
        dict(search_dtype="bfloat16"),
        dict(preprocess=lambda x: x),
        dict(preprocess="config"),
        dict(query=["--nlpar", "2.0", "--scan-grid", "2", "2"]),
        dict(query=["--refine", "3"]),
        dict(query=["--hough-iq"]),
    ],
    ids=["approx", "int8", "bfloat16", "preprocess_callable", "preprocess_config",
         "query_nlpar", "query_refine", "query_hough_iq"],
)
def test_ported_options_accepted(kw, tmp_path, capsys):
    """The engines, bf16 search and preprocessing build and index on the
    CPU, and the query CLI's ``--nlpar``, ``--refine`` and ``--hough-iq``
    index."""
    from latice_tpu_torch import IndexPipeline, VariationalAutoEncoderRawData
    from latice_tpu_torch.data import PreprocessConfig

    if "query" in kw:
        with torch.random.fork_rng(devices=[]):
            got = _query_with(kw["query"], tmp_path)
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got.shape == (4, 3) and np.isfinite(got).all()
        if "--hough-iq" in kw["query"]:
            iq = np.load(summary["hough_iq_out"])
            assert iq.shape == (4,) and np.isfinite(iq).all()
        return
    if kw.get("preprocess") == "config":
        kw = dict(preprocess=PreprocessConfig(hot_pixel_threshold=5.0, normalize="minmax"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = VariationalAutoEncoderRawData(inplanes=2, latent_dim=4, n_stages=3)
    vecs, orients = np.eye(4, dtype=np.float32), np.zeros((4, 3))
    pipe = IndexPipeline(model, vecs, orients, top_n=2, min_required_matches=1, device="cpu",
                         **kw)
    res = pipe(np.random.default_rng(0).uniform(size=(3, 32, 32)).astype(np.float32))
    assert res.indices.shape == (3, 2) and np.isfinite(res.best_orientation).all()
