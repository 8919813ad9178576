"""The port stands alone: no JAX imports, and no silent CPU fallback."""

import ast
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


def _port_files():
    return sorted((ROOT / "latice_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_unported_options_raise():
    """What the port still refuses: ``mesh`` (slice C), the DB's ``native``
    engine (slice E) and the query CLI's ``--nlpar``, ``--refine`` and
    ``--hough-iq`` (slice D)."""
    from latice_tpu_torch import (
        IndexPipeline,
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
        VariationalAutoEncoderRawData,
    )
    from latice_tpu_torch.cli.index import main as index_main

    model = VariationalAutoEncoderRawData(inplanes=2, latent_dim=4, n_stages=3)
    vecs, orients = np.eye(4, dtype=np.float32), np.zeros((4, 3))
    with pytest.raises(ValueError, match="later slice"):
        IndexPipeline(model, vecs, orients, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="later slice"):
        TorchLatentVectorDatabase(LatentVectorDatabaseConfig(engine="native"))
    query = ["query", "--patterns", "p.npy", "--db", "none.npz", "--device", "cpu"]
    for flags in (["--nlpar", "2.0"], ["--refine", "10"], ["--hough-iq"]):
        with pytest.raises(SystemExit, match="later slice"):
            index_main(query + flags)
    with pytest.raises(ValueError, match="unknown engine"):
        IndexPipeline(model, vecs, orients, device="cpu", engine="hnsw")


@pytest.mark.parametrize(
    "kw",
    [
        dict(engine="approx"),
        dict(engine="int8"),
        dict(search_dtype="bfloat16"),
        dict(preprocess=lambda x: x),
        dict(preprocess="config"),
    ],
    ids=["approx", "int8", "bfloat16", "preprocess_callable", "preprocess_config"],
)
def test_ported_options_accepted(kw):
    """The engines, bf16 search and preprocessing of this slice build and
    index on the CPU."""
    from latice_tpu_torch import IndexPipeline, VariationalAutoEncoderRawData
    from latice_tpu_torch.data import PreprocessConfig

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
