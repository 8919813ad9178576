"""The port's bridge to the host runtime ``native/latice_native.cpp``
against the JAX package's (``latice_tpu.native``) on the same inputs, and
what it feeds: the DB's ``engine="native"``, the angle-file parser and the
``.ang`` / ``.ctf`` row formatters (CPU; dictionaries of at most 1,000
rows).

Top-k indices, parsed angles and formatted bytes are held equal; scores
within 1e-6 of the exact engine's.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from latice_tpu import native as jax_native
from latice_tpu.data import parse_angle_file as jax_parse_angle_file
from latice_tpu.data import write_ang as jax_write_ang
from latice_tpu.data import write_ctf as jax_write_ctf
from latice_tpu_torch import native
from latice_tpu_torch.data import export, parse_angle_file, write_ang, write_ctf
from latice_tpu_torch.index import (
    DenseIndexResult,
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain for the native runtime"
)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    dictionary = rng.normal(size=(1000, 16)).astype(np.float32)
    queries = (dictionary[rng.integers(0, 1000, 37)]
               + 0.05 * rng.normal(size=(37, 16))).astype(np.float32)
    orients = rng.uniform([0, 0, 0], [360, 180, 360], size=(1000, 3))
    return dict(dictionary=dictionary, queries=queries, orients=orients)


def test_library_is_the_ports_own():
    """Built under the port's gitignored build directory, keyed by source,
    flags and CPU, never the JAX package's ``native/liblatice_native.so``."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("liblatice_native-") and path != jax_native._LIB
    assert native.build() == path


def test_topk_equals_jax(data):
    got = native.cosine_topk_native(data["queries"], data["dictionary"], 20)
    want = jax_native.cosine_topk_native(data["queries"], data["dictionary"], 20)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float64 and got[1].dtype == np.int64
    # k beyond the dictionary is cut to it, as in JAX.
    small = native.cosine_topk_native(data["queries"][:2], data["dictionary"][:5], 20)
    assert small[0].shape == (2, 5)
    with pytest.raises(ValueError, match="bad shapes"):
        native.cosine_topk_native(data["queries"][:, :8], data["dictionary"], 5)


@pytest.mark.parametrize("engine_k", [1, 20])
def test_native_engine_equals_exact(data, tmp_path, engine_k):
    dbs = {}
    for engine in ("native", "device"):
        cfg = LatentVectorDatabaseConfig(npz_path=str(tmp_path / f"{engine}.npz"), engine=engine)
        dbs[engine] = TorchLatentVectorDatabase(cfg, device="cpu")
        dbs[engine].add_vectors(data["dictionary"], data["orients"])
    got = dbs["native"].query_similar_batch(data["queries"], engine_k)
    want = dbs["device"].query_similar_batch(data["queries"], engine_k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    assert got[0].dtype == np.float64 and got[1].dtype == np.int64
    dense = {k: db.find_best_orientations_dense(data["queries"], top_n=engine_k,
                                                min_required_matches=1)
             for k, db in dbs.items()}
    np.testing.assert_array_equal(dense["native"]["indices"], dense["device"]["indices"])
    np.testing.assert_array_equal(dense["native"]["success"], dense["device"]["success"])
    np.testing.assert_allclose(dense["native"]["mean_orientation"],
                               dense["device"]["mean_orientation"], atol=1e-4)


def test_native_engine_raises_without_toolchain(data, tmp_path, monkeypatch):
    """No fallback: a library that cannot load raises ImportError, as the
    JAX DB's native engine does."""
    monkeypatch.setattr(native, "_load", lambda: None)
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(
        npz_path=str(tmp_path / "n.npz"), engine="native"), device="cpu")
    db.add_vectors(data["dictionary"], data["orients"])
    with pytest.raises(ImportError, match="native library"):
        db.query_similar(data["queries"][0])


def _angle_file(path, rows: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"zxz\n{len(rows)}\n")
        np.savetxt(f, rows, fmt="%.6f")


def test_parse_angle_file_equals_jax(tmp_path):
    rows = np.random.default_rng(1).uniform(0, 360, (257, 3))
    path = tmp_path / "angles.txt"
    _angle_file(path, rows)
    got = native.parse_angle_file_native(path)
    np.testing.assert_array_equal(got, jax_native.parse_angle_file_native(path))
    np.testing.assert_array_equal(parse_angle_file(path), jax_parse_angle_file(path))
    np.testing.assert_allclose(got, rows, atol=5e-7)
    with pytest.raises(FileNotFoundError):
        native.parse_angle_file_native(tmp_path / "missing.txt")
    bad = tmp_path / "bad.txt"
    bad.write_text("zxz\n1\n1.0 2.0 nope\n")
    with pytest.raises(ValueError, match="rotation angles"):
        parse_angle_file(bad)
    with pytest.raises(ValueError, match="rotation angles"):
        jax_parse_angle_file(bad)


def test_parser_falls_through_without_toolchain(tmp_path, monkeypatch):
    """A missing toolchain falls through to the Python parser, the same
    array (JAX's order: a missing file or a bad file still raises)."""
    rows = np.random.default_rng(2).uniform(0, 360, (9, 3))
    path = tmp_path / "angles.txt"
    _angle_file(path, rows)
    want = parse_angle_file(path)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(parse_angle_file(path), want)


@pytest.fixture(scope="module")
def result():
    """A dense result of 1,000 points with failures, two phases and
    negative angles (``nan_to_num`` paths included)."""
    rng = np.random.default_rng(3)
    n = 1000
    success = rng.uniform(size=n) > 0.1
    best = rng.uniform(-10, 360, (n, 3))
    best[~success & (rng.uniform(size=n) > 0.5)] = np.nan
    return DenseIndexResult(
        mean_orientation=np.where(success[:, None], best, np.nan),
        best_orientation=best,
        success=success,
        n_similar=rng.integers(0, 21, n),
        indices=rng.integers(0, 1000, (n, 5)),
        scores=np.sort(rng.uniform(0.4, 1.0, (n, 5)), axis=1)[:, ::-1],
        phase=rng.integers(0, 2, n),
    )


def test_ang_and_ctf_rows_byte_equal(result, tmp_path):
    """The native rows equal the JAX package's native rows and the port's
    Python loop, byte for byte; the whole files equal JAX's."""
    for writer, jax_writer, fmt in ((write_ang, jax_write_ang, "format_ang_rows_native"),
                                    (write_ctf, jax_write_ctf, "format_ctf_rows_native")):
        suffix = writer.__name__[-3:]
        writer(str(tmp_path / f"port.{suffix}"), result, grid=(25, 40), step=0.5)
        jax_writer(str(tmp_path / f"jax.{suffix}"), result, grid=(25, 40), step=0.5)
        with mock.patch.object(native, fmt, side_effect=ImportError("no toolchain")):
            writer(str(tmp_path / f"python.{suffix}"), result, grid=(25, 40), step=0.5)
        port = (tmp_path / f"port.{suffix}").read_bytes()
        assert port == (tmp_path / f"jax.{suffix}").read_bytes()
        assert port == (tmp_path / f"python.{suffix}").read_bytes()
        assert len(port.splitlines()) > 1000


def test_row_formatters_equal_jax_on_columns():
    rng = np.random.default_rng(4)
    n = 333
    e = rng.uniform(-7, 7, (n, 3))
    x, y = rng.uniform(0, 100, n), rng.uniform(0, 100, n)
    iq, ci = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    phase, k = rng.integers(0, 3, n), rng.integers(0, 40, n).astype(np.float64)
    got = native.format_ang_rows_native(e, x, y, iq, ci, phase, k)
    assert got == jax_native.format_ang_rows_native(e, x, y, iq, ci, phase, k)
    assert got == export._ang_rows_python(e, x, y, iq, ci, phase, k)
    bands, err, mad = rng.integers(0, 12, n), rng.integers(0, 4, n), rng.uniform(0, 1, n)
    got = native.format_ctf_rows_native(phase, x, y, bands, err, e, mad)
    assert got == jax_native.format_ctf_rows_native(phase, x, y, bands, err, e, mad)
    assert got == export._ctf_rows_python(phase, x, y, bands, err, e, mad)
    # Columns of another length are refused before the C side reads them.
    with pytest.raises(ValueError, match="columns"):
        native.format_ang_rows_native(e, x[:-1], y, iq, ci, phase, k)
    with pytest.raises(ValueError, match="columns"):
        native.format_ctf_rows_native(phase, x, y, bands, err, e[:, :2], mad)
    # A row that outgrows its buffer raises ValueError; write_ang then
    # takes the Python loop, which has no limit.
    huge = np.full((1, 3), 1e200)
    with pytest.raises(ValueError, match="overflowed"):
        native.format_ang_rows_native(huge, x[:1], y[:1], iq[:1], ci[:1], phase[:1], k[:1])
    row = export._ang_rows(huge, x[:1], y[:1], iq[:1], ci[:1], phase[:1], k[:1])
    assert row == _jax_ang_row(huge, x, y, iq, ci, phase, k) and len(row) > 192


def _jax_ang_row(e, x, y, iq, ci, phase, k) -> str:
    """The JAX package's row for the same point, through its Python loop."""
    from latice_tpu.data import export as jax_export

    return jax_export._ang_rows(e, x[:1], y[:1], iq[:1], ci[:1], phase[:1], k[:1])
