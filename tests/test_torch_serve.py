"""The port's HTTP plane on the CPU, and its /index reply against latice_tpu's.

Both services read the same weights (carried across by
`flax_params_to_state_dict`) and the same database file, written by
``latice_tpu``'s `TpuLatentVectorDatabase`.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latice_tpu.index import LatentVectorDatabaseConfig as JaxDbConfig
from latice_tpu.index import TpuLatentVectorDatabase
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.serve import IndexService as JaxIndexService
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.serve import IndexService, make_server


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it. Building a module
    draws from it, and tests in other files build torch models from it
    unseeded, so their weights must not depend on which files ran first."""
    with torch.random.fork_rng(devices=[]):
        yield


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _strict_loads(raw: bytes):
    def reject(token):
        raise AssertionError(f"non-strict JSON token {token!r}")

    return json.loads(raw, parse_constant=reject)


def _post(url: str, body: bytes):
    return _strict_loads(urllib.request.urlopen(url, data=body, timeout=60).read())


def _serve(service):
    server = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.default_rng(0)
    base = rng.uniform(size=(1, 128, 128)).astype(np.float32)
    patterns = (base + rng.normal(size=(24, 128, 128)) * 0.02).astype(np.float32)
    orientations = rng.uniform([10, 20, 10], [170, 140, 170], size=(24, 3))

    jm = JaxVAE(inplanes=2, latent_dim=8)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(1)
    )["params"]
    enc = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="encode")[0])
    latents = np.asarray(enc(params, patterns[..., None]))

    path = str(tmp_path_factory.mktemp("serve") / "latent_index.npz")
    jdb = TpuLatentVectorDatabase(JaxDbConfig(npz_path=path, dimension=8))
    jdb.add_vectors(latents, orientations, phases=np.repeat([0, 1], 12))
    jdb.save()

    tm = VariationalAutoEncoderRawData(2, 8)
    tm.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), 2, 8))
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=path, dimension=8))
    knobs = dict(top_n=5, orientation_threshold=3.0, min_required_matches=1, batch_size=16)
    service = IndexService(tm, db, device="cpu", **knobs)
    service.warmup()
    server, url = _serve(service)
    yield dict(
        url=url, service=service, patterns=patterns, orientations=orientations, jm=jm,
        params=params, path=path, knobs=knobs, db=db, tm=tm, jdb=jdb,
    )
    server.shutdown()


def test_database_file_loads_unchanged(served):
    db, jdb = served["db"], served["jdb"]
    np.testing.assert_array_equal(db._vectors, jdb._vectors)
    np.testing.assert_array_equal(db._orientations, jdb._orientations)
    np.testing.assert_array_equal(db._phases, jdb._phases)
    assert db._has_phases and db.get_count() == 24


def test_healthz(served):
    h = _strict_loads(urllib.request.urlopen(f"{served['url']}/healthz", timeout=30).read())
    assert h["status"] == "ok" and h["count"] == 24 and h["dimension"] == 8
    assert h["platform"] == "cpu" and h["multiphase"] is True and h["batch_size"] == 16


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_index_matches_jax_service(served, dtype):
    q = served["patterns"][:20]
    if dtype == "uint8":
        q = (np.clip(q, 0, 1) * 255).astype(np.uint8)
    got = _post(f"{served['url']}/index", _npy_bytes(q))
    jdb = TpuLatentVectorDatabase(JaxDbConfig(npz_path=served["path"], dimension=8))
    want = JaxIndexService(served["jm"], served["params"], jdb, **served["knobs"]).index(q)
    assert got["n"] == want["n"] == 20
    assert got["input_dtype"] == want["input_dtype"] == dtype
    for key in ("success", "n_similar", "phase"):
        assert got[key] == want[key], key
    qa = from_euler_zxz_deg(torch.tensor(got["orientations"], dtype=torch.float64))
    qb = from_euler_zxz_deg(torch.tensor(want["orientations"], dtype=torch.float64))
    assert np.rad2deg(misorientation_angle(qa, qb).numpy()).max() < 1e-3


def test_index_top_candidate_is_itself(served):
    out = _post(f"{served['url']}/index", _npy_bytes(served["patterns"][:6]))
    assert all(out["success"]) and out["phase"] == [0] * 6
    np.testing.assert_allclose(out["orientations"][0], served["orientations"][0], atol=1e-3)


def test_index_larger_than_batch(served):
    out = _post(f"{served['url']}/index", _npy_bytes(served["patterns"]))  # 24 > batch 16
    assert out["n"] == 24 and len(out["success"]) == 24


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_encode_matches_jax_model(served, dtype):
    q = served["patterns"][:4]
    x = q
    if dtype == "uint8":
        q = (np.clip(q, 0, 1) * 255).astype(np.uint8)
        x = q.astype(np.float32) / 255.0
    out = _post(f"{served['url']}/encode", _npy_bytes(q))
    want = np.asarray(
        served["jm"].apply({"params": served["params"]}, x[..., None], method="encode")[0]
    )
    assert out["n"] == 4
    np.testing.assert_allclose(np.asarray(out["latents"], np.float32), want, atol=1e-4)


def test_failure_rows_are_null(served):
    failing = IndexService(
        served["tm"], served["db"], top_n=3, orientation_threshold=3.0,
        min_required_matches=5, batch_size=8, device="cpu",
    )
    server, url = _serve(failing)
    try:
        out = _post(f"{url}/index", _npy_bytes(served["patterns"][:4]))
    finally:
        server.shutdown()
    assert out["success"] == [False] * 4
    assert out["mean_orientations"] == [[None] * 3] * 4
    assert all(len(row) == 3 and None not in row for row in out["orientations"])


def test_oversized_body_is_413(served):
    service, url = served["service"], served["url"]
    limit, service.max_body_bytes = service.max_body_bytes, 1024
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/index", _npy_bytes(served["patterns"][:1]))
        assert e.value.code == 413
        assert "exceeds" in e.value.read().decode()
    finally:
        service.max_body_bytes = limit
    assert _post(f"{url}/index", _npy_bytes(served["patterns"][:1]))["n"] == 1


@pytest.mark.parametrize("path", ["/nope", "/quality", "/hough"])
def test_unknown_paths_are_404(served, path):
    """Unknown paths answer 404. ``/quality`` and ``/hough`` are routes since
    the band plane was ported: ``/quality`` answers in every mode, ``/hough``
    400 on a server started without a Hough indexer."""
    body = _npy_bytes(np.zeros((1, 128, 128), np.float32))
    if path == "/quality":
        reply = _post(f"{served['url']}{path}", body)
        assert reply["n"] == 1 and len(reply["iq"]) == len(reply["band_count"]) == 1
    else:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{served['url']}{path}", body)
        assert e.value.code == (400 if path == "/hough" else 404)
        if path == "/hough":
            assert "Hough indexer" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{served['url']}/metrics", timeout=30)
    assert e.value.code == 404


def test_bad_bodies_are_400(served):
    url = served["url"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/index", b"this is not an npy file")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/index", _npy_bytes(np.zeros((2, 2, 2, 2, 2), np.float32)))
    assert e.value.code == 400


def test_health_counters_advance(served):
    url = served["url"]
    before = _strict_loads(urllib.request.urlopen(f"{url}/healthz", timeout=30).read())
    _post(f"{url}/index", _npy_bytes(served["patterns"][:2]))
    after = _strict_loads(urllib.request.urlopen(f"{url}/healthz", timeout=30).read())
    assert after["requests"] == before["requests"] + 1
    assert after["patterns_indexed"] == before["patterns_indexed"] + 2


def test_database_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "db.npz")
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=path, dimension=4, phase_symmetries=["432", "6"])
    )
    db.add_vectors(rng.normal(size=(10, 4)), rng.uniform(size=(10, 3)), phases=[0, 1] * 5)
    db.save()
    again = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=path, dimension=4))
    np.testing.assert_array_equal(again._vectors, db._vectors)
    assert again.config.phase_symmetries == ["432", "6"]
    jdb = TpuLatentVectorDatabase(JaxDbConfig(npz_path=path, dimension=4))
    np.testing.assert_array_equal(jdb._vectors, db._vectors)
    np.testing.assert_array_equal(jdb._phases, db._phases)


def test_faiss_blob_matches_jax_parser():
    from latice_tpu.index.db import parse_faiss_flat_blob as jax_parse
    from latice_tpu_torch.index import parse_faiss_flat_blob

    vecs = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
    header = b"IxFI" + np.int32(3).tobytes() + np.int64(5).tobytes()
    header += np.zeros(2, np.int64).tobytes() + b"\x01" + np.int32(0).tobytes()
    blob = header + np.uint64(15).tobytes() + vecs.tobytes()
    np.testing.assert_array_equal(parse_faiss_flat_blob(blob), jax_parse(blob))
    np.testing.assert_array_equal(parse_faiss_flat_blob(blob), vecs)
    with pytest.raises(ValueError, match="unsupported FAISS index type"):
        parse_faiss_flat_blob(b"IxHN" + blob[4:])
