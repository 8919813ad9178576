"""The port's service in pattern-DI mode and with NLPAR scan bodies, against
latice_tpu's `IndexService` on the same inputs, on the CPU: the same
success, similar counts and phases, orientations within 1e-3 degrees
(float32 Euler round trips), the scan grid in the reply; ``/encode`` and
``/reload`` answer 400 in DI mode."""

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
from scipy.spatial.transform import Rotation as R

from latice_tpu.crystal import sample_fundamental_zone
from latice_tpu.index import LatentVectorDatabaseConfig as JaxDbConfig
from latice_tpu.index import TpuLatentVectorDatabase
from latice_tpu.models import VariationalAutoEncoderRawData as JaxVAE
from latice_tpu.serve import IndexService as JaxIndexService
from latice_tpu.sim import cubic_reflectors, simulate_patterns
from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
from latice_tpu_torch.data import PreprocessConfig
from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase
from latice_tpu_torch.models import VariationalAutoEncoderRawData, flax_params_to_state_dict
from latice_tpu_torch.serve import IndexService, make_server

ORIENT_DEG = 1e-3
KNOBS = dict(top_n=5, orientation_threshold=3.0, min_required_matches=1, batch_size=16)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(url: str, body: bytes):
    return json.loads(urllib.request.urlopen(url, data=body, timeout=60).read())


def _status(url: str, body: bytes) -> int:
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value.code


def _serve(service):
    server = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _same_reply(got, want):
    for key in ("n", "success", "n_similar", "phase", "scan_grid", "input_dtype"):
        assert got.get(key) == want.get(key), key
    qa, qb = (from_euler_zxz_deg(torch.tensor(r["orientations"], dtype=torch.float64))
              for r in (got, want))
    assert np.rad2deg(misorientation_angle(qa, qb).numpy()).max() < ORIENT_DEG


@pytest.fixture(scope="module")
def di_plane():
    """A 16-degree cubic grid's fcc patterns (36) as two phases, and a 4x6
    scan of noisy copies of 24 of them."""
    quats = sample_fundamental_zone("432", 16.0)
    angles = R.from_quat(np.roll(quats, -1, axis=1)).as_euler("zxz", degrees=True)
    stack = simulate_patterns(angles, reflectors=cubic_reflectors("fcc", max_hkl=2, min_d=1.0))
    phases = np.repeat([0, 1], 18).astype(np.int32)
    rng = np.random.default_rng(0)
    scan = stack[:24] + rng.normal(size=(24, 128, 128)).astype(np.float32) * 0.05
    dictionary = (stack, angles, phases, ["432", "432"])
    port = IndexService(None, None, di_dictionary=dictionary, nlpar_h=1.5, device="cpu", **KNOBS)
    port.warmup()
    jax_service = JaxIndexService(None, None, None, di_dictionary=dictionary, nlpar_h=1.5,
                                  **KNOBS)
    server, url = _serve(port)
    yield dict(url=url, port=port, jax=jax_service, scan=scan.astype(np.float32))
    server.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_di_index_matches_jax(di_plane, dtype):
    q = di_plane["scan"]
    if dtype == "uint8":
        q = np.round(np.clip(q, 0, 1) * 255).astype(np.uint8)
    got = _post(f"{di_plane['url']}/index", _npy_bytes(q))
    _same_reply(got, di_plane["jax"].index(q))
    assert got["phase"] == [0] * 18 + [1] * 6


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_di_scan_body_matches_jax(di_plane, dtype):
    scan = di_plane["scan"].reshape(4, 6, 128, 128)
    if dtype == "uint8":
        scan = np.round(np.clip(scan, 0, 1) * 255).astype(np.uint8)
    got = _post(f"{di_plane['url']}/index", _npy_bytes(scan))
    assert got["scan_grid"] == [4, 6] and got["input_dtype"] == "float32"
    _same_reply(got, di_plane["jax"].index(scan))


def test_di_mode_refuses_encode_and_reload(di_plane):
    url = di_plane["url"]
    assert _status(f"{url}/encode", _npy_bytes(di_plane["scan"][:2])) == 400
    assert _status(f"{url}/reload", json.dumps({"checkpoint": "vae.pt"}).encode()) == 400
    h = json.loads(urllib.request.urlopen(f"{url}/healthz", timeout=30).read())
    assert h["mode"] == "pattern-di" and h["count"] == 36 and h["dimension"] == 128 * 128
    assert h["multiphase"] is True and h["platform"] == "cpu"
    assert _status(f"{url}/index", _npy_bytes(np.zeros((2, 3, 64, 64), np.float32))) == 400
    with pytest.raises(ValueError, match="fused engine"):
        IndexService(None, None, di_dictionary=(di_plane["scan"], np.zeros((24, 3))),
                     engine="fused", device="cpu")
    with pytest.raises(ValueError, match="di_dictionary"):
        IndexService(None, None, device="cpu")


@pytest.fixture(scope="module")
def latent_plane(tmp_path_factory):
    """test_torch_serve's latent plane: one JAX model's weights in both
    services over one database file; a 4x6 scan of near-duplicates with a
    few hot pixels, served with NLPAR and a hot-pixel recipe."""
    rng = np.random.default_rng(1)
    base = rng.uniform(size=(1, 128, 128)).astype(np.float32)
    patterns = (base + rng.normal(size=(24, 128, 128)) * 0.02).astype(np.float32)
    orientations = rng.uniform([10, 20, 10], [170, 140, 170], size=(24, 3))
    jm = JaxVAE(inplanes=2, latent_dim=8)
    params = jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 128, 128, 1)), jax.random.key(1)
    )["params"]
    enc = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="encode")[0])
    path = str(tmp_path_factory.mktemp("serve_nlpar") / "latent_index.npz")
    jdb = TpuLatentVectorDatabase(JaxDbConfig(npz_path=path, dimension=8))
    jdb.add_vectors(np.asarray(enc(params, patterns[..., None])), orientations)
    jdb.save()
    tm = VariationalAutoEncoderRawData(2, 8)
    tm.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), 2, 8))
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=path, dimension=8))
    scan = np.clip(patterns, 0, 1)
    scan.reshape(24, -1)[np.arange(24), rng.integers(0, 128 * 128, 24)] = 1.0
    from latice_tpu.data import PreprocessConfig as JaxPreprocessConfig

    port = IndexService(tm, db, nlpar_h=2.0, preprocess=PreprocessConfig(hot_pixel_threshold=6.0),
                        device="cpu", **KNOBS)
    jax_service = JaxIndexService(jm, params, jdb, nlpar_h=2.0,
                                  preprocess=JaxPreprocessConfig(hot_pixel_threshold=6.0),
                                  **KNOBS)
    return dict(port=port, jax=jax_service, scan=scan.reshape(4, 6, 128, 128))


@pytest.mark.parametrize("dtype", ["float32", "uint8", "uint16"])
def test_latent_scan_body_matches_jax(latent_plane, dtype):
    """Integer scans are scaled by their dtype's maximum, as
    `prepare_patterns` scales them, before the denoising."""
    scan = latent_plane["scan"]
    if dtype != "float32":
        top = np.iinfo(dtype).max
        scan = np.round(scan * top).astype(dtype)
    got = latent_plane["port"].index(scan)
    assert got["scan_grid"] == [4, 6] and got["n"] == 24
    _same_reply(got, latent_plane["jax"].index(scan))
    # Stacks still index unchanged beside scans.
    _same_reply(latent_plane["port"].index(scan[0]), latent_plane["jax"].index(scan[0]))
