"""The port's zero-training server (``/quality``, ``/hough``, no model, no
dictionary) against latice_tpu's `IndexService` in the same mode, on the
CPU, at 64x64 over HTTP.

* ``/hough`` equals a direct call of the same `HoughIndexer`, and JAX's
  reply within `ORIENT_DEG` (float32 Euler round trips over the indexers'
  1.5e-5-degree agreement, `test_torch_hough_indexing.py`), with the same
  success and matched counts;
* ``/quality`` builds its detector at its first request and answers JAX's
  IQ within 1e-5 and its band counts exactly;
* ``/healthz`` reports the zero-training mode and its planes; ``/index``,
  ``/encode`` and ``/reload`` answer 400, and so do ``/sphere`` (this
  server has no spherical indexer) and ``/strain`` (no strain reference);
  ``--sphere-master`` alone builds the zero-training service that serves
  ``/sphere`` (`test_torch_serve_sphere.py` holds it to JAX).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from latice_tpu.data.hough import BandDetector as JaxDetector
from latice_tpu.index.hough_indexing import HoughIndexer as JaxHough
from latice_tpu.serve import IndexService as JaxIndexService
from latice_tpu.sim import DetectorGeometry, cubic_reflectors, simulate_patterns
from latice_tpu_torch import sim as tsim
from latice_tpu_torch.cli import serve as serve_cli
from latice_tpu_torch.crystal import from_euler_zxz_deg, symmetry_reduced_misorientation
from latice_tpu_torch.data import BandDetector
from latice_tpu_torch.index import HoughIndexer
from latice_tpu_torch.serve import IndexService, make_server

ORIENT_DEG = 1e-3
DET = dict(height=64, width=64, n_theta=90, n_rho=64, k=8, band_width_px=5.0, batch_size=8)
KW = dict(grid_resolution_deg=5.0, n_bands=8, tolerance_deg=4.0, batch_size=8)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(url: str, body: bytes):
    return json.loads(urllib.request.urlopen(url, data=body, timeout=60).read())


def _error(url: str, body: bytes) -> tuple[int, str]:
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value.code, json.loads(e.value.read())["error"]


@pytest.fixture(scope="module")
def plane():
    """Both services over 64x64 fcc renders, the port's behind HTTP."""
    geometry = DetectorGeometry(shape=(64, 64))
    refl = cubic_reflectors("fcc", a=3.52, kv=20.0)
    q = np.roll(R.random(10, random_state=7).as_quat(), 1, axis=1)
    patterns = simulate_patterns(q, geometry, refl, chunk=16)
    port_ix = HoughIndexer(tsim.cubic_reflectors("fcc", a=3.52, kv=20.0),
                           tsim.DetectorGeometry(shape=(64, 64)),
                           detector=BandDetector(device="cpu", **DET), **KW)
    service = IndexService(None, None, hough_indexer=port_ix, image_size=(64, 64), device="cpu")
    jax_service = JaxIndexService(None, None, None, image_size=(64, 64),
                                  hough_indexer=JaxHough(refl, geometry,
                                                         detector=JaxDetector(**DET), **KW))
    assert service.warmup() >= 0.0
    server = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield service, jax_service, port_ix, patterns, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_hough_route_matches_direct_call_and_jax(plane):
    service, jax_service, port_ix, patterns, url = plane
    got = _post(url + "/hough", _npy(patterns))
    want = jax_service.hough(patterns)
    direct = port_ix(patterns)
    assert set(got) == set(want)
    assert got["n"] == 10 and got["input_dtype"] == "float32"
    np.testing.assert_array_equal(got["orientations"], direct.eulers_deg)
    np.testing.assert_array_equal(got["fit_deg"], direct.fit_deg)
    for key in ("success", "n_matched"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["iq"], want["iq"], atol=1e-5, rtol=0)
    qa, qb = (from_euler_zxz_deg(torch.tensor(r["orientations"], dtype=torch.float64))
              for r in (got, want))
    assert np.rad2deg(symmetry_reduced_misorientation(qa, qb).numpy()).max() < ORIENT_DEG
    u8 = _post(url + "/hough", _npy(np.round(patterns * 255).astype(np.uint8)))
    assert u8["input_dtype"] == "uint8" and u8["success"] == got["success"]


def test_quality_route_matches_jax(plane):
    service, jax_service, _, patterns, url = plane
    assert service._quality_detector is None  # built at the first request
    got = _post(url + "/quality", _npy(patterns))
    want = jax_service.quality(patterns)
    assert service._quality_detector.batch_size == 256  # no pipeline: the JAX default
    assert got["n"] == 10 and got["band_count"] == want["band_count"]
    np.testing.assert_allclose(got["iq"], want["iq"], atol=1e-5, rtol=0)
    assert abs(got["mean_iq"] - want["mean_iq"]) < 1e-5


def test_zero_training_health_and_refusals(plane):
    service, _, _, patterns, url = plane
    health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
    assert health["mode"] == "zero-training" and health["planes"] == ["hough"]
    assert health["count"] == 0 and health["batch_size"] == 0 and health["platform"] == "cpu"
    body = _npy(patterns[:2])
    for path in ("/index", "/encode"):
        code, msg = _error(url + path, body)
        assert code == 400 and "zero-training" in msg
    code, msg = _error(url + "/reload", json.dumps({"checkpoint": "vae.pt"}).encode())
    assert code == 400 and "zero-training" in msg
    code, msg = _error(url + "/sphere", body)
    assert code == 400 and "without a spherical indexer" in msg
    code, msg = _error(url + "/strain", body)
    assert code == 400 and "without a strain reference" in msg


def test_serve_cli_modes(tmp_path):
    with pytest.raises(SystemExit, match="--hough"):
        serve_cli.build_service(serve_cli.parse_args(["--device", "cpu"]))
    # --strain-ref, once refused, adds /strain beside /hough.
    np.save(tmp_path / "ref.npy", np.zeros((128, 128), np.float32))
    strain = serve_cli.build_service(serve_cli.parse_args(
        ["--hough", "--strain-ref", str(tmp_path / "ref.npy"), "--device", "cpu"]))
    assert strain.health()["planes"] == ["hough", "strain"]
    # --sphere-master, once refused, adds /sphere beside /hough.
    np.save(tmp_path / "m.npy", tsim.make_kinematical_master(size=65))
    both = serve_cli.build_service(serve_cli.parse_args(
        ["--hough", "--sphere-master", str(tmp_path / "m.npy"), "--sphere-bandwidth", "8",
         "--device", "cpu"]))
    assert both.health()["planes"] == ["hough", "sphere"]
    with pytest.raises(ValueError, match="hough_indexer"):
        IndexService(None, None, device="cpu")
