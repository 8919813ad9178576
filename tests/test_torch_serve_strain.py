"""The port's ``/strain`` plane (HR-EBSD against a held reference) against
latice_tpu's `IndexService` in the same mode, on the CPU, over HTTP.

* ``/strain`` with and without a stiffness: strain, rotation and von Mises
  within 1e-6 of JAX's reply, residuals within 1e-5 px, stress within 1e-4
  of its largest entry (`test_torch_hrebsd.py`'s tolerances); uint8 bodies
  stay uint8 to the device;
* ``/healthz`` lists ``strain`` in the zero-training mode; ``/index`` then
  answers 400, and a body of another shape answers 400 with JAX's message;
* ``cli.serve --strain-ref`` alone builds this mode, with
  ``--strain-stiffness`` (preset or triplet) and ``--strain-remap``.

64x64 patterns, 32x32 ROIs, chunk 8 (the CLI's default ROIs at 128x128).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from latice_tpu.crystal.elastic import CUBIC_STIFFNESS, cubic_stiffness
from latice_tpu.serve import IndexService as JaxIndexService
from latice_tpu.sim import DetectorGeometry
from latice_tpu_torch.cli import serve as serve_cli
from latice_tpu_torch.serve import IndexService, make_server
from latice_tpu_torch.sim import DetectorGeometry as PortGeometry

A_ATOL, RESIDUAL_ATOL, STRESS_RTOL = 1e-6, 1e-5, 1e-4
KW = dict(roi_size=32, chunk=8)


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
    return json.loads(urllib.request.urlopen(url, data=body, timeout=120).read())


def _error(url: str, body: bytes):
    try:
        urllib.request.urlopen(url, data=body, timeout=120)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    raise AssertionError(f"{url} answered 200")


def _patterns(n: int = 6, seed: int = 3, size: int = 64) -> np.ndarray:
    """``n + 1`` uint8 square patterns of one grain (the first undeformed,
    the reference), tests/test_hrebsd.py's direction-function oracle."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(60, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    mag = rng.uniform(100.0, 500.0, size=(60, 1))
    k *= mag
    phase = rng.uniform(0, 2 * np.pi, 60)
    x = (np.arange(size) + 0.5) / size - 0.5
    r = np.stack([np.broadcast_to(x[None, :], (size, size)),
                  np.broadcast_to(-x[:, None], (size, size)), np.full((size, size), 0.7)], axis=-1)
    out = []
    for i in range(n + 1):
        a = np.zeros((3, 3)) if i == 0 else rng.normal(scale=2e-3, size=(3, 3))
        a[2, 2] = 0.0
        rr = r @ np.linalg.inv(np.eye(3) + a).T
        u = rr / np.linalg.norm(rr, axis=-1, keepdims=True)
        out.append((mag[:, 0] ** -0.5 * np.cos(u @ k.T + phase)).sum(axis=-1))
    out = np.stack(out)
    return np.round((out - out.min()) / np.ptp(out) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def plane():
    """Port servers (with and without a stiffness) and JAX services on the
    same reference."""
    pats = _patterns()
    ref, body = pats[0], pats[1:]
    c = cubic_stiffness(*CUBIC_STIFFNESS["ni"])
    jgeom, pgeom = DetectorGeometry(shape=(64, 64)), PortGeometry(shape=(64, 64))
    servers, jax = {}, {}
    for name, stiff in (("plain", None), ("stiffness", c)):
        cfg = dict(reference=ref, stiffness=stiff, **KW)
        service = IndexService(None, None, strain_config=dict(cfg, geometry=pgeom), device="cpu")
        service.warmup()
        server = make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        servers[name] = (service, server, thread, f"http://127.0.0.1:{server.server_address[1]}")
        jax[name] = JaxIndexService(None, None, None, strain_config=dict(cfg, geometry=jgeom))
    yield servers, jax, body
    for _, server, thread, _ in servers.values():
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


@pytest.mark.parametrize("name", ["plain", "stiffness"])
def test_strain_matches_jax(plane, name):
    servers, jax, body = plane
    _, _, _, url = servers[name]
    got = _post(url + "/strain", _npy(body))
    want = jax[name].strain(body)
    assert set(got) == set(want)
    assert got["n"] == want["n"] == len(body) and got["input_dtype"] == "uint8"
    for key in ("strain", "rotation", "von_mises"):
        np.testing.assert_allclose(got[key], want[key], atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got["residual_px"], want["residual_px"], atol=RESIDUAL_ATOL, rtol=0)
    np.testing.assert_allclose(got["rotation_deg"], want["rotation_deg"], atol=1e-4, rtol=0)
    assert abs(got["mean_quality"] - want["mean_quality"]) < 1e-5
    assert ("stress" in got) == (name == "stiffness")
    if name == "stiffness":
        scale = np.abs(want["stress"]).max()
        np.testing.assert_allclose(got["stress"], want["stress"], atol=STRESS_RTOL * scale,
                                   rtol=0)
    # A single (H, W) frame and a trailing channel axis are accepted as JAX does.
    one = _post(url + "/strain", _npy(body[0]))
    chan = _post(url + "/strain", _npy(body[:2, :, :, None]))
    assert one["n"] == 1 and chan["n"] == 2
    np.testing.assert_allclose(one["strain"][0], got["strain"][0], atol=A_ATOL, rtol=0)


def test_strain_health_and_refusals(plane):
    servers, _, body = plane
    service, _, _, url = servers["plain"]
    health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
    assert health["mode"] == "zero-training" and health["planes"] == ["strain"]
    code, msg = _error(url + "/index", _npy(body))
    assert code == 400 and "zero-training" in msg and "/strain" in msg
    code, msg = _error(url + "/strain", _npy(np.zeros((2, 32, 32), np.uint8)))
    assert code == 400 and "strain patterns must be (N, 64, 64)" in msg
    code, msg = _error(url + "/hough", _npy(body))
    assert code == 400 and "without a Hough indexer" in msg
    assert service.requests >= 1
    with pytest.raises(ValueError, match="does not match geometry"):
        IndexService(None, None, strain_config=dict(
            reference=np.zeros((32, 32)), geometry=PortGeometry(shape=(64, 64))), device="cpu")


def test_serve_cli_strain_ref(tmp_path):
    """At 128x128: the CLI's plane runs the default 64x64 ROIs."""
    pats = _patterns(n=2, size=128)
    np.save(tmp_path / "ref.npy", pats[0])
    for spec in ("ni", "246.5,147.3,124.7"):
        service = serve_cli.build_service(serve_cli.parse_args(
            ["--strain-ref", str(tmp_path / "ref.npy"), "--strain-stiffness", spec,
             "--strain-remap", "0", "--device", "cpu"]))
        assert service.health()["planes"] == ["strain"] and service.pipeline is None
        ref, geom, kw = service._strain
        assert geom.shape == (128, 128) and kw["remap_iterations"] == 0 and kw["chunk"] == 128
        np.testing.assert_array_equal(kw["stiffness"], cubic_stiffness(*CUBIC_STIFFNESS["ni"]))
        reply = service.strain(pats[1:])
        assert reply["n"] == 2 and "stress" in reply
    with pytest.raises(SystemExit, match="--strain-stiffness 'steel'"):
        serve_cli.build_service(serve_cli.parse_args(
            ["--strain-ref", str(tmp_path / "ref.npy"), "--strain-stiffness", "steel",
             "--device", "cpu"]))
