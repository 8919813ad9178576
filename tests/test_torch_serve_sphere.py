"""The port's ``/sphere`` plane (a zero-training server with only a
spherical indexer) against latice_tpu's `IndexService` in the same mode, on
the CPU, at 64x64 and L=16 over HTTP.

* ``/sphere`` equals a direct call of the same `SphericalIndexer` and JAX's
  reply within `NEWTON_DEG` (`test_torch_spherical.py`'s Newton bound) with
  scores within `SCORE_ATOL`; uint8 bodies stay uint8 to the device;
* ``/sphere?ambiguity=1`` adds JAX's ambiguity fields (the same rivals,
  gaps within `SCORE_ATOL`, NaN as null);
* a multi-phase server (grid mode, L=8) replies with JAX's phases;
* ``/healthz`` lists ``sphere``; ``/index`` and ``/strain`` answer 400;
  ``cli.serve --sphere-master`` alone builds this mode.
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

from latice_tpu.crystal import ROTATION_GROUPS
from latice_tpu.index.spherical import MultiPhaseSphericalIndexer as JaxMulti
from latice_tpu.index.spherical import SphericalIndexer as JaxSphere
from latice_tpu.index.spherical import SphericalIndexerConfig as JaxConfig
from latice_tpu.serve import IndexService as JaxIndexService
from latice_tpu.sim import DetectorGeometry, hexagonal_reflectors, make_kinematical_master
from latice_tpu.sim import render_from_master
from latice_tpu_torch.cli import serve as serve_cli
from latice_tpu_torch.index import (
    MultiPhaseSphericalIndexer,
    SphericalIndexer,
    SphericalIndexerConfig,
)
from latice_tpu_torch.serve import IndexService, make_server
from latice_tpu_torch.sim import DetectorGeometry as PortGeometry

NEWTON_DEG, SCORE_ATOL = 1e-2, 1e-6
CFG = dict(bandwidth=16, chunk=8)


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


def _error(url: str, body: bytes) -> tuple[int, str]:
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value.code, json.loads(e.value.read())["error"]


def _mis_deg(a, b, group="432"):
    sym = R.from_quat(np.roll(ROTATION_GROUPS[group], -1, axis=1))
    ra, rb = (R.from_euler("zxz", e, degrees=True) for e in (a, b))
    return np.array([np.degrees(min(((x * s).inv() * y).magnitude() for s in sym))
                     for x, y in zip(ra, rb)])


def _serve(service):
    server = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def plane():
    """Both services over 64x64 fcc renders, the port's behind HTTP."""
    master = make_kinematical_master(size=257)
    geometry = DetectorGeometry(shape=(64, 64))
    q = np.roll(R.random(10, random_state=9).as_quat(), 1, axis=1)
    patterns = render_from_master(master, q, geometry)
    port_ix = SphericalIndexer(master, PortGeometry(shape=(64, 64)),
                               SphericalIndexerConfig(**CFG), device="cpu")
    service = IndexService(None, None, sphere_indexer=port_ix, image_size=(64, 64), device="cpu")
    jax_service = JaxIndexService(None, None, None, image_size=(64, 64),
                                  sphere_indexer=JaxSphere(master, geometry, JaxConfig(**CFG)))
    assert service.warmup() >= 0.0
    server, url = _serve(service)
    yield service, jax_service, port_ix, patterns, url
    server.shutdown()
    server.server_close()


def test_sphere_route_matches_direct_call_and_jax(plane):
    service, jax_service, port_ix, patterns, url = plane
    got = _post(url + "/sphere", _npy(patterns))
    want = jax_service.sphere(patterns)
    direct = port_ix.index_patterns(patterns)
    assert set(got) == set(want)
    assert got["n"] == 10 and got["input_dtype"] == "float32"
    np.testing.assert_array_equal(got["orientations"], direct.eulers_deg)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_ATOL, rtol=0)
    assert _mis_deg(got["orientations"], want["orientations"]).max() < NEWTON_DEG
    u8 = np.round(patterns * 255).astype(np.uint8)
    got8 = _post(url + "/sphere", _npy(u8))
    assert got8["input_dtype"] == "uint8"
    np.testing.assert_array_equal(got8["orientations"], port_ix.index_patterns(u8).eulers_deg)


def test_sphere_ambiguity_matches_jax(plane):
    _, jax_service, _, patterns, url = plane
    got = _post(url + "/sphere?ambiguity=1", _npy(patterns))
    want = jax_service.sphere(patterns, ambiguity=True)
    assert set(got) == set(want)
    assert got["ambiguity_has_rival"] == want["ambiguity_has_rival"]
    gap = np.array([np.nan if v is None else v for v in got["ambiguity_gap"]])
    want_gap = np.array([np.nan if v is None else v for v in want["ambiguity_gap"]])
    np.testing.assert_allclose(gap, want_gap, atol=SCORE_ATOL, rtol=0)
    plain = _post(url + "/sphere?ambiguity=0", _npy(patterns[:2]))
    assert "ambiguity_gap" not in plain


def test_sphere_health_and_refusals(plane):
    service, _, _, patterns, url = plane
    health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
    assert health["mode"] == "zero-training" and health["planes"] == ["sphere"]
    body = _npy(patterns[:2])
    code, msg = _error(url + "/index", body)
    assert code == 400 and "zero-training" in msg and "/sphere" in msg
    code, msg = _error(url + "/strain", body)
    assert code == 400 and "without a strain reference" in msg
    code, msg = _error(url + "/sphere", _npy(np.zeros((2, 5, 5, 5), np.float32)))
    assert code == 400


def test_multiphase_sphere_server_matches_jax():
    """Grid mode at L=8: the reply's phases and scores, and the ambiguity
    read against the first master."""
    m_fcc = make_kinematical_master(size=129)
    m_hcp = make_kinematical_master(size=129, reflectors=hexagonal_reflectors())
    geometry = DetectorGeometry(shape=(64, 64))
    qf, qh = (np.roll(R.random(3, random_state=s).as_quat(), 1, axis=1) for s in (1, 2))
    pats = np.concatenate([render_from_master(m_fcc, qf, geometry),
                           render_from_master(m_hcp, qh, geometry)])
    cfg = dict(bandwidth=8, chunk=6, refine=False)
    port = IndexService(None, None, image_size=(64, 64), device="cpu",
                        sphere_indexer=MultiPhaseSphericalIndexer(
                            [m_fcc, m_hcp], PortGeometry(shape=(64, 64)),
                            SphericalIndexerConfig(**cfg), symmetries=["432", "622"],
                            device="cpu"))
    jax_service = JaxIndexService(None, None, None, image_size=(64, 64),
                                  sphere_indexer=JaxMulti([m_fcc, m_hcp], geometry,
                                                          JaxConfig(**cfg),
                                                          symmetries=["432", "622"]))
    got, want = port.sphere(pats, ambiguity=True), jax_service.sphere(pats, ambiguity=True)
    assert got["phase"] == want["phase"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_ATOL, rtol=0)
    assert got["ambiguity_has_rival"] == want["ambiguity_has_rival"]


def test_serve_cli_sphere_master_alone(tmp_path):
    np.save(tmp_path / "m.npy", make_kinematical_master(size=129))
    service = serve_cli.build_service(serve_cli.parse_args(
        ["--sphere-master", str(tmp_path / "m.npy"), "--sphere-bandwidth", "8", "--group", "432",
         "--device", "cpu"]))
    ix = service._sphere
    assert service.pipeline is None and service.health()["planes"] == ["sphere"]
    assert ix.config.bandwidth == 8 and ix.config.symmetry == "432"
    assert ix.geometry.shape == (128, 128) and ix.device.type == "cpu"
