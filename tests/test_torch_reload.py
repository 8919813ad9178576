"""The port's ``/reload``: hot-swapping the served weights, confined to a
checkpoint root, over HTTP on the CPU; and ``cli.serve``'s new options
(engines, ``--preprocess``, ``--checkpoint-root``)."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from latice_tpu_torch.cli.serve import build_service, parse_args
from latice_tpu_torch.index import (
    IndexPipeline,
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
)
from latice_tpu_torch.models import VariationalAutoEncoderRawData, load_checkpoint
from latice_tpu_torch.serve import IndexService, make_server

INPLANES, LATENT = 2, 8
KNOBS = dict(top_n=5, orientation_threshold=3.0, min_required_matches=1, batch_size=8)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Building a torch module draws from the global RNG (its weights are
    then overwritten from a seeded generator here); leave that RNG as this
    module found it for tests in other files that build models unseeded."""
    with torch.random.fork_rng(devices=[]):
        yield


def _model(seed: int) -> VariationalAutoEncoderRawData:
    return VariationalAutoEncoderRawData(INPLANES, LATENT).init_weights(
        torch.Generator().manual_seed(seed)
    )


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two checkpoints under ``root/``, one outside it, and a database."""
    top = tmp_path_factory.mktemp("reload")
    root = top / "root"
    root.mkdir()
    for name, seed in (("a.pt", 0), ("b.pt", 1)):
        torch.save(_model(seed).state_dict(), root / name)
    torch.save(_model(2).state_dict(), top / "outside.pt")
    rng = np.random.default_rng(0)
    db_path = str(top / "db.npz")
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=db_path, dimension=LATENT))
    db.add_vectors(rng.normal(size=(40, LATENT)), rng.uniform([10, 20, 10], [170, 160, 170],
                                                               size=(40, 3)))
    db.save()
    patterns = rng.uniform(size=(12, 128, 128)).astype(np.float32)
    return dict(top=top, root=root, db=db_path, patterns=patterns)


def _db(files):
    return TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=files["db"], dimension=LATENT)
    )


def _service(files, **kw):
    loader = kw.pop("param_loader", lambda p: load_checkpoint(p, INPLANES, LATENT, device="cpu"))
    return IndexService(
        load_checkpoint(str(files["root"] / "a.pt"), INPLANES, LATENT, device="cpu"),
        _db(files), device="cpu", param_loader=loader, **KNOBS, **kw,
    )


def _fresh(files, name):
    db = _db(files)
    return IndexPipeline(load_checkpoint(str(files["root"] / name), INPLANES, LATENT,
                                         device="cpu"),
                         db._vectors, db._orientations, device="cpu", **KNOBS)


def test_reload_swaps_weights(files):
    service = _service(files, checkpoint_root=str(files["root"]))
    x = files["patterns"]
    before = service.index(x)
    out = service.reload("b.pt")
    assert out["status"] == "reloaded" and out["model_version"] == 1
    assert service.health()["model_version"] == 1
    after = service.index(x)
    want = _fresh(files, "b.pt")(x)
    np.testing.assert_array_equal(np.asarray(after["orientations"]), want.best_orientation)
    np.testing.assert_array_equal(after["success"], want.success.tolist())
    np.testing.assert_array_equal(service.encode(x)["latents"], want_latents(files, "b.pt", x))
    assert before["orientations"] != after["orientations"]  # the weights did change
    service.reload(str(files["root"] / "a.pt"))  # an absolute path inside the root
    assert service.model_version == 2
    assert service.index(x)["orientations"] == before["orientations"]


def test_reload_under_concurrent_requests(files):
    """Requests racing reloads each see one whole model, a or b, and every
    reload counts once."""
    import sys

    service = _service(files, checkpoint_root=str(files["root"]))
    x = files["patterns"][:4]
    want = {name: np.asarray(service.index(x)["orientations"]) if name == "a.pt"
            else _fresh(files, name)(x).best_orientation for name in ("a.pt", "b.pt")}
    seen, errors = [], []

    def ask():
        try:
            for _ in range(6):
                seen.append(np.asarray(service.index(x)["orientations"]))
        except Exception as e:  # reported below; a thread must not die silently
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=ask) for _ in range(4)]
        for t in threads:
            t.start()
        for i in range(6):
            service.reload("b.pt" if i % 2 == 0 else "a.pt")
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(seen) == 24
    assert all(any(np.array_equal(o, w) for w in want.values()) for o in seen)
    assert service.model_version == 6


def want_latents(files, name, x):
    return _fresh(files, name).encode(x).tolist()


@pytest.mark.parametrize("target", ["../outside.pt", "OUTSIDE_ABS", "/etc/passwd", "sub/../../x.pt"])
def test_paths_outside_the_root_are_refused(files, target):
    if target == "OUTSIDE_ABS":
        target = str(files["top"] / "outside.pt")
    loaded = []
    service = _service(files, checkpoint_root=str(files["root"]),
                       param_loader=lambda p: loaded.append(p))
    with pytest.raises(ValueError, match="outside the configured checkpoint root") as e:
        service.reload(target)
    assert str(files["root"]) not in str(e.value)  # echoes only what was sent
    assert loaded == [] and service.model_version == 0


def test_symlink_out_of_the_root_is_refused(files, tmp_path):
    root = tmp_path / "r"
    root.mkdir()
    (root / "link.pt").symlink_to(files["top"] / "outside.pt")
    service = _service(files, checkpoint_root=str(root))
    with pytest.raises(ValueError, match="outside"):
        service.reload("link.pt")


def test_reload_without_a_loader_refuses(files):
    service = _service(files, param_loader=None)
    with pytest.raises(ValueError, match="param_loader"):
        service.reload("b.pt")


def _post(url, body: bytes):
    return json.loads(urllib.request.urlopen(url, data=body, timeout=60).read())


def _npy(x):
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


@pytest.fixture
def served(files):
    service = _service(files, checkpoint_root=str(files["root"]))
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield service, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


def test_post_reload_over_http(files, served):
    service, url = served
    x = files["patterns"][:5]
    out = _post(f"{url}/reload", json.dumps({"checkpoint": "b.pt"}).encode())
    assert out["model_version"] == 1
    health = json.loads(urllib.request.urlopen(f"{url}/healthz", timeout=30).read())
    assert health["model_version"] == 1
    got = _post(f"{url}/index", _npy(x))
    want = _fresh(files, "b.pt")(x)
    np.testing.assert_array_equal(np.asarray(got["orientations"]), want.best_orientation)


@pytest.mark.parametrize(
    "body, code",
    [
        ({"checkpoint": "../outside.pt"}, 400),
        ({"path": "b.pt"}, 400),  # no "checkpoint" key
        (b"not json", 400),
        ({"checkpoint": "missing.pt"}, 500),  # inside the root, but the load fails
    ],
    ids=["outside_root", "missing_key", "bad_json", "load_fails"],
)
def test_post_reload_errors(served, body, code):
    service, url = served
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/reload", data)
    assert e.value.code == code
    reply = json.loads(e.value.read())
    assert "error" in reply and "/" not in reply["error"].replace("../outside.pt", "")
    assert service.model_version == 0


def test_post_reload_without_loader_is_400(files):
    service = _service(files, param_loader=None)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{server.server_address[1]}/reload",
                  json.dumps({"checkpoint": "b.pt"}).encode())
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


# -- cli.serve ---------------------------------------------------------------------


def _cli(files, *extra):
    return parse_args(["--db", files["db"], "--checkpoint", str(files["root"] / "a.pt"),
                       "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
                       "--batch-size", "8", "--top-n", "5", "--min-matches", "1",
                       "--device", "cpu", *extra])


def test_cli_serve_int8_with_preprocess(files):
    service = build_service(_cli(files, "--engine", "int8", "--preprocess",
                                 "hotpixels=5,dynamic=auto,clip=3"))
    pipe = service.pipeline
    assert pipe.engine == "int8" and pipe.search.table.dtype == torch.int8
    assert pipe.preprocess is not None
    assert pipe.model.compute_dtype == torch.bfloat16  # the serve precision
    assert service.checkpoint_root == str(files["root"])  # --checkpoint's directory
    out = service.index(files["patterns"][:4])
    assert out["n"] == 4 and np.isfinite(out["orientations"]).all()
    service.reload("b.pt")
    assert service.pipeline.model.compute_dtype == torch.bfloat16  # reloads stay 16-mixed
    assert service.pipeline.engine == "int8" and service.model_version == 1


@pytest.mark.parametrize("engine", ["exact", "fused", "approx", "int8"])
def test_cli_serve_engines(files, engine):
    service = build_service(_cli(files, "--engine", engine))
    assert service.health()["engine"] == engine


def test_cli_serve_checkpoint_root_and_static_auto(files, tmp_path):
    service = build_service(_cli(files, "--checkpoint-root", str(tmp_path)))
    assert service.checkpoint_root == str(tmp_path)
    with pytest.raises(ValueError, match="outside"):
        service.reload(str(files["root"] / "b.pt"))
    with pytest.raises(SystemExit, match="static=auto"):
        build_service(_cli(files, "--preprocess", "static=auto"))
