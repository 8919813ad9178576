"""Indexing service: a persistent HTTP plane around `index.IndexPipeline`.

The port of ``latice_tpu.serve``:

* the pipeline is warmed at startup (one dummy batch per input dtype), which
  also builds the CUDA kernels, so the first request pays for neither;
* requests carry patterns as raw ``.npy`` bytes; uint8 stacks stay uint8
  until the device divides them by 255;
* all requests go through one lock: one device runs one batch at a time,
  and the pipeline batches and pads internally;
* ``POST /reload`` hot-swaps the model: the new pipeline is built outside
  the lock while the old one serves, then swapped in under it;
* pattern-DI mode (``di_dictionary``) serves ``/index`` by NCC against a
  raw dictionary stack (`index.PatternDictionaryIndexer`), with no model;
* with ``nlpar_h``, a 4-D ``(R, C, H, W)`` body is a scan, NLPAR-denoised
  (`data.nlpar_denoise`) before it is indexed row by row;
* the zero-training planes: ``/quality`` (the Hough IQ of
  `data.BandDetector`, whose detector is built at its first request) in
  every mode, ``/hough`` (`index.HoughIndexer`) with ``hough_indexer`` and
  ``/sphere`` (`index.SphericalIndexer`, dictionary-free) with
  ``sphere_indexer`` and ``/strain`` (`hrebsd.hrebsd_map` against a held
  reference) with ``strain_config``. With any of these three the service
  runs without a model and a dictionary.

Endpoints:
  GET  /healthz -> {"status": "ok", "mode": "latent" | "pattern-di" |
                    "zero-training", "planes": [...], "count": N, ...}
  POST /index   -> body: .npy of (N, H, W[, 1]) patterns, or an (R, C, H, W)
                   scan with nlpar_h; reply: {"orientations": ...,
                   "success": ..., "n": ...} (and "scan_grid" for a scan);
                   400 in zero-training mode
  POST /encode  -> body: .npy patterns; reply: {"latents": ...}; 400 in
                   pattern-DI and zero-training mode
  POST /reload  -> body: {"checkpoint": path}; 400 without a loader, in
                   pattern-DI mode, without the key or for a path outside
                   the checkpoint root, 500 when the load fails
  POST /quality -> body: .npy patterns; reply: {"iq": ..., "band_count": ...}
  POST /hough   -> body: .npy patterns; reply: {"orientations": ...,
                   "success": ..., "fit_deg": ..., "iq": ...}; 400 without
                   a Hough indexer
  POST /sphere  -> body: .npy patterns; reply: {"orientations": ...,
                   "scores": ...} (and "phase" multi-phase); with
                   ?ambiguity=1 also "ambiguity_angle_deg",
                   "ambiguity_gap", "ambiguity_has_rival"; 400 without a
                   spherical indexer
  POST /strain  -> body: .npy of (N, H, W) raw patterns matching the
                   reference; reply: {"strain": ..., "rotation": ...,
                   "rotation_deg": ..., "von_mises": ..., "residual_px": ...,
                   "mean_quality": ...} (and "stress" with a stiffness); 400
                   without a strain reference or for another shape

Replies are strict RFC-8259 JSON: consensus failures are ``null`` rows in
``mean_orientations``, never bare ``NaN`` tokens. Bodies larger than
``max_body_bytes`` are refused with 413. Any other path answers 404.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from latice_tpu_torch.data import BandDetector, nlpar_denoise, prepare_patterns
from latice_tpu_torch.data.transforms import _int_scale
from latice_tpu_torch.hrebsd import hrebsd_map, von_mises_strain
from latice_tpu_torch.index import IndexPipeline, PatternDictionaryIndexer
from latice_tpu_torch.index.pipeline import as_preprocess_fn
from latice_tpu_torch.parallel.mesh import chunk_device
from latice_tpu_torch.utils.device import get_platform

logger = logging.getLogger(__name__)

__all__ = ["IndexService", "make_server"]


class IndexService:
    """Thread-safe indexing facade over a pipeline and its encoder.

    Args:
        model: the port's VAE with its weights; ``None`` in pattern-DI mode.
        db: a loaded `index.TorchLatentVectorDatabase`; ``None`` in
            pattern-DI mode.
        top_n / orientation_threshold / min_required_matches: consensus knobs.
        batch_size: rows per device batch.
        image_size: pattern height and width after the default transform.
        max_body_bytes: bodies above this are refused with 413 (1 GiB).
        engine: "exact", "fused", "approx" or "int8" (see
            `index.IndexPipeline`; pattern DI refuses "fused").
        preprocess: optional pattern correction run before the encoder by
            ``/index`` and ``/encode`` alike: a callable on ``(B, H, W)``
            float32 device patterns or a `data.PreprocessConfig`.
        param_loader: optional ``checkpoint path -> model`` that enables
            `reload` and ``POST /reload``.
        checkpoint_root: optional directory that reload targets must lie
            under (relative paths are taken from it).
        nlpar_h: optional NLPAR smoothing strength: a 4-D ``(R, C, H, W)``
            ``/index`` body is then a scan, scaled to model units by its
            integer dtype, denoised and indexed row by row (3-D bodies index
            unchanged). Hot pixels are repaired first at the preprocess
            recipe's threshold, when it has one.
        nlpar_radius: NLPAR search-window half-width (1 = 3x3).
        di_dictionary: optional ``(patterns, angles)`` or ``(patterns,
            angles, phases, groups)``: pattern-DI mode, ``/index`` by NCC
            against the raw stack, with ``model=None, db=None``; ``/encode``
            and ``/reload`` answer 400.
        di_bin: DI mean-pool factor (dictionary and queries).
        hough_indexer: optional `index.HoughIndexer` (or
            `index.MultiPhaseHoughIndexer`) enabling ``POST /hough``; with
            it, ``model``, ``db`` and ``di_dictionary`` may all be None
            (zero-training mode: ``/index``, ``/encode`` and ``/reload``
            answer 400).
        sphere_indexer: optional `index.SphericalIndexer` (or
            `index.MultiPhaseSphericalIndexer`) enabling ``POST /sphere``;
            like ``hough_indexer``, it may serve alone (zero-training mode).
        strain_config: optional dict enabling ``POST /strain`` (HR-EBSD
            against a held reference): required keys ``reference`` (an
            ``(H, W)`` array) and ``geometry`` (`sim.DetectorGeometry`);
            the other keys pass through to `hrebsd.hrebsd_map`
            (``stiffness``, ``remap_iterations``, ``roi_size``, ...), and
            ``chunk`` defaults to 128. It may serve alone too.
        mesh: optional `parallel.Mesh`: the dictionary shards over its
            devices and each ``/index`` and ``/encode`` batch shards over
            them (see `index.IndexPipeline`; ``batch_size`` must divide by
            the mesh size); ``/healthz`` reports ``mesh_devices``.
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.
    """

    def __init__(
        self,
        model: torch.nn.Module | None,
        db,
        top_n: int = 20,
        orientation_threshold: float = 3.0,
        min_required_matches: int = 18,
        batch_size: int = 256,
        image_size: tuple[int, int] = (128, 128),
        max_body_bytes: int = 1 << 30,
        engine: str = "exact",
        preprocess=None,
        param_loader=None,
        checkpoint_root: str | None = None,
        nlpar_h: float | None = None,
        nlpar_radius: int = 1,
        di_dictionary: tuple | None = None,
        di_bin: int = 1,
        hough_indexer=None,
        sphere_indexer=None,
        strain_config: dict | None = None,
        mesh=None,
        device: str | torch.device | None = None,
    ) -> None:
        self._strain = None
        if strain_config is not None:
            sc = dict(strain_config)
            strain_ref = np.asarray(sc.pop("reference"))
            strain_geom = sc.pop("geometry")
            if strain_ref.shape != tuple(strain_geom.shape):
                raise ValueError(
                    f"strain reference {strain_ref.shape} does not match geometry "
                    f"{strain_geom.shape}"
                )
            sc.setdefault("chunk", 128)
            self._strain = (strain_ref, strain_geom, sc)
        if (di_dictionary is None and (model is None or db is None) and hough_indexer is None
                and sphere_indexer is None and self._strain is None):
            raise ValueError(
                "pass model and db, di_dictionary for pattern-DI mode, or at least one "
                "zero-training plane (hough_indexer, sphere_indexer or strain_config)"
            )
        self.device = chunk_device(mesh, device)
        self.mesh = mesh
        phase_kw = {}
        if di_dictionary is not None:
            if len(di_dictionary) == 4 and di_dictionary[2] is not None:
                phase_kw = dict(
                    dictionary_phases=di_dictionary[2], phase_symmetries=di_dictionary[3]
                )
        elif db is not None and db._has_phases:
            phase_kw = dict(
                dictionary_phases=db._phases, phase_symmetries=db.config.phase_symmetries
            )
        # Taken before the recipe is compiled: scan-mode NLPAR repairs hot
        # pixels before averaging.
        self._nlpar_hot_threshold = getattr(preprocess, "hot_pixel_threshold", None)
        preprocess = as_preprocess_fn(preprocess)
        self._pipeline_kw = dict(
            top_n=top_n,
            orientation_threshold=orientation_threshold,
            min_required_matches=min_required_matches,
            batch_size=batch_size,
            engine=engine,
            preprocess=preprocess,
            mesh=mesh,
            device=device,
            **phase_kw,
        )
        self._db = db
        self._di = di_dictionary
        self._di_bin = int(di_bin)
        self._hough = hough_indexer
        self._sphere = sphere_indexer
        self._quality_detector = None
        zero_training = di_dictionary is None and (model is None or db is None)
        self.pipeline = None if zero_training else self._build_pipeline(model)
        self.image_size = tuple(image_size)
        self.max_body_bytes = int(max_body_bytes)
        self._param_loader = param_loader
        self.checkpoint_root = checkpoint_root
        self.nlpar_h = None if nlpar_h is None else float(nlpar_h)
        self.nlpar_radius = int(nlpar_radius)
        self.model_version = 0
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.patterns_indexed = 0

    def _build_pipeline(self, model: torch.nn.Module | None):
        if self._di is not None:
            return PatternDictionaryIndexer(
                self._di[0], self._di[1], bin_factor=self._di_bin, **self._pipeline_kw
            )
        return IndexPipeline(model, self._db._vectors, self._db._orientations, **self._pipeline_kw)

    def _confine(self, checkpoint: str) -> str:
        """``checkpoint`` resolved under ``checkpoint_root``; a path that
        leaves the root (``../``, an absolute path elsewhere, a symlink out)
        raises ``ValueError`` naming only what the client sent."""
        if self.checkpoint_root is None:
            return checkpoint
        root = os.path.realpath(self.checkpoint_root)
        target = os.path.realpath(os.path.join(root, checkpoint))
        if os.path.commonpath([root, target]) != root:
            raise ValueError(f"checkpoint {checkpoint!r} is outside the configured checkpoint root")
        return target

    def _need_pipeline(self) -> None:
        if self.pipeline is None:
            raise ValueError(
                "this server runs only zero-training planes (no dictionary or checkpoint "
                "loaded); POST /hough, /sphere, /strain or /quality"
            )

    def reload(self, checkpoint: str) -> dict:
        """Hot-swap the model from ``checkpoint`` without dropping requests:
        the new pipeline is built while the old one keeps serving, then
        swapped in under the lock, and ``model_version`` goes up."""
        self._need_pipeline()
        if self._di is not None:
            raise ValueError("this server runs pattern DI: it has no model to reload")
        if self._param_loader is None:
            raise ValueError("service was started without a param_loader")
        checkpoint = self._confine(checkpoint)
        t0 = time.time()
        pipeline = self._build_pipeline(self._param_loader(checkpoint))
        with self._lock:
            self.pipeline = pipeline
            self.model_version += 1
            version = self.model_version
        return {
            "status": "reloaded",
            "checkpoint": checkpoint,
            "model_version": version,
            "seconds": time.time() - t0,
        }

    def warmup(self) -> float:
        """Run one dummy batch of each input dtype through the pipeline,
        which builds the kernels on first use, and one through each
        zero-training indexer; returns seconds. ``/encode`` runs the same
        encoder."""
        t0 = time.time()
        h, w = self.image_size
        with self._lock:
            if self.pipeline is not None:
                for dtype in (np.uint8, np.float32):
                    self.pipeline(np.zeros((1, h, w), dtype))
            if self._hough is not None:
                self._hough(np.zeros((1, h, w), np.float32))
            if self._sphere is not None:
                self._sphere.index_patterns(np.zeros((1, h, w), np.float32))
            if self._strain is not None:
                ref, geom, kw = self._strain
                hrebsd_map(ref[None], ref, geom, device=self.device, **kw)
        dt = time.time() - t0
        logger.info(f"warmup ran the served paths in {dt:.1f}s")
        return dt

    def _denoise_scan(self, scan: np.ndarray) -> np.ndarray:
        """An ``(R, C, H, W)`` body NLPAR-denoised, as ``(R*C, H, W)``
        float32 in model units."""
        if self.nlpar_h is None:
            raise ValueError(
                "4-D (R, C, H, W) scan bodies need the server to run with --nlpar; "
                "POST a 3-D (N, H, W) stack instead"
            )
        if scan.shape[-2:] != self.image_size:
            raise ValueError(
                f"scan patterns are {scan.shape[-2]}x{scan.shape[-1]} but this server "
                f"indexes {self.image_size[0]}x{self.image_size[1]}"
            )
        # NLPAR returns float32, so the pipeline's uint8 /255 would not fire:
        # integer scans are scaled here as prepare_patterns scales them.
        x = scan.astype(np.float32)
        if np.issubdtype(scan.dtype, np.integer):
            x *= _int_scale(scan.dtype)
        return nlpar_denoise(
            x, search_radius=self.nlpar_radius, h=self.nlpar_h,
            hot_pixel_threshold=self._nlpar_hot_threshold, device=self.device,
        ).reshape(-1, *self.image_size)

    def index(self, patterns: np.ndarray) -> dict:
        """Index a pattern stack, or with ``nlpar_h`` an ``(R, C, H, W)``
        scan; returns a JSON-ready dict."""
        self._need_pipeline()
        scan_grid = None
        arr = np.asarray(patterns)
        if arr.ndim == 4 and arr.shape[-1] not in (1, 3):
            scan_grid = arr.shape[:2]
            patterns = self._denoise_scan(arr)
        x = prepare_patterns(patterns, self.image_size)
        t0 = time.time()
        with self._lock:
            res = self.pipeline(x)
            self.requests += 1
            self.patterns_indexed += len(x)
        mean_rows = [
            row.tolist() if np.all(np.isfinite(row)) else [None] * len(row)
            for row in np.atleast_2d(res.mean_orientation)
        ]
        out = {
            "n": int(len(x)),
            "orientations": np.nan_to_num(res.best_orientation).tolist(),
            "mean_orientations": mean_rows,
            "success": res.success.tolist(),
            "n_similar": res.n_similar.tolist(),
            "seconds": time.time() - t0,
            # Which input path produced the result: uint8 (divided on the
            # device) or float32.
            "input_dtype": str(x.dtype),
        }
        if res.phase is not None:
            out["phase"] = res.phase.tolist()
        if scan_grid is not None:
            out["scan_grid"] = [int(scan_grid[0]), int(scan_grid[1])]
        return out

    def encode(self, patterns: np.ndarray) -> dict:
        """Encode patterns to ``mu`` latents; returns a JSON-ready dict."""
        self._need_pipeline()
        if self._di is not None:
            raise ValueError("this server runs pattern DI (no encoder); POST /index")
        x = prepare_patterns(patterns, self.image_size)
        with self._lock:
            lat = self.pipeline.encode(x)
            self.requests += 1
        return {"n": int(len(x)), "latents": lat.tolist()}

    def quality(self, patterns: np.ndarray) -> dict:
        """Hough band detection and Image Quality of a stack (`data.BandDetector`)."""
        x = prepare_patterns(patterns, self.image_size)
        t0 = time.time()
        with self._lock:
            if self._quality_detector is None:
                # Built at the first request: the Radon matrix costs a
                # host precompute and 283 MB of device memory at 128x128.
                batch = 256 if self.pipeline is None else min(self.pipeline.batch_size, 256)
                self._quality_detector = BandDetector(
                    height=self.image_size[0], width=self.image_size[1], batch_size=batch,
                    device=self.device,
                )
            det = self._quality_detector(x)
            self.requests += 1
        return {
            "n": int(len(x)),
            "iq": det.iq.tolist(),
            "band_count": det.band_count.tolist(),
            "mean_iq": float(det.iq.mean()) if len(x) else None,
            "seconds": time.time() - t0,
        }

    def hough(self, patterns: np.ndarray) -> dict:
        """Band-based orientation indexing (`index.HoughIndexer`): only
        reflectors and the geometry, no checkpoint."""
        if self._hough is None:
            raise ValueError("server started without a Hough indexer (cli.serve --hough)")
        x = prepare_patterns(patterns, self.image_size)
        t0 = time.time()
        with self._lock:
            res = self._hough(x)
            self.requests += 1
            self.patterns_indexed += len(x)
        out = {
            "n": int(len(x)),
            "orientations": res.eulers_deg.tolist(),
            "success": res.success.tolist(),
            "fit_deg": res.fit_deg.tolist(),
            "n_matched": res.n_matched.tolist(),
            "iq": res.bands.iq.tolist(),
            "seconds": time.time() - t0,
            "input_dtype": str(x.dtype),
        }
        if getattr(res, "phase", None) is not None:
            out["phase"] = res.phase.tolist()
        return out

    def sphere(self, patterns: np.ndarray, ambiguity: bool = False) -> dict:
        """Spherical-harmonic SO(3) indexing (`index.SphericalIndexer`):
        dictionary-free, only a master pattern and the geometry.

        ``ambiguity`` (``POST /sphere?ambiguity=1``) also runs the
        secondary-peak pseudo-symmetry diagnostic (a second correlation
        pass) and adds ``ambiguity_angle_deg``, ``ambiguity_gap`` and
        ``ambiguity_has_rival`` (NaN as null). A multi-phase server
        diagnoses against its first master."""
        if self._sphere is None:
            raise ValueError(
                "server started without a spherical indexer (cli.serve --sphere-master)"
            )
        x = prepare_patterns(patterns, self.image_size)
        t0 = time.time()
        with self._lock:
            res = self._sphere.index_patterns(x)
            amb = None
            if ambiguity:
                amb = getattr(self._sphere, "indexers", [self._sphere])[0].ambiguity(x)
            self.requests += 1
            self.patterns_indexed += len(x)
        out = {
            "n": int(len(x)),
            "orientations": res.eulers_deg.tolist(),
            "scores": res.scores.tolist(),
            "seconds": time.time() - t0,
            "input_dtype": str(x.dtype),
        }
        if getattr(res, "phase", None) is not None:
            out["phase"] = res.phase.tolist()
        if amb is not None:
            def nan_null(a):
                return [None if np.isnan(v) else float(v) for v in a]

            out["ambiguity_angle_deg"] = nan_null(amb.angle_deg)
            out["ambiguity_gap"] = nan_null(amb.score_gap)
            out["ambiguity_has_rival"] = amb.has_rival.tolist()
        return out

    def strain(self, patterns: np.ndarray) -> dict:
        """HR-EBSD strain and rotation against the held reference
        (`hrebsd.hrebsd_map`)."""
        if self._strain is None:
            raise ValueError("server started without a strain reference (cli.serve --strain-ref)")
        ref, geom, kw = self._strain
        # The raw frames, not prepare_patterns': center-crop padding would
        # plant false features, and hrebsd_map widens uint8 on the device.
        x = np.asarray(patterns)
        if x.ndim == 2:
            x = x[None]
        if x.ndim == 4 and x.shape[-1] == 1:
            x = x[..., 0]
        if x.ndim != 3 or x.shape[1:] != tuple(geom.shape):
            raise ValueError(
                f"strain patterns must be (N, {geom.shape[0]}, {geom.shape[1]}) matching the "
                f"reference; got {np.asarray(patterns).shape}"
            )
        t0 = time.time()
        with self._lock:
            res = hrebsd_map(x, ref, geom, device=self.device, **kw)
            self.requests += 1
            self.patterns_indexed += len(x)
        out = {
            "n": int(len(x)),
            "strain": res.strain.tolist(),
            "rotation": res.rotation.tolist(),
            "rotation_deg": res.rotation_deg.tolist(),
            "von_mises": von_mises_strain(res.strain).tolist(),
            "residual_px": res.residual_px.tolist(),
            "mean_quality": float(res.quality.mean()) if len(x) else None,
            "seconds": time.time() - t0,
            "input_dtype": str(x.dtype),
        }
        if res.stress is not None:
            out["stress"] = res.stress.tolist()
        return out

    def health(self) -> dict:
        if self.pipeline is None:
            mode, count, dimension, multiphase = "zero-training", 0, 0, False
        elif self._di is not None:
            mode, count, dimension = "pattern-di", len(self._di[1]), self.pipeline.dimension
            multiphase = len(self._di) == 4 and self._di[2] is not None
        else:
            mode, count = "latent", self._db.get_count()
            dimension, multiphase = self._db.dimension, self._db._has_phases
        planes = ["index"] if self.pipeline is not None else []
        if self._hough is not None:
            planes.append("hough")
        if self._sphere is not None:
            planes.append("sphere")
        if self._strain is not None:
            planes.append("strain")
        return {
            "status": "ok",
            "mode": mode,
            "count": int(count),
            "dimension": int(dimension),
            "platform": get_platform(),
            "engine": None if self.pipeline is None else self.pipeline.engine,
            "batch_size": 0 if self.pipeline is None else int(self.pipeline.batch_size),
            "multiphase": bool(multiphase),
            "planes": planes,
            "mesh_devices": 0 if self.mesh is None else int(self.mesh.size),
            "model_version": self.model_version,
            "uptime_s": time.time() - self.started,
            "requests": self.requests,
            "patterns_indexed": self.patterns_indexed,
        }


class _Handler(BaseHTTPRequestHandler):
    service: IndexService  # set by make_server

    def _reply(self, code: int, payload: dict) -> None:
        # allow_nan=False: a NaN reaching a reply is a server bug, not
        # something to send as invalid JSON.
        body = json.dumps(payload, allow_nan=False).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # through logging, not stderr
        logger.debug("%s " + fmt, self.address_string(), *args)

    def do_GET(self) -> None:
        if self.path == "/healthz":
            self._reply(200, self.service.health())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            self._reply(400, {"error": "bad Content-Length header"})
            return
        if length > self.service.max_body_bytes:
            # Drain (bounded, in chunks) so a client that writes the whole
            # body before reading sees the 413 instead of a broken pipe;
            # past the cap, close the connection instead.
            drain_cap = 64 << 20
            remaining = min(length, drain_cap)
            while remaining > 0:
                chunk = self.rfile.read(min(1 << 20, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
            if length > drain_cap:
                self.close_connection = True
            self._reply(
                413,
                {
                    "error": f"body of {length} bytes exceeds the "
                    f"{self.service.max_body_bytes}-byte limit"
                },
            )
            return
        if self.path == "/reload":
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                requested = body["checkpoint"]
                self._reply(200, self.service.reload(requested))
            except (KeyError, TypeError, ValueError) as e:  # JSONDecodeError is a ValueError
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                logger.exception("reload failed")
                # The exception may name resolved paths; reply with what was sent.
                self._reply(500, {"error": f"{type(e).__name__}: could not load {requested!r}"})
            return
        routes = {
            "/index": self.service.index,
            "/encode": self.service.encode,
            "/quality": self.service.quality,
            "/hough": self.service.hough,
            "/sphere": self.service.sphere,
            "/strain": self.service.strain,
        }
        path, _, query = self.path.partition("?")
        if path not in routes:
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        kwargs = {}
        if path == "/sphere" and query:
            from urllib.parse import parse_qs

            amb = parse_qs(query).get("ambiguity", ["0"])[-1].lower()
            kwargs["ambiguity"] = amb in ("1", "true", "yes")
        try:
            patterns = np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)
        except Exception as e:  # a malformed body must not kill the server
            self._reply(400, {"error": f"body must be .npy bytes: {e}"})
            return
        try:
            self._reply(200, routes[path](patterns, **kwargs))
        except ValueError as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:
            logger.exception("request failed")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(
    service: IndexService, host: str = "127.0.0.1", port: int = 8800
) -> ThreadingHTTPServer:
    """Build the HTTP server (not yet serving: call ``serve_forever()``)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)
