"""ctypes bindings of the first-party host runtime ``native/latice_native.cpp``.

The port's own bridge to the C++ file the JAX package also binds
(``latice_tpu.native``): exact cosine top-k on the host CPU (the DB's
``engine="native"``), the angle-file parser and the ``.ang`` / ``.ctf`` row
formatters. The source is compiled with g++ at first use into the port's
gitignored ``latice_tpu_torch/ops/_build/``, under a file name that carries
a hash of the source, the flags and the host CPU (``-march=native`` code
runs only where it was built), written under a temporary name and moved
into place, so concurrent processes never load a half-written library.
The JAX package's ``native/liblatice_native.so`` is neither read nor
written. Without a toolchain every entry point raises ``ImportError`` and
`available` is False; callers choose their Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "available",
    "build",
    "cosine_topk_native",
    "format_ang_rows_native",
    "format_ctf_rows_native",
    "parse_angle_file_native",
]

ABI_VERSION = 2
SOURCE = Path(__file__).resolve().parents[2] / "native" / "latice_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _cpu_tag() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), empty where ``/proc/cpuinfo`` is absent."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(dict.fromkeys(keep)).encode()


def _library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode() + _cpu_tag()
    ).hexdigest()[:16]
    return BUILD_DIR / f"liblatice_native-{digest}.so"


def build(force: bool = False) -> Path:
    """Compile the shared library with g++ unless it is already built for
    this source, these flags and this CPU; returns its path."""
    out = _library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    logger.info(f"Building native library: {' '.join(cmd)}")
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.latice_native_abi_version.restype = ctypes.c_int32
    if lib.latice_native_abi_version() != ABI_VERSION:
        raise OSError("native ABI version mismatch")
    fp, dp = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    ip, cp, i64 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char), ctypes.c_int64
    lib.latice_cosine_topk.argtypes = [fp, i64, fp, i64, i64, i64, fp, ip, ctypes.c_int32]
    lib.latice_cosine_topk.restype = None
    lib.latice_parse_angle_file.argtypes = [ctypes.c_char_p, dp, i64]
    lib.latice_parse_angle_file.restype = i64
    lib.latice_format_ang_rows.argtypes = [dp, dp, dp, dp, dp, ip, dp, i64, cp, i64]
    lib.latice_format_ang_rows.restype = i64
    lib.latice_format_ctf_rows.argtypes = [ip, dp, dp, ip, ip, dp, dp, i64, cp, i64]
    lib.latice_format_ctf_rows.restype = i64
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except Exception as e:  # no toolchain, bad platform: callers use Python
            logger.info(f"Native library unavailable ({e}); using Python paths")
            _load_failed = True
        return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    return lib


def available() -> bool:
    """True when the native library is (or can be) loaded."""
    return _load() is not None


def cosine_topk_native(
    queries: np.ndarray, dictionary: np.ndarray, k: int, n_threads: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k on the host CPU (rows normalized inside):
    best-first ``(B, k)`` float64 scores and int64 indices, ``k`` cut to
    the dictionary's rows; ``n_threads`` 0 takes every core."""
    lib = _require()
    q = np.ascontiguousarray(queries, dtype=np.float32)
    d = np.ascontiguousarray(dictionary, dtype=np.float32)
    if q.ndim != 2 or d.ndim != 2 or q.shape[1] != d.shape[1]:
        raise ValueError(f"bad shapes {q.shape} vs {d.shape}")
    k = min(k, len(d))
    scores = np.empty((len(q), k), dtype=np.float32)
    indices = np.empty((len(q), k), dtype=np.int64)
    lib.latice_cosine_topk(
        _ptr(q, ctypes.c_float), len(q), _ptr(d, ctypes.c_float), len(d), q.shape[1], k,
        _ptr(scores, ctypes.c_float), _ptr(indices, ctypes.c_int64), n_threads,
    )
    return scores.astype(np.float64), indices


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _format(fn, columns: list[np.ndarray], n: int, what: str) -> str:
    """Rows of ``n`` points formatted by ``fn`` into a buffer of 192 bytes a
    row (``np.empty``: a zero-filled buffer would be written twice). The
    columns must hold ``n`` rows, the Euler one three angles each: the C
    side reads that many."""
    if any(len(c) != n for c in columns) or any(
            c.ndim != 1 and c.shape[1:] != (3,) for c in columns):
        raise ValueError(f"{what} columns must be n or (n, 3) long: "
                         f"{[c.shape for c in columns]}")
    buf = np.empty(192 * n + 1, np.uint8)
    ptrs = [_ptr(c, ctypes.c_double if c.dtype == np.float64 else ctypes.c_int64)
            for c in columns]
    wrote = fn(*ptrs, n, _ptr(buf, ctypes.c_char), len(buf))
    if wrote < 0:
        raise ValueError(f"native {what} formatting overflowed its buffer")
    return buf[:wrote].tobytes().decode("ascii")


def format_ang_rows_native(euler_rad, x, y, iq, ci, phase1, n_similar) -> str:
    """The data rows of ``data.export.write_ang``, byte for byte the Python
    loop's. Raises ``ImportError`` without a toolchain and ``ValueError``
    when a row outgrows its 192 bytes."""
    lib = _require()
    e = _f64(euler_rad)
    cols = [e, _f64(x), _f64(y), _f64(iq), _f64(ci), _i64(phase1), _f64(n_similar)]
    return _format(lib.latice_format_ang_rows, cols, len(e), ".ang")


def format_ctf_rows_native(phase, x, y, bands, err, euler_deg, mad) -> str:
    """The data rows of ``data.export.write_ctf``, byte for byte the Python
    loop's (errors as `format_ang_rows_native`)."""
    lib = _require()
    e = _f64(euler_deg)
    cols = [_i64(phase), _f64(x), _f64(y), _i64(bands), _i64(err), e, _f64(mad)]
    return _format(lib.latice_format_ctf_rows, cols, len(e), ".ctf")


def parse_angle_file_native(path: str | Path, max_rows: int = 10_000_000) -> np.ndarray:
    """An angle file (two header lines, then ``z1 x z2`` triples) as an
    ``(N, 3)`` float64 array; ``FileNotFoundError`` for a missing file and
    ``ValueError`` for one that does not parse."""
    lib = _require()
    out = np.empty((max_rows, 3), dtype=np.float64)
    n = lib.latice_parse_angle_file(str(path).encode(), _ptr(out, ctypes.c_double), max_rows)
    if n == -1:
        raise FileNotFoundError(path)
    if n < 0:
        raise ValueError(f"Failed to parse rotation angles file: {path}")
    return out[:n].copy()
