"""The port's HDF5 and EDAX UP scan readers (`latice_tpu_torch.data.h5io`,
`data.up`) against the JAX package's on the same files, and the indexing
CLI on such files, on the CPU.

* Readers: headers, arrays, slabs and dataset detection (vendor layouts,
  the largest-3-D fallback, an explicit path) equal JAX's; errors carry
  JAX's messages.
* ``query`` (slab-streamed with ``--h5-chunk``, and read whole under
  ``--nlpar``), ``di``, ``strain`` and ``learn-master`` on ``.h5``, ``.up1`` and ``.up2``
  copies of one ``.npy`` stack give that stack's results (``.up2`` holds
  the same frames scaled to 16 bits, which `data.prepare_patterns` scales
  back); a UP header's square scan grid reaches the ``.ang`` export.
* ``--preprocess static=auto`` on an HDF5 scan takes the streamed scan mean
  and equals the ``.npy`` run.
* `latice_tpu_torch` imports with ``h5py`` and ``matplotlib`` absent, and
  `load_patterns` then raises JAX's message.
"""

import json
import struct
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import latice_tpu.data as jdata
import latice_tpu_torch.data as pdata
from latice_tpu_torch.cli import index as port_cli
from latice_tpu_torch.cli._common import _load_raw_pattern_stack
from latice_tpu_torch.data import read_ang

N, ROWS, COLS = 20, 4, 5
SMALL = ["--inplanes", "2", "--latent-dim", "8", "--batch-size", "8", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _write_up(path, patterns, version=3, rows=0, cols=0, hexagonal=False):
    """An EDAX UP file in the documented little-endian layout
    (`data.up`'s header table)."""
    path = str(path)
    dtype = "<u1" if path.endswith(".up1") else "<u2"
    n, h, w = patterns.shape
    with open(path, "wb") as f:
        if version == 1:
            f.write(struct.pack("<4I", 1, w, h, 16))
        else:
            f.write(struct.pack("<4I", version, w, h, 42))
            f.write(struct.pack("<BI", 0, cols))
            f.write(struct.pack("<IB", rows, int(hexagonal)))
            f.write(struct.pack("<2d", 0.5, 0.25))
        f.write(np.ascontiguousarray(patterns, dtype=dtype).tobytes())
    return path


def _strain_scan(n: int = 12, size: int = 64) -> np.ndarray:
    """uint8 patterns of one grain (tests/test_hrebsd.py's oracle)."""
    rng = np.random.default_rng(8)
    k = rng.normal(size=(60, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    mag = rng.uniform(100.0, 500.0, size=(60, 1))
    k *= mag
    phase = rng.uniform(0, 2 * np.pi, 60)
    x = (np.arange(size) + 0.5) / size - 0.5
    r = np.stack([np.broadcast_to(x[None, :], (size, size)),
                  np.broadcast_to(-x[:, None], (size, size)), np.full((size, size), 0.7)], axis=-1)
    out = []
    for _ in range(n):
        a = rng.normal(scale=2e-3, size=(3, 3))
        rr = r @ np.linalg.inv(np.eye(3) + a).T
        u = rr / np.linalg.norm(rr, axis=-1, keepdims=True)
        out.append((mag[:, 0] ** -0.5 * np.cos(u @ k.T + phase)).sum(axis=-1))
    out = np.stack(out)
    return np.round((out - out.min()) / np.ptp(out) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 4x5 scan of random uint8 128x128 frames as .npy, .h5 (EDAX layout),
    .up1 and .up2 (16-bit, x257), its angles, a port dictionary built from
    it, and a 64x64 strain scan in the same four containers."""
    t = tmp_path_factory.mktemp("scanio")
    rng = np.random.default_rng(0)
    scan = rng.integers(0, 256, size=(N, 128, 128), dtype=np.uint8)
    strain = _strain_scan()
    for name, arr in (("scan", scan), ("strain", strain)):
        np.save(t / f"{name}.npy", arr)
        with h5py.File(t / f"{name}.h5", "w") as f:
            f["Scan 1/EBSD/Data/Pattern"] = arr
            f["Scan 1/EBSD/Data/Montage"] = np.zeros((2, 8, 8), np.uint8)
        rows, cols = (ROWS, COLS) if name == "scan" else (3, 4)
        _write_up(t / f"{name}.up1", arr, rows=rows, cols=cols)
        _write_up(t / f"{name}.up2", arr.astype(np.uint16) * 257, rows=rows, cols=cols)
    angles = rng.uniform([0, 20, 0], [340, 140, 340], size=(N, 3))
    (t / "a.txt").write_text(f"eu\n{N}\n" + "".join(f"{a[0]} {a[1]} {a[2]}\n" for a in angles))
    port_cli.main(["build", "--patterns", str(t / "scan.npy"), "--angles", str(t / "a.txt"),
                   "--db", str(t / "db.npz")] + SMALL)
    return t


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --- the readers against JAX's ---------------------------------------------


@pytest.mark.parametrize("ext", [".up1", ".up2"])
@pytest.mark.parametrize("version", [1, 3])
def test_up_reader_matches_jax(tmp_path, ext, version):
    pats = np.random.default_rng(1).integers(0, 256, size=(6, 24, 32)).astype(np.uint16)
    if ext == ".up2":
        pats *= 257
    path = _write_up(tmp_path / f"s{ext}", pats, version=version, rows=2, cols=3)
    got, want = pdata.read_up_header(path), jdata.read_up_header(path)
    for field in ("version", "pattern_width", "pattern_height", "data_offset", "dtype",
                  "n_patterns", "n_columns", "n_rows", "hexagonal", "extra_patterns",
                  "x_step", "y_step", "scan_grid"):
        assert getattr(got, field) == getattr(want, field)
    assert got.scan_grid == ((2, 3) if version == 3 else None)
    _, mm = pdata.open_up_patterns(path)
    assert isinstance(mm, np.memmap)
    np.testing.assert_array_equal(pdata.load_up_patterns(path), jdata.load_up_patterns(path))
    np.testing.assert_array_equal(pdata.load_up_patterns(path), pats)
    for a, b in zip(pdata.iter_up_batches(mm, 4), jdata.iter_up_batches(mm, 4)):
        np.testing.assert_array_equal(a, b)
    assert pdata.UP_EXTENSIONS == jdata.UP_EXTENSIONS


def test_up_reader_errors_match_jax(tmp_path):
    (tmp_path / "t.up1").write_bytes(b"\x01\x00")
    for mod in (pdata, jdata):
        with pytest.raises(ValueError, match="truncated UP header"):
            mod.read_up_header(str(tmp_path / "t.up1"))
        with pytest.raises(ValueError, match="not an EDAX UP pattern file"):
            mod.read_up_header(str(tmp_path / "t.up3"))
    hexa = _write_up(tmp_path / "h.up1", np.zeros((6, 16, 16), np.uint8), rows=2, cols=3,
                     hexagonal=True)
    assert pdata.read_up_header(hexa).scan_grid is None


@pytest.mark.parametrize(
    "layout, dataset",
    [("Scan 1/EBSD/Data/Pattern", None), ("x/EBSD/Data/Patterns", None),
     ("patterns", None), ("patterns", "patterns")],
    ids=["edax", "kikuchipy", "largest", "explicit"],
)
def test_h5_reader_matches_jax(tmp_path, layout, dataset):
    pats = np.random.default_rng(2).integers(0, 256, size=(7, 20, 24), dtype=np.uint8)
    path = str(tmp_path / "s.h5")
    with h5py.File(path, "w") as f:
        f[layout] = pats
        f["aux/small"] = np.zeros((3, 20, 24), np.uint8)
    np.testing.assert_array_equal(pdata.load_patterns(path, dataset),
                                  jdata.load_patterns(path, dataset))
    f, dset = pdata.find_pattern_dataset(path, dataset)
    try:
        assert dset.name == "/" + layout
        slabs = list(pdata.iter_pattern_batches(dset, 3))
    finally:
        f.close()
    assert [len(s) for s in slabs] == [3, 3, 1] and slabs[0].dtype == np.uint8
    np.testing.assert_array_equal(np.concatenate(slabs), pats)
    assert pdata.HDF5_EXTENSIONS == jdata.HDF5_EXTENSIONS
    for mod in (pdata, jdata):
        with pytest.raises(KeyError, match="not found"):
            mod.load_patterns(path, "missing")
    with h5py.File(tmp_path / "e.h5", "w") as f:
        f["v"] = np.zeros(4)
    for mod in (pdata, jdata):
        with pytest.raises(ValueError, match="no \\(N, H, W\\) pattern dataset"):
            mod.load_patterns(str(tmp_path / "e.h5"))


@pytest.mark.parametrize("ext", [".npy", ".h5", ".up1", ".up2"])
def test_raw_stack_reader(files, ext):
    """The reader every pattern command shares (query, di, quality, hough,
    sphere, calibrate, learn-master, strain): the stack, and a UP header's
    scan grid when the flag is absent."""
    import argparse

    args = argparse.Namespace(patterns=str(files / f"scan{ext}"), h5_dataset=None,
                              scan_grid=None)
    raw = _load_raw_pattern_stack(args)
    want = np.load(files / "scan.npy")
    np.testing.assert_array_equal(raw, want.astype(np.uint16) * 257 if ext == ".up2" else want)
    assert args.scan_grid == ([ROWS, COLS] if ext.startswith(".up") else None)
    kept = argparse.Namespace(patterns=str(files / f"scan{ext}"), h5_dataset=None,
                              scan_grid=[2, 10])
    _load_raw_pattern_stack(kept)
    assert kept.scan_grid == [2, 10]


# --- the CLI on scan files --------------------------------------------------


def _query(files, capsys, ext, extra=()):
    t = files
    out = t / f"q{ext}.npy"
    port_cli.main(["query", "--patterns", str(t / f"scan{ext}"), "--db", str(t / "db.npz"),
                   "--out", str(out), "--top-n", "3", "--min-matches", "1", "--h5-chunk", "7",
                   "--ang", str(t / f"q{ext}.ang")] + list(extra) + SMALL)
    return _summary(capsys), np.load(out)


@pytest.mark.parametrize("ext", [".h5", ".up1", ".up2"])
def test_query_streams_scan_files(files, capsys, ext):
    want_sum, want = _query(files, capsys, ".npy", ["--scan-grid", str(ROWS), str(COLS)])
    got_sum, got = _query(files, capsys, ext)
    assert got_sum["n_patterns"] == want_sum["n_patterns"] == N
    assert got_sum["input_dtype"] == ("float32" if ext == ".up2" else "uint8")
    # Self-queries: every top-1 is the query's own row on both paths.
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got_sum["success_rate"] == want_sum["success_rate"]
    vm = read_ang(str(files / f"q{ext}.ang"))
    assert vm.grid == ((ROWS, COLS) if ext.startswith(".up") else (1, N))


def test_query_reads_scan_whole_for_nlpar(files, capsys):
    want_sum, want = _query(files, capsys, ".npy",
                            ["--nlpar", "1.0", "--scan-grid", str(ROWS), str(COLS)])
    got_sum, got = _query(files, capsys, ".up1", ["--nlpar", "1.0"])  # the grid from the header
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got_sum["input_dtype"] == want_sum["input_dtype"] == "float32"


def test_static_auto_on_hdf5(files, capsys):
    flags = ["--preprocess", "hotpixels=6,static=auto,dynamic=auto"]
    want_sum, want = _query(files, capsys, ".npy", flags)
    got_sum, got = _query(files, capsys, ".h5", flags)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got_sum["success_rate"] == want_sum["success_rate"]
    # The streamed mean (slabs of --h5-chunk) equals the whole stack's.
    from latice_tpu_torch.cli._db_cmds import _resolve_static_auto

    cfg = pdata.parse_preprocess_spec("static=auto")
    raw = np.load(files / "scan.npy")
    whole = _resolve_static_auto(cfg, raw).static_background
    slabs = _resolve_static_auto(cfg, (raw[i:i + 7] for i in range(0, N, 7))).static_background
    np.testing.assert_allclose(slabs, whole, rtol=1e-6)


@pytest.mark.parametrize("ext", [".h5", ".up2"])
def test_di_on_scan_files(files, capsys, ext):
    t = files
    runs = {}
    for src in (".npy", ext):
        port_cli.main(["di", "--dict-patterns", str(t / "scan.npy"), "--dict-angles",
                       str(t / "a.txt"), "--patterns", str(t / f"scan{src}"), "--top-n", "3",
                       "--min-matches", "1", "--preprocess", "static=auto",
                       "--out", str(t / f"di{src}.npy"), "--device", "cpu"])
        runs[src] = (_summary(capsys), np.load(t / f"di{src}.npy"))
    np.testing.assert_allclose(runs[ext][1], runs[".npy"][1], atol=1e-4)
    assert runs[ext][0]["success_rate"] == runs[".npy"][0]["success_rate"]


@pytest.mark.parametrize("ext", [".h5", ".up1", ".up2"])
def test_strain_on_scan_files(files, capsys, ext):
    t = files
    for src in (".npy", ext):
        port_cli.main(["strain", "--patterns", str(t / f"strain{src}"), "--roi-size", "32",
                       "--out", str(t / f"st{src}.npz"), "--device", "cpu"])
    capsys.readouterr()
    got, want = np.load(t / f"st{ext}.npz"), np.load(t / "st.npy.npz")
    # .up2 frames are x257: the XCF is scale-invariant up to f32 roundoff.
    np.testing.assert_allclose(got["a"], want["a"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["shifts_px"], want["shifts_px"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("ext", [".h5", ".up1"])
def test_learn_master_on_scan_files(files, capsys, ext):
    t = files
    for src in (".npy", ext):
        port_cli.main(["learn-master", "--patterns", str(t / f"scan{src}"), "--angles",
                       str(t / "a.txt"), "--size", "33", "--out", str(t / f"lm{src}.npy"),
                       "--device", "cpu"])
    summary = _summary(capsys)
    assert summary["n_patterns"] == N
    np.testing.assert_array_equal(np.load(t / f"lm{ext}.npy"), np.load(t / "lm.npy.npy"))


def test_imports_without_h5py_and_matplotlib():
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import latice_tpu_torch, latice_tpu_torch.data, latice_tpu_torch.hrebsd\n"
        "import latice_tpu_torch.cli.index, latice_tpu_torch.cli.serve\n"
        "from latice_tpu_torch.data import load_patterns\n"
        "try:\n"
        "    load_patterns('scan.h5')\n"
        "except ImportError as e:\n"
        "    print(e)\n"
        "assert 'jax' not in sys.modules and 'latice_tpu' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert "HDF5 scan input needs the optional dependency h5py" in out
