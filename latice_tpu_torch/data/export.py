"""Result export to the EBSD interchange formats ``.ang`` and ``.ctf``.

The port's own copy of ``latice_tpu.data.export`` (numpy only): TSL/OIM
``.ang`` and Oxford Channel Text ``.ctf`` writers for a `DenseIndexResult`,
and readers for both. The files are those the JAX package writes, byte for
byte; rows are formatted by the native C++ formatter
(`latice_tpu_torch.native`) where g++ can build it, else by the Python
loop, which writes the same bytes.

Angle convention: the stored zxz Euler triplets are written verbatim
(radians in ``.ang``, degrees in ``.ctf``). Unindexed points follow each
format's own convention: CI = -1 in ``.ang``; phase 0, error 3 and zeroed
angles in ``.ctf``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["VendorMap", "read_ang", "read_ctf", "write_ang", "write_ctf"]

# Proper rotation point group -> TSL .ang "Symmetry" code (the code of the
# corresponding Laue class as TSL numbers it).
_ANG_SYMMETRY = {
    "432": "43", "23": "23", "622": "62", "6": "6", "422": "42", "4": "4",
    "32": "32", "3": "3", "222": "22", "2": "20", "1": "1",
}
# Proper rotation point group -> CTF Laue group number (1..11, triclinic ->
# cubic m-3m) and lattice angles of the matching crystal family.
_CTF_LAUE = {
    "1": 1, "2": 2, "222": 3, "4": 4, "422": 5, "3": 6, "32": 7,
    "6": 8, "622": 9, "23": 10, "432": 11,
}
_HEX_FAMILY = {"3", "32", "6", "622"}  # gamma = 120 lattice angle


def _grid_xy(n: int, grid: tuple[int, int] | None, step: float):
    """(x, y) scan coordinates: row-major grid, or a single line when no
    grid shape is given."""
    if grid is None:
        return np.arange(n) * step, np.zeros(n)
    rows, cols = grid
    if rows * cols != n:
        raise ValueError(f"grid {rows}x{cols} does not hold {n} points")
    idx = np.arange(n)
    return (idx % cols) * step, (idx // cols) * step


def _confidence(result) -> np.ndarray:
    """Confidence index in [0, 1]: mean candidate cosine similarity."""
    return np.clip(np.mean(result.scores, axis=1), 0.0, 1.0)


# Placeholder cell (Angstrom) written when the caller supplies no lattice
# constants. 3.6 == fcc Cu; real analysis should pass phase_lattices.
_PLACEHOLDER_ABC = (3.6, 3.6, 3.6)


def _lattice_abc(phase_lattices, i: int) -> tuple[float, float, float]:
    if phase_lattices is not None and i < len(phase_lattices):
        a, b, c = phase_lattices[i]
        return float(a), float(b), float(c)
    return _PLACEHOLDER_ABC


def write_ang(
    path: str,
    result,
    grid: tuple[int, int] | None = None,
    step: float = 1.0,
    phase_names: list[str] | None = None,
    phase_groups: list[str] | None = None,
    phase_lattices: list[tuple[float, float, float]] | None = None,
    iq: np.ndarray | None = None,
) -> None:
    """Write a `DenseIndexResult` as a TSL/OIM ``.ang`` file.

    Columns: phi1 Phi phi2 (radians) x y IQ CI phase intensity fit. IQ
    carries the top candidate similarity by default — pass ``iq`` (e.g.
    a detector-side Hough IQ) for the detector-side
    value vendors write; CI the mean candidate similarity
    (-1 where indexing failed, TSL's unindexed marker), fit the consensus
    match count.

    Args:
        path: Output file.
        result: `DenseIndexResult` (index plane output).
        grid: Optional (rows, cols) scan shape for x/y columns.
        step: Scan step size (same unit the header declares, microns).
        phase_names: Names for the phase header blocks (default Phase1...).
        phase_groups: Proper rotation point group per phase
            (`crystal.ROTATION_GROUPS` keys) for the header Symmetry codes;
            defaults to cubic "432" per phase.
        phase_lattices: Optional per-phase lattice constants (a, b, c) in
            Angstrom for the header ``LatticeConstants`` lines. The default
            3.6/3.6/3.6 is a **placeholder**, not a real cell — supply true
            constants (especially c for hexagonal/tetragonal phases) before
            doing plane/direction math downstream. Lattice angles are
            derived from the phase's crystal family (gamma=120 for the
            hexagonal family, else all 90).
    """
    n = len(result.success)
    x, y = _grid_xy(n, grid, step)
    euler_rad = np.deg2rad(np.nan_to_num(result.best_orientation))
    ci = np.where(result.success, _confidence(result), -1.0)
    if iq is None:
        # Similarity-derived stand-in; pass a real detector-side IQ
        # (a Hough IQ) when available.
        iq = np.clip(result.scores[:, 0], 0.0, 1.0)
    else:
        iq = np.asarray(iq, np.float64)
        if iq.shape != (n,):
            raise ValueError(f"iq must be ({n},), got {iq.shape}")
    phases = (
        result.phase
        if result.phase is not None
        else np.zeros(n, dtype=np.int64)
    )
    n_phases = int(np.max(phases)) + 1 if n else 1
    names = phase_names or [f"Phase{i + 1}" for i in range(n_phases)]

    groups = list(phase_groups) if phase_groups else ["432"] * len(names)
    rows_, cols_ = grid if grid is not None else (1, n)
    lines = ["# TEM_PIXperUM          1.000000", "# x-star                0.000000"]
    for i, name in enumerate(names):
        g = groups[i] if i < len(groups) else "432"
        sym = _ANG_SYMMETRY.get(g, "43")
        a, b, c = _lattice_abc(phase_lattices, i)
        gamma = 120.0 if g in _HEX_FAMILY else 90.0
        lines += [
            f"# Phase {i + 1}",
            f"# MaterialName  \t{name}",
            "# Formula     \t",
            "# Info ",
            f"# Symmetry              {sym}",
            f"# LatticeConstants      {a:.3f} {b:.3f} {c:.3f}"
            f"  90.000  90.000  {gamma:.3f}",
            "#",
        ]
    lines += [
        "# GRID: SqrGrid",
        f"# XSTEP: {step:.6f}",
        f"# YSTEP: {step:.6f}",
        f"# NCOLS_ODD: {cols_}",
        f"# NCOLS_EVEN: {cols_}",
        f"# NROWS: {rows_}",
        "#",
        "# OPERATOR: \tlatice_tpu",
        "#",
    ]
    # .ang phase column is 1-based in multi-phase files, 0 allowed
    # for single-phase; keep 1-based for uniformity.
    phase1 = np.asarray(phases, np.int64) + 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write(
            _ang_rows(euler_rad, x, y, iq, ci, phase1, result.n_similar)
        )


def _ang_rows(euler_rad, x, y, iq, ci, phase1, n_similar) -> str:
    """Data rows of `write_ang`: the native formatter, or the Python loop
    without a toolchain or where a row outgrows the native buffer."""
    try:
        from latice_tpu_torch import native

        return native.format_ang_rows_native(euler_rad, x, y, iq, ci, phase1, n_similar)
    except (ImportError, ValueError):
        return _ang_rows_python(euler_rad, x, y, iq, ci, phase1, n_similar)


def _ang_rows_python(euler_rad, x, y, iq, ci, phase1, n_similar) -> str:
    return "".join(
        f"  {euler_rad[i, 0]:.5f}  {euler_rad[i, 1]:.5f}"
        f"  {euler_rad[i, 2]:.5f}  {x[i]:.5f}  {y[i]:.5f}"
        f"  {iq[i]:.3f}  {ci[i]:.3f}  {int(phase1[i])}"
        f"  1.000  {float(n_similar[i]):.3f}\n"
        for i in range(len(phase1))
    )


def write_ctf(
    path: str,
    result,
    grid: tuple[int, int] | None = None,
    step: float = 1.0,
    phase_names: list[str] | None = None,
    phase_groups: list[str] | None = None,
    phase_lattices: list[tuple[float, float, float]] | None = None,
    bands: np.ndarray | None = None,
) -> None:
    """Write a `DenseIndexResult` as an Oxford Channel Text File (``.ctf``).

    Columns: Phase X Y Bands Error Euler1 Euler2 Euler3 MAD BC BS — Euler in
    degrees, phase 1-based (0 = unindexed, the CTF convention), Bands carries
    the consensus match count (or the real detected band count when
    ``bands`` is passed), MAD the (1 - mean similarity)
    residual.
    ``phase_groups`` names each phase's proper rotation point group so the
    header carries the right Laue class and lattice angles (default cubic).
    ``phase_lattices`` gives each phase's true (a, b, c) in Angstrom; the
    3.6/3.6/3.6 default is a **placeholder** (implied c/a = 1 is wrong for
    hexagonal/tetragonal cells, and Channel/MTEX use these values for
    plane/direction math — supply real constants for non-cubic phases).
    """
    n = len(result.success)
    x, y = _grid_xy(n, grid, step)
    euler = np.nan_to_num(result.best_orientation)
    mad = 1.0 - _confidence(result)
    phases = (
        result.phase
        if result.phase is not None
        else np.zeros(n, dtype=np.int64)
    )
    n_phases = int(np.max(phases)) + 1 if n else 1
    names = phase_names or [f"Phase{i + 1}" for i in range(n_phases)]

    rows_, cols_ = grid if grid is not None else (1, n)
    header = [
        "Channel Text File",
        "Prj\tlatice_tpu indexing",
        "Author\tlatice_tpu",
        "JobMode\tGrid",
        f"XCells\t{cols_}",
        f"YCells\t{rows_}",
        f"XStep\t{step:.4f}",
        f"YStep\t{step:.4f}",
        "AcqE1\t0.0000",
        "AcqE2\t0.0000",
        "AcqE3\t0.0000",
        "Euler angles refer to Sample Coordinate system (CS0)!",
        f"Phases\t{len(names)}",
    ]
    groups = list(phase_groups) if phase_groups else ["432"] * len(names)
    for i, name in enumerate(names):
        g = groups[i] if i < len(groups) else "432"
        laue = _CTF_LAUE.get(g, 11)
        gamma = "120.000" if g in _HEX_FAMILY else "90.000"
        a, b, c = _lattice_abc(phase_lattices, i)
        # lattice params;angles;name;laue group;space group (0 = unspecified:
        # the point group, not a full space group, is what the index knows)
        header.append(
            f"{a:.3f};{b:.3f};{c:.3f}\t90.000;90.000;{gamma}\t{name}\t{laue}\t0"
        )
    header.append("Phase\tX\tY\tBands\tError\tEuler1\tEuler2\tEuler3\tMAD\tBC\tBS")
    ok = np.asarray(result.success, bool)
    phase_col = np.where(ok, np.asarray(phases, np.int64) + 1, 0)
    err_col = np.where(ok, 0, 3)  # 3: "no solution" in Channel files
    euler_col = np.where(ok[:, None], euler, 0.0)
    if bands is None:
        # Consensus match count as a stand-in; pass the real detected band
        # count for the vendor semantic of this column.
        bands = np.asarray(result.n_similar, np.int64)
    else:
        bands = np.asarray(bands, np.int64)
        if bands.shape != (n,):
            raise ValueError(f"bands must be ({n},), got {bands.shape}")
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        f.write(_ctf_rows(phase_col, x, y, bands, err_col, euler_col, mad))


def _ctf_rows(phase, x, y, bands, err, euler_deg, mad) -> str:
    """Data rows of `write_ctf`, native or Python as `_ang_rows`."""
    try:
        from latice_tpu_torch import native

        return native.format_ctf_rows_native(phase, x, y, bands, err, euler_deg, mad)
    except (ImportError, ValueError):
        return _ctf_rows_python(phase, x, y, bands, err, euler_deg, mad)


def _ctf_rows_python(phase, x, y, bands, err, euler_deg, mad) -> str:
    return "".join(
        f"{int(phase[i])}\t{x[i]:.4f}\t{y[i]:.4f}\t{int(bands[i])}"
        f"\t{int(err[i])}\t{euler_deg[i, 0]:.4f}\t{euler_deg[i, 1]:.4f}"
        f"\t{euler_deg[i, 2]:.4f}\t{mad[i]:.4f}\t255\t255\n"
        for i in range(len(phase))
    )


class VendorMap(NamedTuple):
    """An orientation map parsed from a vendor result file.

    Attributes:
        eulers: (N, 3) zxz Euler angles, **degrees** (this framework's
            anglefile convention — see the module docstring on Bunge vs
            anglefile semantics; angles pass through unreinterpreted).
        phase: (N,) int64 0-based phase ids (-1 where unindexed).
        success: (N,) bool indexed/unindexed mask (.ang: CI >= 0 — TSL's
            convention; .ctf: phase column > 0).
        grid: (rows, cols) from the header, or None when absent.
        step: scan step from the header (XSTEP / XStep), or 1.0.
    """

    eulers: np.ndarray
    phase: np.ndarray
    success: np.ndarray
    grid: tuple[int, int] | None
    step: float


def read_ang(path: str) -> VendorMap:
    """Parse a TSL/OIM ``.ang`` file (the inverse of `write_ang`).

    Columns: phi1 PHI phi2 (radians) x y IQ CI phase [SEM fit ...] — extra
    trailing columns are ignored, so vendor files with more than the
    standard 10 parse too. Grid comes from the ``NROWS``/``NCOLS_ODD``
    header keys when present.
    """
    rows_hdr = cols_hdr = None
    step = 1.0
    data = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            if s.startswith("#"):
                fields = s[1:].split()
                if len(fields) >= 2 and fields[0].rstrip(":") == "NROWS":
                    rows_hdr = int(float(fields[1]))
                elif len(fields) >= 2 and fields[0].rstrip(":") == "NCOLS_ODD":
                    cols_hdr = int(float(fields[1]))
                elif len(fields) >= 2 and fields[0].rstrip(":") == "XSTEP":
                    step = float(fields[1])
                continue
            vals = s.split()
            if len(vals) < 9:
                raise ValueError(
                    f"malformed .ang data row ({len(vals)} columns): {s[:60]}"
                )
            data.append([float(v) for v in vals[:9]])
    if not data:
        raise ValueError(f"no data rows in {path}")
    arr = np.asarray(data, np.float64)
    eulers = np.degrees(arr[:, 0:3])
    ci = arr[:, 6]
    phase = arr[:, 7].astype(np.int64) - 1  # .ang is 1-based
    success = ci >= 0.0
    phase = np.where(success, np.maximum(phase, 0), -1)
    grid = (rows_hdr, cols_hdr) if rows_hdr and cols_hdr else None
    return VendorMap(eulers, phase, success, grid, step)


def read_ctf(path: str) -> VendorMap:
    """Parse an Oxford Channel Text File ``.ctf`` (the inverse of
    `write_ctf`).

    Data columns: Phase X Y Bands Error Euler1..3 (degrees) MAD BC BS;
    phase 0 marks unindexed points (CTF convention). Grid comes from
    ``XCells``/``YCells``.
    """
    rows_hdr = cols_hdr = None
    step = 1.0
    data = []
    in_data = False
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            if in_data:
                vals = s.split()
                if len(vals) < 9:
                    raise ValueError(
                        f"malformed .ctf data row ({len(vals)} columns): "
                        f"{s[:60]}"
                    )
                data.append([float(v) for v in vals[:9]])
                continue
            fields = s.split("\t") if "\t" in s else s.split()
            key = fields[0]
            if key == "XCells" and len(fields) >= 2:
                cols_hdr = int(float(fields[1]))
            elif key == "YCells" and len(fields) >= 2:
                rows_hdr = int(float(fields[1]))
            elif key == "XStep" and len(fields) >= 2:
                step = float(fields[1])
            elif key == "Phase" and "Euler1" in s:
                in_data = True  # the column-header line
    if not data:
        raise ValueError(f"no data rows in {path}")
    arr = np.asarray(data, np.float64)
    phase1 = arr[:, 0].astype(np.int64)
    success = phase1 > 0
    eulers = arr[:, 5:8]
    grid = (rows_hdr, cols_hdr) if rows_hdr and cols_hdr else None
    return VendorMap(
        eulers, np.where(success, phase1 - 1, -1), success, grid, step
    )
