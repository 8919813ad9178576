"""EBSD pattern dataset: ``.npy`` pattern stacks and orientation angle files.

The port of ``latice_tpu.data.dataset`` (reference latice/data_module.py:
36-133): the whole stack is transformed once at load time and served as
NHWC float32 slices. Angle files go through the native C++ parser
(`latice_tpu_torch.native`) where g++ can build it, and through the Python
parser otherwise; both give the same array.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from latice_tpu_torch.data.transforms import default_transform

logger = logging.getLogger(__name__)

__all__ = ["parse_angle_file", "DPdataset"]


def parse_angle_file(path: str | Path) -> np.ndarray:
    """Parse a rotation-angle text file into an (N, 3) float64 array of degrees.

    Formats:
    * reference anglefile (data/anglefile_sample.txt): two header lines
      (convention tag, count), then one whitespace-separated ``z1 x z2``
      triple per line, degrees;
    * TSL/OIM ``.ang`` (by extension): ``#``-comment header, Euler radians
      in the first three columns, converted to degrees here.
    """
    path = Path(path)
    if path.suffix.lower() == ".ang":
        try:
            rows = np.loadtxt(path, comments="#", ndmin=2)
        except FileNotFoundError:
            logger.error(f"Rotation angles file not found: {path}")
            raise
        except Exception as e:
            raise ValueError(f"Failed to parse .ang file: {e}") from e
        if rows.shape[1] < 3:
            raise ValueError(f"expected >=3 columns in .ang file, got {rows.shape[1]}")
        return np.degrees(rows[:, :3]).astype(np.float64)
    from latice_tpu_torch import native

    # The first-party C++ parser when g++ builds it (the same contract: a
    # missing or malformed file raises there too); else Python.
    if native.available():
        return native.parse_angle_file_native(path)
    try:
        with open(path) as f:
            lines = f.readlines()[2:]
    except FileNotFoundError:
        logger.error(f"Rotation angles file not found: {path}")
        raise
    try:
        rows = [[float(v) for v in line.split()] for line in lines if line.strip()]
        angles = np.asarray(rows, dtype=np.float64)
        if angles.ndim != 2 or angles.shape[1] != 3:
            raise ValueError(f"expected 3 angles per row, got shape {angles.shape}")
        return angles
    except Exception as e:
        logger.error(f"Error parsing rotation angles: {e}")
        raise ValueError(f"Failed to parse rotation angles file: {e}") from e


class DPdataset:
    """Diffraction-pattern dataset over a 3-D ``.npy`` stack and an angle file.

    Attributes:
        patterns: ``(N, H, W, 1)`` float32 transformed patterns.
        rot_angles: ``(N, 3)`` float64 zxz Euler angles in degrees.
    """

    def __init__(
        self,
        path: str | Path,
        rot_angles_path: str | Path,
        image_size: tuple[int, int] = (128, 128),
        transform=None,
    ) -> None:
        path = Path(path)
        try:
            raw = np.load(path)
            logger.info(f"Loaded diffraction pattern data from {path}")
        except Exception as e:
            logger.error(f"Failed to load data from {path}")
            raise ValueError("Only .npy data files are supported.") from e

        if raw.ndim != 3:
            logger.error(f"Invalid data shape: {raw.shape}")
            raise ValueError("The input dataset should be 3D.")

        self.rot_angles = parse_angle_file(rot_angles_path)
        if len(self.rot_angles) != len(raw):
            raise ValueError(f"Pattern count {len(raw)} != angle count {len(self.rot_angles)}")

        if transform is None:
            self.patterns = default_transform(raw, image_size)
        else:
            self.patterns = np.stack([transform(p) for p in raw])
        logger.info(f"Dataset initialized with {len(self)} samples")

    def __len__(self) -> int:
        return self.patterns.shape[0]

    def __getitem__(self, idx) -> tuple[np.ndarray, np.ndarray]:
        """(transformed pattern(s), rotation angle(s)), slice-friendly."""
        return self.patterns[idx], self.rot_angles[idx]
