"""EBSD pattern simulation: detector geometry, reflector tables, the
kinematical renderer, autodiff orientation refinement and pattern-center
calibration, so that ``cli.index sample`` → ``simulate`` → ``build`` →
``query`` (or → ``di``) needs no external tooling. The master-pattern,
band-fitting, dynamical and Monte-Carlo modules of ``latice_tpu.sim`` wait
for a later slice."""

from latice_tpu_torch.sim.calibrate import (
    ScanCalibration,
    calibrate_geometry,
    calibrate_scan_geometry,
)
from latice_tpu_torch.sim.geometry import DetectorGeometry, pixel_directions
from latice_tpu_torch.sim.kinematical import (
    Reflectors,
    cubic_reflectors,
    electron_wavelength,
    hexagonal_reflectors,
    reflectors_from_cell,
    simulate_patterns,
)
from latice_tpu_torch.sim.refine import refine_candidates, refine_orientations

__all__ = [
    "DetectorGeometry",
    "Reflectors",
    "ScanCalibration",
    "calibrate_geometry",
    "calibrate_scan_geometry",
    "cubic_reflectors",
    "electron_wavelength",
    "hexagonal_reflectors",
    "pixel_directions",
    "reflectors_from_cell",
    "refine_candidates",
    "refine_orientations",
    "simulate_patterns",
]
