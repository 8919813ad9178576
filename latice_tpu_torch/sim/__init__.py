"""EBSD pattern simulation: detector geometry, reflector tables, the
kinematical renderer, master-pattern rendering and learning, the band fit
to a master, autodiff orientation refinement and pattern-center
calibration, so that ``cli.index sample`` → ``simulate [--master]`` →
``build`` → ``query`` (or → ``di``) needs no external tooling. The
spherical-harmonic tables live in `sim.sht`. The dynamical and Monte-Carlo
modules of ``latice_tpu.sim`` wait for a later slice."""

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
from latice_tpu_torch.sim.master import (
    directions_to_lambert,
    lambert_to_directions,
    make_kinematical_master,
    master_from_patterns,
    render_from_master,
    resample_square_lambert,
    square_lambert_to_directions,
)
from latice_tpu_torch.sim.master_fit import fit_reflectors_to_master, kinematical_master_ncc
from latice_tpu_torch.sim.refine import refine_candidates, refine_orientations

__all__ = [
    "DetectorGeometry",
    "Reflectors",
    "ScanCalibration",
    "calibrate_geometry",
    "calibrate_scan_geometry",
    "cubic_reflectors",
    "directions_to_lambert",
    "electron_wavelength",
    "fit_reflectors_to_master",
    "hexagonal_reflectors",
    "kinematical_master_ncc",
    "lambert_to_directions",
    "make_kinematical_master",
    "master_from_patterns",
    "pixel_directions",
    "reflectors_from_cell",
    "refine_candidates",
    "refine_orientations",
    "render_from_master",
    "resample_square_lambert",
    "simulate_patterns",
    "square_lambert_to_directions",
]
