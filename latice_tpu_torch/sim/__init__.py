"""EBSD pattern simulation: detector geometry, reflector tables, the
kinematical renderer, master-pattern rendering and learning, the band fit
to a master, autodiff orientation refinement and pattern-center
calibration, the dynamical (Bloch-wave) master and its Monte-Carlo
depth and energy weighting, so that ``cli.index sample`` → ``master`` →
``simulate [--master]`` → ``build`` → ``query`` (or → ``di``) needs no
external tooling. The spherical-harmonic tables live in `sim.sht`."""

from latice_tpu_torch.sim.calibrate import (
    ScanCalibration,
    calibrate_geometry,
    calibrate_scan_geometry,
)
from latice_tpu_torch.sim.dynamical import (
    AtomSite,
    CrystalStructure,
    channeling_intensities,
    cubic_structure,
    dynamical_beams,
    dynamical_master_pattern,
    hexagonal_structure,
    wurtzite_structure,
    zincblende_structure,
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
from latice_tpu_torch.sim.montecarlo import (
    MonteCarloBSE,
    effective_medium,
    mc_weighted_master_pattern,
    simulate_bse_monte_carlo,
)
from latice_tpu_torch.sim.refine import refine_candidates, refine_orientations

__all__ = [
    "AtomSite",
    "CrystalStructure",
    "DetectorGeometry",
    "MonteCarloBSE",
    "Reflectors",
    "ScanCalibration",
    "calibrate_geometry",
    "calibrate_scan_geometry",
    "channeling_intensities",
    "cubic_reflectors",
    "cubic_structure",
    "directions_to_lambert",
    "dynamical_beams",
    "dynamical_master_pattern",
    "effective_medium",
    "electron_wavelength",
    "fit_reflectors_to_master",
    "hexagonal_reflectors",
    "hexagonal_structure",
    "kinematical_master_ncc",
    "lambert_to_directions",
    "make_kinematical_master",
    "master_from_patterns",
    "mc_weighted_master_pattern",
    "pixel_directions",
    "refine_candidates",
    "refine_orientations",
    "reflectors_from_cell",
    "render_from_master",
    "resample_square_lambert",
    "simulate_bse_monte_carlo",
    "simulate_patterns",
    "square_lambert_to_directions",
    "wurtzite_structure",
    "zincblende_structure",
]
