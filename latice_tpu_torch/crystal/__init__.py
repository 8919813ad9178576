"""Orientation algebra and crystal symmetry in torch, and orientation
sampling over a fundamental zone and elastic constants (host numpy)."""

from latice_tpu_torch.crystal.elastic import (
    CUBIC_STIFFNESS,
    PolycrystalModuli,
    cubic_stiffness,
    directional_youngs_modulus,
    polycrystal_moduli,
)
from latice_tpu_torch.crystal.quaternion import (
    from_euler_zxz_deg,
    matrix_to_euler_zxz_deg,
    misorientation_angle,
    misorientation_deg,
    quat_angle,
    quat_canonical,
    quat_inv,
    quat_mean,
    quat_mul,
    quat_normalize,
    quat_to_matrix,
    to_euler_zxz_deg,
)
from latice_tpu_torch.crystal.sampling import (
    euler_grid,
    reduce_to_fundamental_zone,
    sample_fundamental_zone,
    write_anglefile,
)
from latice_tpu_torch.crystal.symmetry import (
    CUBIC_SYMMETRY,
    QUAT_SYM_WXYZ,
    ROTATION_GROUPS,
    nearest_symmetry_equivalent,
    stack_symmetry_tables,
    symmetry_quats,
    symmetry_reduced_misorientation,
)

__all__ = [
    "CUBIC_STIFFNESS",
    "CUBIC_SYMMETRY",
    "PolycrystalModuli",
    "QUAT_SYM_WXYZ",
    "ROTATION_GROUPS",
    "cubic_stiffness",
    "directional_youngs_modulus",
    "euler_grid",
    "from_euler_zxz_deg",
    "matrix_to_euler_zxz_deg",
    "misorientation_angle",
    "misorientation_deg",
    "nearest_symmetry_equivalent",
    "polycrystal_moduli",
    "quat_angle",
    "quat_canonical",
    "quat_inv",
    "quat_mean",
    "quat_mul",
    "quat_normalize",
    "quat_to_matrix",
    "reduce_to_fundamental_zone",
    "sample_fundamental_zone",
    "stack_symmetry_tables",
    "symmetry_quats",
    "symmetry_reduced_misorientation",
    "to_euler_zxz_deg",
    "write_anglefile",
]
