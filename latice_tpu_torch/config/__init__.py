"""Hydra-compatible configuration engine of the port."""

from latice_tpu_torch.config.engine import (
    apply_overrides,
    expand_sweeps,
    get_by_path,
    instantiate,
    load_config,
    maybe_instantiate,
    port_target,
    resolve_interpolations,
    set_by_path,
)

__all__ = [
    "apply_overrides",
    "expand_sweeps",
    "get_by_path",
    "instantiate",
    "load_config",
    "maybe_instantiate",
    "port_target",
    "resolve_interpolations",
    "set_by_path",
]
