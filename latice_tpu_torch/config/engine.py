"""Minimal Hydra-compatible config engine: the port of
``latice_tpu.config.engine``, reading the same ``conf/`` tree.

The reference drives training through Hydra 1.3 (train.py:102: composed
defaults, `${...}` interpolation, `_target_`/`_partial_` instantiation, CLI
`key=value` overrides and `--multirun` sweeps, README.md:54-67). This module
implements the subset the reference uses:

* ``defaults:`` list composing group files (``conf/<group>/<name>.yaml``),
  with ``_self_`` ordering and CLI ``group=name`` selection;
* ``${a.b.c}`` interpolation plus ``${hydra:runtime.cwd}``;
* recursive ``_target_`` instantiation with ``_partial_`` support
  (the reference's `maybe_instantiate`, train.py:20-43);
* comma-separated sweep expansion for multirun (cartesian product).

The ``_target_``s in ``conf/`` name the JAX package's classes
(``latice_tpu.train.trainer.Trainer``, ...). `instantiate` maps the prefix
``latice_tpu.`` to ``latice_tpu_torch.`` and raises on a target the port
does not have; it never imports the JAX package.
"""

from __future__ import annotations

import functools
import importlib
import itertools
import re
from pathlib import Path
from typing import Any, Mapping

import yaml

__all__ = [
    "load_config",
    "apply_overrides",
    "resolve_interpolations",
    "instantiate",
    "maybe_instantiate",
    "expand_sweeps",
    "get_by_path",
    "port_target",
    "set_by_path",
]

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with YAML-1.2-style float parsing (``5e-6`` is a float;
    stock pyyaml requires ``5.0e-6``). Matches Hydra/OmegaConf behavior."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str):
    return yaml.load(text, Loader=_YamlLoader)


def _deep_merge(base: dict, extra: Mapping) -> dict:
    """Right-biased recursive dict merge."""
    out = dict(base)
    for key, value in extra.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, Mapping):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def get_by_path(cfg: Mapping, dotted: str) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def set_by_path(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _parse_scalar(text: str) -> Any:
    """Parse an override value with YAML typing rules."""
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Apply ``key.path=value`` overrides in place (Hydra CLI semantics)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must have the form key=value")
        key, _, value = ov.partition("=")
        set_by_path(cfg, key.strip(), _parse_scalar(value.strip()))
    return cfg


def resolve_interpolations(cfg: dict, runtime_cwd: str | None = None) -> dict:
    """Resolve ``${a.b}`` / ``${hydra:runtime.cwd}`` strings, recursively.

    Chained interpolations resolve through repeated passes; unresolvable keys
    raise KeyError naming the reference.
    """
    cwd = runtime_cwd if runtime_cwd is not None else str(Path.cwd())

    def resolve_value(value: Any, depth: int = 0) -> Any:
        if not isinstance(value, str) or "${" not in value:
            return value
        if depth > 10:
            raise ValueError(f"Interpolation loop while resolving {value!r}")

        full = _INTERP_RE.fullmatch(value.strip())
        if full:
            return resolve_value(_lookup(full.group(1)), depth + 1)

        def sub(match: re.Match) -> str:
            resolved = resolve_value(_lookup(match.group(1)), depth + 1)
            return str(resolved)

        return _INTERP_RE.sub(sub, value)

    def _lookup(expr: str) -> Any:
        expr = expr.strip()
        if expr in ("hydra:runtime.cwd", "runtime:cwd"):
            return cwd
        try:
            return get_by_path(cfg, expr)
        except (KeyError, TypeError) as e:
            raise KeyError(f"Cannot resolve interpolation ${{{expr}}}") from e

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve_value(node)

    # Iterate to fixpoint so ${a} -> ${b} chains resolve regardless of order.
    for _ in range(5):
        new = walk(cfg)
        if new == cfg:
            return new
        cfg = new
    return cfg


def load_config(
    config_path: str | Path,
    config_name: str = "train.yaml",
    overrides: list[str] | None = None,
    runtime_cwd: str | None = None,
) -> dict:
    """Compose a config like ``@hydra.main(config_path, config_name)`` would.

    Group-selection overrides (``trainer=fast``) swap which group file loads;
    value overrides (``trainer.max_epochs=5``) are applied after composition;
    interpolations resolve last.
    """
    config_path = Path(config_path)
    overrides = list(overrides or [])
    root = _yaml_load((config_path / config_name).read_text()) or {}

    defaults = root.pop("defaults", [])
    # CLI group selections override the defaults list.
    group_choice: dict[str, str] = {}
    value_overrides: list[str] = []
    for ov in overrides:
        key, _, value = ov.partition("=")
        key = key.strip()
        if (
            "." not in key
            and (config_path / key).is_dir()
            and isinstance(value, str)
        ):
            group_choice[key] = value.strip()
        else:
            value_overrides.append(ov)

    cfg: dict = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            cfg = _deep_merge(cfg, root)
            self_done = True
            continue
        if isinstance(entry, str):
            group, name = entry, None
        else:
            ((group, name),) = entry.items()
        name = group_choice.get(group, name)
        if name is None:
            raise ValueError(f"defaults entry {group!r} has no config name")
        if not str(name).endswith(".yaml"):
            name = f"{name}.yaml"
        group_cfg = _yaml_load((config_path / group / name).read_text()) or {}
        cfg = _deep_merge(cfg, {group: group_cfg})
    if not self_done:
        cfg = _deep_merge(cfg, root)

    apply_overrides(cfg, value_overrides)
    return resolve_interpolations(cfg, runtime_cwd)


_JAX_PACKAGE = "latice_tpu."
_PORT_PACKAGE = "latice_tpu_torch."


def port_target(target: str) -> str:
    """The port's dotted path for a ``_target_``: ``latice_tpu.x.y`` names
    ``latice_tpu_torch.x.y``; any other path is kept."""
    if target.startswith(_JAX_PACKAGE):
        return _PORT_PACKAGE + target[len(_JAX_PACKAGE):]
    return target


def _import_target(target: str) -> Any:
    ported = port_target(target)
    module_name, _, attr = ported.rpartition(".")
    if not module_name:
        raise ImportError(f"_target_ {target!r} must be a dotted path")
    try:
        return getattr(importlib.import_module(module_name), attr)
    except (ImportError, AttributeError) as e:
        raise ImportError(
            f"_target_ {target!r}: the port has no {ported!r} yet"
        ) from e


def instantiate(config: Mapping, **kwargs: Any) -> Any:
    """Recursively instantiate a ``_target_`` config node (hydra.utils
    equivalent used by train.py:20-43)."""
    if not isinstance(config, Mapping) or "_target_" not in config:
        raise ValueError("instantiate() requires a mapping with _target_")
    target = _import_target(config["_target_"])
    partial = bool(config.get("_partial_", False))

    call_kwargs: dict[str, Any] = {}
    for key, value in config.items():
        if key in ("_target_", "_partial_"):
            continue
        call_kwargs[key] = _instantiate_node(value)
    call_kwargs.update(kwargs)

    if partial:
        return functools.partial(target, **call_kwargs)
    return target(**call_kwargs)


def _instantiate_node(value: Any) -> Any:
    if isinstance(value, Mapping) and "_target_" in value:
        return instantiate(value)
    if isinstance(value, list):
        return [_instantiate_node(v) for v in value]
    return value


def maybe_instantiate(
    instance_or_config: Any, expected_type: type | None = None, **kwargs: Any
) -> Any:
    """Instantiate configs-with-_target_; pass anything else through
    (reference train.py:20-43)."""
    if isinstance(instance_or_config, Mapping) and "_target_" in instance_or_config:
        instance = instantiate(instance_or_config, **kwargs)
    else:
        instance = instance_or_config
    assert expected_type is None or isinstance(instance, expected_type), (
        f"Expected {expected_type}, got {type(instance)}"
    )
    return instance


def expand_sweeps(overrides: list[str]) -> list[list[str]]:
    """Expand comma-separated override values into a cartesian sweep
    (Hydra --multirun semantics, README.md:60-67)."""
    axes: list[list[str]] = []
    for ov in overrides:
        key, _, value = ov.partition("=")
        values = [v.strip() for v in value.split(",")] if "," in value else [value]
        axes.append([f"{key}={v}" for v in values])
    return [list(combo) for combo in itertools.product(*axes)]
