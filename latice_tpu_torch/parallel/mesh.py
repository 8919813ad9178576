"""Device meshes and data-parallel placement: the port of
``latice_tpu.parallel.mesh``.

The JAX package runs one process over a 1-D ``jax.sharding.Mesh``: batches
shard over its ``data`` axis, parameters replicate, and XLA inserts the
collectives. Here a mesh is the same thing in one process: an ordered list
of torch devices. A batch splits into one row block per device, a model or
table is copied to every device, and what JAX gathers over the interconnect
is copied to the mesh's first device. No process group is involved, so
every entry point keeps the JAX package's single-controller form.

A device may appear more than once: ``make_mesh(devices=["cuda:0"] * 4)``
runs every sharded path as four shards on one card, as the JAX tests run
theirs on virtual CPU devices. It is asked for explicitly and never
substituted for missing cards.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from latice_tpu_torch.device import resolve_device

__all__ = [
    "Mesh",
    "check_mesh_device",
    "chunk_device",
    "data_parallel_sharding",
    "dp_dispatch_plan",
    "gather_rows",
    "make_mesh",
    "map_blocks",
    "replicate",
    "replicate_state",
    "shard_batch",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices`` in order, one axis named ``data``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self) -> None:
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_canonical(torch.device(d)) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def dp_dispatch_plan(
    n_items: int, batch_size: int, n_devices: int
) -> dict[str, int]:
    """Static per-device dispatch math for a data-parallel pass.

    This is the arithmetic every DP path in the package follows (Trainer
    epochs, `DiffractionPatternIndexer` mesh builds, `IndexPipeline`
    chunking): items are cut into ``ceil(n/b)`` fixed-shape batches, the
    tail batch is padded up to the static shape, and each batch splits
    evenly over the mesh.

    Returns a dict with:
        n_batches: dispatches per pass.
        rows_per_device: rows each device computes per dispatch.
        tail_pad: zero rows appended to the last batch.
        padded_items: total rows actually computed (n_items + tail_pad).
        parallel_efficiency_ppm: useful/computed rows, in parts-per-million
            (1e6 = no padding waste).
    """
    if batch_size % n_devices:
        raise ValueError(
            f"batch_size {batch_size} must divide by mesh size {n_devices}"
        )
    if n_items <= 0:
        raise ValueError("n_items must be positive")
    n_batches = -(-n_items // batch_size)
    padded = n_batches * batch_size
    return {
        "n_batches": n_batches,
        "rows_per_device": batch_size // n_devices,
        "tail_pad": padded - n_items,
        "padded_items": padded,
        "parallel_efficiency_ppm": int(round(1e6 * n_items / padded)),
    }


def make_mesh(
    n_devices: int | None = None, axis_name: str = "data", devices: Any = None
) -> Mesh:
    """1-D mesh over (the first) ``n_devices`` devices: the attached CUDA
    cards unless ``devices`` lists them (repeats allowed)."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devs)} available"
            )
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("Requested a mesh but no device is available")
    return Mesh(tuple(devs), axis_names=(axis_name,))


def check_mesh_device(mesh: Mesh, device) -> torch.device:
    """The device an entry point with ``mesh=`` runs its host-facing work
    on: the mesh's first device. ``device`` may name it or be None; any
    other device raises, and so does a ``mesh`` that is not a `Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a latice_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh).__name__}"
        )
    first = mesh.devices[0]
    if first.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {str(first)!r} requested but CUDA is not available")
    if device is not None and _canonical(torch.device(device)) != _canonical(first):
        raise ValueError(f"device={device} is not the mesh's first device {first}")
    return first


def chunk_device(mesh: Mesh | None, device, chunk: int | None = None) -> torch.device:
    """The device of an entry point that takes ``mesh=`` and ``device=``:
    ``resolve_device(device)`` without a mesh, else the mesh's first device
    (`check_mesh_device`), ``chunk`` (when given) dividing by its size."""
    if mesh is None:
        return resolve_device(device)
    first = check_mesh_device(mesh, device)
    if chunk is not None and chunk % mesh.size:
        raise ValueError(f"chunk={chunk} must divide by the mesh's {mesh.size} devices")
    return first


def map_blocks(fn: Callable, arrays, tables, mesh: Mesh):
    """``fn(*row blocks, *tables)`` on every mesh device: each of
    ``arrays`` (host or device, leading axis divisible by the mesh size) is
    split by `shard_batch`, ``tables`` holds one tuple per device (from
    `replicate`), and the outputs (a tensor or a tuple of them) are
    gathered on the first device by `gather_rows`."""
    blocks = [shard_batch(a, mesh) for a in arrays]
    outs = [fn(*args, *tabs) for args, tabs in zip(zip(*blocks), tables)]
    if isinstance(outs[0], tuple):
        return tuple(gather_rows(parts, mesh) for parts in zip(*outs))
    return gather_rows(outs, mesh)


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``) where a card is
    attached; any other device as it is."""
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def data_parallel_sharding(mesh: Mesh) -> tuple[Callable, Callable]:
    """``(batch placer, replicator)`` for the mesh: `shard_batch` and
    `replicate` bound to it, the counterparts of JAX's pair of shardings."""
    return (lambda batch: shard_batch(batch, mesh)), (lambda tree: replicate(tree, mesh))


def shard_batch(batch, mesh: Mesh) -> list[torch.Tensor]:
    """The batch's leading axis split into one row block per device, each
    block on its device. A numpy batch is copied block by block from the
    host, so it never lands whole on one device.

    The batch size must divide by the mesh size (pad upstream otherwise).
    """
    n = mesh.size
    if batch.shape[0] % n != 0:
        raise ValueError(f"Batch size {batch.shape[0]} not divisible by mesh size {n}")
    rows = batch.shape[0] // n
    blocks = []
    for i, dev in enumerate(mesh.devices):
        block = batch[i * rows : (i + 1) * rows]
        if isinstance(block, np.ndarray):
            # A copy where the source is read-only (a memmap slab).
            block = torch.from_numpy(
                np.ascontiguousarray(block) if block.flags.writeable else np.array(block)
            )
            if dev.type == "cuda":
                block = block.pin_memory()
        blocks.append(block.to(dev, non_blocking=True))
    return blocks


def gather_rows(parts, mesh: Mesh) -> torch.Tensor:
    """Per-device row blocks concatenated on the mesh's first device: the
    ``all_gather`` of a batch-sharded result."""
    first = mesh.devices[0]
    return torch.cat([p.to(first, non_blocking=True) for p in parts])


def replicate(tree: Any, mesh: Mesh) -> list[Any]:
    """One copy of ``tree`` per device of the mesh: a tensor, an
    ``nn.Module`` (deep-copied), a numpy array (uploaded), or a dict, list
    or tuple of those. Every entry is its own copy, also where a device
    repeats; other leaves are shared."""
    return [_copy_to(tree, dev) for dev in mesh.devices]


def replicate_state(state: Any, mesh: Mesh) -> list[Any]:
    """Replicate a training state (a model, an optimizer's ``state_dict``,
    or a dict of them) across the mesh."""
    return replicate(state, mesh)


def _copy_to(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(dev)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(dev)
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_to(v, dev) for v in tree)
    return tree
