"""Prefetch: overlap host-to-device copies and host production with compute.

The port of ``latice_tpu.data.prefetch``. `prefetch_to_device` keeps a few
batches in flight: each is staged in pinned host memory and copied on a
side CUDA stream, and the compute stream waits on that copy's event before
it reads the batch. `prefetch_host` runs a producer in a thread.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from latice_tpu_torch.utils.profiling import span

__all__ = ["prefetch_host", "prefetch_to_device"]


def _map(fn, batch: Any) -> Any:
    """Apply ``fn`` to every array leaf of a tuple/list/dict batch."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _leaves(batch: Any) -> list:
    if isinstance(batch, dict):
        return [leaf for v in batch.values() for leaf in _leaves(v)]
    if isinstance(batch, (tuple, list)):
        return [leaf for v in batch for leaf in _leaves(v)]
    return [batch]


def _as_tensor(a: Any) -> torch.Tensor:
    """A host leaf as a tensor: tensors (bf16 among them, which numpy
    lacks) as they are, anything else through numpy."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a))


def prefetch_to_device(
    iterator: Iterable[Any], size: int = 2, device: str | torch.device = "cuda"
) -> Iterator[Any]:
    """Yield batches with every numpy or CPU-tensor leaf as a tensor on
    ``device``, keeping ``size`` copies in flight.

    On a CUDA device each leaf goes through a pinned host buffer (a leaf
    already in pinned memory is copied from directly) and a
    non-blocking copy on a side stream; before a batch is yielded, the
    current stream waits on its copy's event, and each tensor is recorded
    on the current stream so the allocator keeps its memory until the
    compute that reads it is done. On the CPU the leaves are wrapped as
    they are.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    it = iter(iterator)

    if device.type != "cuda":
        for batch in it:
            yield _map(lambda a: _as_tensor(a).to(device), batch)
        return

    side = torch.cuda.Stream(device=device)
    pending: collections.deque = collections.deque()

    def transfer(batch: Any):
        def copy(a):
            host = _as_tensor(a)
            if not host.is_pinned():
                host = host.contiguous().pin_memory()
            return host.to(device, non_blocking=True)

        with torch.cuda.stream(side):
            out = _map(copy, batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    for batch in it:
        pending.append(transfer(batch))
        if len(pending) >= size:
            break
    while pending:
        out, done = pending.popleft()
        for batch in it:
            pending.append(transfer(batch))
            break
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in _leaves(out):
            t.record_stream(current)
        yield out


def prefetch_host(iterable: Iterable[Any], size: int = 2) -> Iterator[Any]:
    """Run ``iterable`` in a background thread, keeping up to ``size`` items
    ready ahead of the consumer.

    Order is preserved; producer exceptions re-raise at the consumption
    point; abandoning the iterator (break, GC or ``close()``) stops the
    thread, and ``close()`` also joins it, so once it returns no thread is
    still reading the underlying iterable.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = threading.Event()
    _END = object()

    def _put(item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _worker() -> None:
        try:
            it = iter(iterable)
            while True:
                with span("prefetch:produce"):
                    item = next(it, _END)
                if item is _END:
                    break
                if not _put(("item", item)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            _put(("error", e))
            return
        _put((_END, None))

    thread = threading.Thread(target=_worker, name="latice-prefetch-host", daemon=True)
    thread.start()
    try:
        while True:
            with span("prefetch:wait"):
                kind, payload = q.get()
            if kind is _END:
                return
            if kind == "error":
                raise payload
            yield payload
    finally:
        stop.set()
        # Unblock a worker mid-put, then wait for it to leave the iterable.
        while True:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        thread.join(timeout=30.0)
