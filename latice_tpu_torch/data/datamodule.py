"""Fixed-shape batching of host pattern stacks."""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["padded_batches"]


def padded_batches(x: np.ndarray, batch_size: int) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(n_real, chunk)`` with every chunk ``batch_size`` rows long.

    The last chunk is zero-padded; the caller trims results back to
    ``n_real``.
    """
    for start in range(0, len(x), batch_size):
        chunk = x[start : start + batch_size]
        n = len(chunk)
        if n < batch_size:
            pad = np.zeros((batch_size - n,) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        yield n, chunk
