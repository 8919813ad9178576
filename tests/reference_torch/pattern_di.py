"""Pattern dictionary indexing (DI) in plain PyTorch: normalized
cross-correlation features and the exact cosine search, float32 with TF32
off, at the precision a DI configuration states.

Written from the method of EMsoft's EMDI (Chen et al., Microsc. Microanal.
21 (2015) 739; the tutorial of Jackson, Pascal and De Graef, IMMI 8
(2019)) and kikuchipy's ``dictionary_indexing``, not from the program:

* features: each pattern (uint8 counts taken as ``/255``, which NCC does
  not see) is mean-pooled by ``bin_factor``, flattened, its mean removed
  and divided by its L2 norm (floored at 1e-12), so that the dot product
  of two rows is their NCC;
* search: every query row against every dictionary row; with
  ``search_dtype="bfloat16"`` the query (normalized again, a zero row
  staying zero) and the table are rounded to bfloat16, and the products
  and sums are in float32; the ``k`` best, best first, the lower row first
  among equal scores;
* consensus over the ``k`` candidates: ``port_bench/reference/consensus.py``.

Departures from EMsoft's EMDI in the DI cells:

* the dictionary's patterns come from a kinematical-like band model
  (``port_bench/gen.py``, rendered noise-free by ``port_bench/gen_di.py``), not from
  dynamical master patterns projected onto the detector;
* its orientations are a uniform random draw reduced to the fundamental
  zone, not the cubochoric grid (N = 100 gives 333,227 orientations in the
  432 zone);
* no pattern processing before NCC (EMDI's optional mask, high-pass
  filter and adaptive histogram equalization);
* EMDI keeps the top matches and averages the best few; here the
  program's symmetry consensus over the top ``k`` is held to
  ``port_bench/reference/consensus.py``.

It imports neither JAX nor anything of ``latice_tpu`` or
``latice_tpu_torch``. This is the tests' copy; the benchmark keeps a frozen
one, ``port_bench/reference/ncc.py``.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["bf16", "features", "full_f32", "normalize", "scores", "topk"]


@contextlib.contextmanager
def full_f32():
    """cuDNN and cuBLAS in full float32 inside the block (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back to float32."""
    return x.to(torch.bfloat16).float()


def features(patterns: torch.Tensor, bin_factor: int = 1) -> torch.Tensor:
    """``(n, D)`` float32 NCC rows of ``(n, H, W)`` patterns."""
    x = patterns.float()
    if not torch.is_floating_point(patterns):
        x = x / 255.0
    if bin_factor > 1:
        n, h, w = x.shape
        x = x.reshape(n, h // bin_factor, bin_factor, w // bin_factor, bin_factor).mean(dim=(2, 4))
    v = x.reshape(len(x), -1)
    v = v - v.mean(dim=1, keepdim=True)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm, a zero row staying zero."""
    x = x.float()
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norm == 0, torch.ones_like(norm), norm)


def scores(queries: torch.Tensor, table: torch.Tensor, search_dtype: str = "bfloat16",
           rows: int = 256) -> torch.Tensor:
    """``(B, N)`` float32 scores of ``queries`` (any scale) against the
    unit ``table`` rows, in blocks of ``rows`` queries; with
    ``search_dtype="bfloat16"`` both operands are rounded to bfloat16."""
    cast = bf16 if search_dtype == "bfloat16" else (lambda x: x.float())
    t = cast(table)
    out = []
    with full_f32():
        for i in range(0, len(queries), rows):
            out.append(cast(normalize(queries[i : i + rows])) @ t.T)
    return torch.cat(out)


def topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of ``(B, N)`` scores, best first, the lower column
    first among equal ones: ``(values, columns)``."""
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]
