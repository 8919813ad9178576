"""Host-side pattern preparation and batching."""

from latice_tpu_torch.data.datamodule import padded_batches
from latice_tpu_torch.data.transforms import (
    center_crop,
    default_transform,
    prepare_patterns,
    to_grayscale,
)

__all__ = [
    "center_crop",
    "default_transform",
    "padded_batches",
    "prepare_patterns",
    "to_grayscale",
]
