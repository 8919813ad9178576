"""Host-side pattern preparation, the training data module, prefetch and
result export."""

from latice_tpu_torch.data.datamodule import (
    DPDataModule,
    batch_iterator,
    pad_batch,
    padded_batches,
)
from latice_tpu_torch.data.dataset import DPdataset, parse_angle_file
from latice_tpu_torch.data.export import VendorMap, read_ang, read_ctf, write_ang, write_ctf
from latice_tpu_torch.data.prefetch import prefetch_host, prefetch_to_device
from latice_tpu_torch.data.transforms import (
    center_crop,
    default_transform,
    prepare_patterns,
    to_grayscale,
)

__all__ = [
    "DPDataModule",
    "DPdataset",
    "VendorMap",
    "batch_iterator",
    "center_crop",
    "default_transform",
    "pad_batch",
    "padded_batches",
    "parse_angle_file",
    "prefetch_host",
    "prefetch_to_device",
    "prepare_patterns",
    "read_ang",
    "read_ctf",
    "to_grayscale",
    "write_ang",
    "write_ctf",
]
