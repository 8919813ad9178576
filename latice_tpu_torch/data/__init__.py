"""Host-side pattern preparation, the HDF5 and EDAX UP scan readers,
device-side preprocessing, NLPAR denoising, Hough/Radon band detection, the
training data modules (in memory and streamed), the training augmentation,
prefetch and result export."""

from latice_tpu_torch.data.augment import AugmentConfig, make_augment_fn
from latice_tpu_torch.data.datamodule import (
    DPDataModule,
    batch_iterator,
    pad_batch,
    padded_batches,
)
from latice_tpu_torch.data.dataset import DPdataset, parse_angle_file
from latice_tpu_torch.data.export import VendorMap, read_ang, read_ctf, write_ang, write_ctf
from latice_tpu_torch.data.h5io import (
    HDF5_EXTENSIONS,
    find_pattern_dataset,
    iter_pattern_batches,
    load_patterns,
)
from latice_tpu_torch.data.hough import BandDetection, BandDetector, butterfly_kernel, radon_matrix
from latice_tpu_torch.data.nlpar import estimate_noise_sigma, nlpar_denoise
from latice_tpu_torch.data.prefetch import prefetch_host, prefetch_to_device
from latice_tpu_torch.data.preprocess import (
    PreprocessConfig,
    bin_patterns,
    equalize_histogram,
    estimate_static_background,
    fix_hot_pixels,
    gaussian_blur,
    make_preprocess_fn,
    normalize_patterns,
    parse_preprocess_spec,
    remove_dynamic_background,
    remove_static_background,
)
from latice_tpu_torch.data.streaming import StreamedDPDataModule
from latice_tpu_torch.data.up import (
    UP_EXTENSIONS,
    UpHeader,
    iter_up_batches,
    load_up_patterns,
    open_up_patterns,
    read_up_header,
)
from latice_tpu_torch.data.transforms import (
    center_crop,
    create_default_transform,
    default_transform,
    prepare_patterns,
    to_grayscale,
)

__all__ = [
    "HDF5_EXTENSIONS",
    "UP_EXTENSIONS",
    "AugmentConfig",
    "BandDetection",
    "BandDetector",
    "DPDataModule",
    "DPdataset",
    "PreprocessConfig",
    "StreamedDPDataModule",
    "UpHeader",
    "VendorMap",
    "batch_iterator",
    "bin_patterns",
    "butterfly_kernel",
    "center_crop",
    "create_default_transform",
    "default_transform",
    "equalize_histogram",
    "estimate_noise_sigma",
    "estimate_static_background",
    "find_pattern_dataset",
    "fix_hot_pixels",
    "gaussian_blur",
    "iter_pattern_batches",
    "iter_up_batches",
    "load_patterns",
    "load_up_patterns",
    "make_augment_fn",
    "make_preprocess_fn",
    "nlpar_denoise",
    "open_up_patterns",
    "normalize_patterns",
    "pad_batch",
    "padded_batches",
    "parse_angle_file",
    "parse_preprocess_spec",
    "prefetch_host",
    "prefetch_to_device",
    "prepare_patterns",
    "radon_matrix",
    "read_ang",
    "read_ctf",
    "read_up_header",
    "remove_dynamic_background",
    "remove_static_background",
    "to_grayscale",
    "write_ang",
    "write_ctf",
]
