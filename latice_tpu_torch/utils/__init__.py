"""Utilities of the port: experiment loggers."""

from latice_tpu_torch.utils.loggers import (
    CSVLogger,
    MultiLogger,
    TensorBoardLogger,
    WandbLogger,
    make_default_logger,
)

__all__ = ["CSVLogger", "MultiLogger", "TensorBoardLogger", "WandbLogger", "make_default_logger"]
