"""Utilities of the port: experiment loggers, the IPF color key, pole
figures and figures (host numpy; matplotlib only where a figure is drawn),
device selection, phase timers and ``torch.profiler`` traces."""

from latice_tpu_torch.utils.colorkey import ColorKeyGenerator
from latice_tpu_torch.utils.device import get_device, get_platform
from latice_tpu_torch.utils.loggers import (
    CSVLogger,
    MultiLogger,
    TensorBoardLogger,
    WandbLogger,
    make_default_logger,
)
from latice_tpu_torch.utils.polefigure import compute_pole_figure, plot_odf_sections, plot_pole_figure
from latice_tpu_torch.utils.profiling import PhaseTimer, device_sync, trace
from latice_tpu_torch.utils.torch_trace import (
    TraceSummary,
    format_summary,
    summarize_trace,
)
from latice_tpu_torch.utils.viz import (
    figure_to_array,
    get_color_key,
    log_fig,
    plot_detection,
    plot_latent,
)

__all__ = [
    "compute_pole_figure",
    "plot_odf_sections",
    "plot_pole_figure",
    "CSVLogger",
    "ColorKeyGenerator",
    "MultiLogger",
    "PhaseTimer",
    "TensorBoardLogger",
    "WandbLogger",
    "device_sync",
    "figure_to_array",
    "get_device",
    "get_platform",
    "get_color_key",
    "log_fig",
    "make_default_logger",
    "plot_detection",
    "plot_latent",
    "trace",
    "TraceSummary",
    "format_summary",
    "summarize_trace",
]
