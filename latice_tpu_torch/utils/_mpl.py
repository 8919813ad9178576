"""Matplotlib backend selection that never clobbers a user's choice (the
port's own copy of ``latice_tpu/utils/_mpl.py``; matplotlib is imported
only when a figure is drawn)."""

from __future__ import annotations

import os
import sys

__all__ = ["ensure_headless_backend"]


def ensure_headless_backend() -> None:
    """Select the Agg backend only when nothing else has a claim on it.

    ``matplotlib.use("Agg")`` *switches* the active backend — calling it
    unconditionally from library code flips a user's interactive session
    (TkAgg / notebook) to a headless renderer and their ``plt.show()`` goes
    dark. Skip whenever pyplot is already imported, the user pinned
    ``$MPLBACKEND``, or a display is available.
    """
    if (
        "matplotlib.pyplot" in sys.modules
        or os.environ.get("MPLBACKEND")
        or os.environ.get("DISPLAY")
    ):
        return
    import matplotlib

    matplotlib.use("Agg")
