"""Visualization utilities: reconstruction grids, latent scatter, IPF colors
(host numpy and matplotlib; the port's own copy of
``latice_tpu/utils/viz.py``).

Images are NHWC numpy arrays, figures go to the port's loggers
(`utils.loggers`' ``log_image``), and the latent scatter renders with
altair when it is importable, else with matplotlib. Matplotlib is imported
only when a figure is drawn; `get_color_key` needs only scipy.
"""

from __future__ import annotations

import random
from typing import Any

import numpy as np
from numpy.typing import NDArray

from latice_tpu_torch.utils.colorkey import ColorKeyGenerator

__all__ = [
    "plot_detection",
    "figure_to_array",
    "log_fig",
    "plot_latent",
    "get_color_key",
]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def plot_detection(
    imgs: NDArray,
    recon_imgs: NDArray,
    cmap: str = "viridis",
    num_samples: int = 4,
    figsize: tuple[int, int] = (10, 5),
    dpi: int = 150,
):
    """2 x N grid of originals (top) vs sigmoid(reconstruction logits) (bottom).

    Matches utils.py:77-116 including the sigmoid applied at plot time
    (utils.py:99 — the model emits logits).
    """
    from latice_tpu_torch.utils._mpl import ensure_headless_backend

    ensure_headless_backend()
    import matplotlib.pyplot as plt

    imgs = np.asarray(imgs)
    recon = _sigmoid(np.asarray(recon_imgs, dtype=np.float32))
    num_samples = min(num_samples, len(imgs))
    img_ids = random.sample(range(len(imgs)), num_samples)

    fig, axs = plt.subplots(2, num_samples, figsize=figsize, dpi=dpi, squeeze=False)
    for i in range(2):
        for j in range(num_samples):
            img = (imgs if i == 0 else recon)[img_ids[j]].squeeze()
            axs[i, j].imshow(img, cmap=cmap)
            axs[i, j].axis("off")
    fig.subplots_adjust(wspace=0.0, hspace=0.05)
    return fig


def figure_to_array(fig) -> np.ndarray:
    """Rasterize a matplotlib figure to an RGBA uint8 array (utils.py:136-139)."""
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    arr = np.asarray(fig.canvas.renderer.buffer_rgba()).copy()
    plt.close(fig)
    return arr


def log_fig(log_name: str, fig, logger: Any, current_epoch: int) -> None:
    """Rasterize + dispatch a figure to a latice_tpu logger (utils.py:119-148)."""
    if logger is None:
        return
    logger.log_image(log_name, figure_to_array(fig), current_epoch)


def get_color_key(
    rot_angle: NDArray,
    mode: str = "ipf_z",
    hex_string: bool = False,
    group: str = "432",
) -> NDArray | list[str]:
    """IPF color keys for zxz-Euler rotation angles (utils.py:206-240).

    Args:
        rot_angle: ``(N, 3)`` or ``(3,)`` Euler angles, degrees.
        mode: 'ipf_x' | 'ipf_y' | 'ipf_z' — which rotation-matrix row is the
            projection pole.
        hex_string: Return '#rrggbb' strings instead of an int array.
        group: Crystal point group for the IPF sector (default cubic, the
            reference's only mode; other groups serve multi-phase maps).
    """
    from scipy.spatial.transform import Rotation as R

    rot_angle = np.asarray(rot_angle)
    if rot_angle.ndim < 2:
        rot_angle = rot_angle[np.newaxis, :]
    pole = R.from_euler("zxz", rot_angle, degrees=True).as_matrix()
    row = {"ipf_x": 0, "ipf_y": 1, "ipf_z": 2}[mode]
    pole = pole[:, row, :]

    colors = ColorKeyGenerator(group).generate_ipf_colors(pole)
    if not hex_string:
        return colors
    return ["#{:02x}{:02x}{:02x}".format(*rgb) for rgb in colors]


def plot_latent(dataset: Any, latent: np.ndarray, color: str = "ipf_z"):
    """2-D latent scatter colored by IPF key (utils.py:151-203).

    Uses altair when available (the reference's renderer); otherwise returns
    an equivalent matplotlib figure.
    """
    angles = np.asarray(dataset.rot_angles)
    colors = (
        get_color_key(angles, mode=color, hex_string=True)
        if color in ("ipf_x", "ipf_y", "ipf_z")
        else None
    )
    try:
        import altair as alt
        import pandas as pd

        source = pd.DataFrame(angles, columns=["z1", "x", "z2"])
        if colors is not None:
            source["color"] = colors
        source["latent_x"] = latent[:, 0]
        source["latent_y"] = latent[:, 1]
        alt.data_transformers.disable_max_rows()
        return (
            alt.Chart(source)
            .mark_circle(size=20.0, color="red")
            .encode(
                x="latent_x:Q",
                y="latent_y:Q",
                color=alt.Color("color", scale=None),
                tooltip=[
                    alt.Tooltip("latent_x:Q", format=",.2f"),
                    alt.Tooltip("latent_y:Q", format=",.2f"),
                    alt.Tooltip("z1:Q", format=",.2f"),
                    alt.Tooltip("x:Q", format=",.2f"),
                    alt.Tooltip("z2:Q", format=",.2f"),
                ],
            )
            .properties(width=450, height=450, title="Latent space")
            .interactive()
        )
    except ImportError:
        from latice_tpu_torch.utils._mpl import ensure_headless_backend

        ensure_headless_backend()
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(latent[:, 0], latent[:, 1], s=8, c=colors or "red")
        ax.set_xlabel("latent_x")
        ax.set_ylabel("latent_y")
        ax.set_title("Latent space")
        return fig
