"""Interpretation figures (counterpart of `stratanet2_tpu/utils/visualize.py`,
reference utils/visualize_predictions.py).

Per-plot 6-panel PNG: NIR-false-color cloud, the three stratum coverage
rasters with pred-vs-GT titles, pointwise class-RGB cloud, and the
most-likely-stratum score cloud (visualize_predictions.py:77-241). Rasters
come from the port's projection (`ops.projection.raster_projection`, the
pixel-max kernel on the card). Optionally also writes the per-plot GeoTIFF
(:60-72). matplotlib is imported inside the function, first, so a machine
without it draws nothing and launches nothing.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.ops.projection import raster_projection

logger = logging.getLogger("stratanet2_tpu_torch")

# class -> RGB (visualize_predictions.py:146): low=green, soil=brown,
# med=blue, high=red
COLOR_MATRIX = np.array(
    [[0, 1, 0], [0.8, 0.4, 0.1], [0, 0, 1], [1, 0, 0]], dtype=np.float64
)


def create_predictions_interpretations(
    pred_pl: np.ndarray,
    gt: np.ndarray,
    coverages_pointwise: np.ndarray,  # (N, 4)
    cloud: np.ndarray,  # (N, 10) rescaled
    p_all: np.ndarray,  # (N, 3)
    pdf_all: np.ndarray,  # (N, 3)
    plot_name: str,
    plot_center: np.ndarray,
    cfg: Config,
    stats_path: str,
    fold_id: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Draws the figure into `stats_path`/img/plots/ and returns its path;
    the rasters are computed on `device` (default CUDA)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import colors

    mcfg = cfg.model
    dev = resolve_device(device)
    rasters = raster_projection(
        torch.as_tensor(cloud[:, :2], device=dev).float(),
        torch.as_tensor(coverages_pointwise, device=dev).float(),
        mcfg.diam_pix,
        mcfg.diam_meters,
    ).cpu().numpy()
    img_low, img_med, img_high = rasters

    text = (
        f"LOW, MID, HIGH \nCoverage: Pred {np.round(pred_pl[[0, 2, 3]], 2)} "
        f"GT {np.round(gt[[0, 2, 3]], 2)}"
    )
    logger.info("%s %s", plot_name, text.replace("\n", " "))

    x, y = cloud[:, 0], cloud[:, 1]
    z_m = cloud[:, 2] * mcfg.z_max

    fig = plt.figure(figsize=(20, 25))
    row, col = 3, 2

    ax1 = fig.add_subplot(row, col, 1, projection="3d")
    nir_r_g = np.clip(cloud[:, [6, 3, 4]], 0, 1)
    ax1.scatter(x, y, z_m, c=nir_r_g, s=10)
    ax1.set_title(plot_name)

    def _raster_panel(pos, img, grad, title):
        ax = fig.add_subplot(row, col, pos)
        cmap = colors.LinearSegmentedColormap.from_list("Custom", grad, N=100)
        im = ax.imshow(img, cmap=cmap, vmin=0, vmax=1)
        ax.set_title(title)
        ax.set_xticks([])
        ax.set_yticks([])
        plt.colorbar(im, ax=ax)

    _raster_panel(
        2, img_low,
        [(0.8, 0.4, 0.1), (0.91, 0.91, 0.91), (0, 1, 0)],
        f"Low veg. = {pred_pl[0]:.0%} (gt={gt[0]:.0%})",
    )

    ax3 = fig.add_subplot(row, col, 3, projection="3d")
    colors_pred = np.clip(coverages_pointwise, 0, 1) @ COLOR_MATRIX
    ax3.scatter(x, y, z_m, c=np.clip(colors_pred, 0, 1), s=10)
    ax3.set_title("Pointwise prediction")

    _raster_panel(
        4, img_med, [(1, 1, 1), (0, 0, 1)],
        f"Medium veg. = {pred_pl[2]:.0%} (gt={gt[2]:.0%})",
    )

    ax5 = fig.add_subplot(row, col, 5, projection="3d")
    # score of the most-likely stratum by prior pdf (visualize_predictions.py:189-207)
    best = pdf_all.argmax(axis=1)
    score = np.clip(p_all[np.arange(len(best)), best], 0, 1)
    ax5.scatter(x, y, z_m, c=score, s=10, vmin=0, vmax=1, cmap="copper")
    ax5.set_title("Score for most-likely strata")

    _raster_panel(
        6, img_high, [(1, 1, 1), (1, 0, 0)],
        f"High veg. = {pred_pl[3]:.0%} (gt={gt[3]:.0%})",
    )

    fig.text(0.5, 0.05, text, ha="center")

    task = "crossval" if fold_id >= 0 else "full"
    plot_dir = os.path.join(stats_path, "img", "plots", task)
    os.makedirs(plot_dir, exist_ok=True)
    save_path = os.path.join(plot_dir, f"{plot_name}.png")
    fig.savefig(save_path, format="png", bbox_inches="tight", dpi=100)
    plt.close(fig)

    if cfg.plot_geotiff_file:
        from stratanet2_tpu_torch.inference.geotiff import get_geotransform, write_geotiff

        write_geotiff(
            os.path.join(plot_dir, f"{plot_name}.tif"),
            rasters.astype(np.float32),
            get_geotransform(plot_center, mcfg.diam_meters, mcfg.diam_pix),
        )
    return save_path
