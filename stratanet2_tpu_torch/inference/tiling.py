"""Parcel tiling: divide arbitrary-shape parcels into overlapping 10 m-radius
plots (reference inference/prepare_utils.py:95-165); a copy of
`stratanet2_tpu/inference/tiling.py`.

Grid math mirrored exactly: step = inscribed-square width of the r=10 m disk
minus one output-pixel of overlap (:116-144, about 13.14 m for 20 px / 20 m
plots), start offset = step/4, centers kept when within the parcel shape
buffered by 20 m (LAS buffer) + 10 m (plot radius) (:146-151).

Per-plot extraction takes the native grid index's disk query when it is
built, else a scipy cKDTree disk query (the reference's exact mechanism,
prepare.py:76), imported only on that path.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Tuple

import numpy as np

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data import native
from stratanet2_tpu_torch.data.dataset import load_las_file
from stratanet2_tpu_torch.data.transforms import pre_transform
from stratanet2_tpu_torch.inference.polygons import Polygon, keep_points_in_shape

logger = logging.getLogger("stratanet2_tpu_torch")

PLOT_RADIUS_METERS = 10.0  # hardcoded in the reference (prepare_utils.py:116)
LAS_PARCEL_BUFFER = 20.0  # (:147)


def get_plot_centers(
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    parcel_shape: Polygon,
    diam_pix: int,
    diam_meters: int,
) -> List[np.ndarray]:
    """Square-grid plot centers covering the parcel (prepare_utils.py:116-151)."""
    square_w = 2 * math.cos(math.pi / 4) * PLOT_RADIUS_METERS
    overlap = 1 * (2 * PLOT_RADIUS_METERS) / diam_pix  # 1 pixel
    step = square_w - overlap

    x_min, x_max = x_range
    y_min, y_max = y_range
    nx = math.ceil((x_max - x_min) / step) + 1
    ny = math.ceil((y_max - y_min) / step) + 1
    start_x = x_min + step / 4
    start_y = y_min + step / 4

    # float64: absolute Lambert-93 coordinates (float32 has 0.5 m spacing
    # at y ~ 6.5e6, which would shift disk extractions and geotransforms)
    centers = [np.array([start_x, start_y], np.float64)]
    for ix in range(nx):
        for iy in range(ny):
            centers.append(
                np.array([start_x + ix * step, start_y + iy * step], np.float64)
            )
    pts = np.stack(centers)
    keep = keep_points_in_shape(
        pts, parcel_shape, LAS_PARCEL_BUFFER + diam_meters // 2
    )
    return [c for c, k in zip(centers, keep) if k]


def divide_parcel_las_and_get_disk_centers(
    cfg: Config, las_filename: str, parcel_shape: Polygon
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Load the parcel cloud and compute tiling centers
    (prepare_utils.py:95-165). Returns (centers, parcel_cloud (10, N))."""
    parcel_cloud = load_las_file(las_filename)
    x_min, x_max = float(parcel_cloud[0].min()), float(parcel_cloud[0].max())
    y_min, y_max = float(parcel_cloud[1].min()), float(parcel_cloud[1].max())
    centers = get_plot_centers(
        (x_min, x_max), (y_min, y_max), parcel_shape,
        cfg.model.diam_pix, cfg.model.diam_meters,
    )
    logger.info(
        "Parcel %s: %d plot centers", os.path.basename(las_filename), len(centers)
    )
    return centers, parcel_cloud


def define_plot_id(plot_idx: int, plot_center) -> str:
    """PPxxxxxxxx_X{x}_Y{y} ids encoding coordinates (prepare_utils.py:84-92)."""
    name = "PP" + str(plot_idx).zfill(8)
    return f"{name}_X{int(plot_center[0])}_Y{int(plot_center[1])}"


def extract_plots_from_parcel(
    cfg: Config,
    parcel_cloud: np.ndarray,
    plot_centers: List[np.ndarray],
) -> Dict[str, Dict]:
    """Extract the per-plot clouds around each center (disk r=10 m) and
    pre-transform them (prepare_utils.py:57-81 + prepare.py:76-94).

    Returns the same {plot_id: cloud_data} structure as the plot dataset.
    """
    radius = cfg.model.diam_meters // 2
    xy = parcel_cloud[:2].T
    centers_arr = np.stack(plot_centers) if plot_centers else np.zeros((0, 2))

    # native C++ grid index when built, else scipy cKDTree (the reference's
    # mechanism, prepare.py:76)
    if native.available() and len(centers_arr):
        offsets, indices = native.disk_query(xy, centers_arr, radius)
        queries = [
            indices[offsets[q] : offsets[q + 1]] for q in range(len(centers_arr))
        ]
    elif len(centers_arr):
        from scipy.spatial import cKDTree

        tree = cKDTree(xy, leafsize=50)
        queries = [tree.query_ball_point(c, r=radius) for c in plot_centers]
    else:  # zero centers: skip the (potentially multi-second) tree build
        queries = []

    plots: Dict[str, Dict] = {}
    min_points = cfg.data.min_points_per_plot  # prepare_utils.py:67-69
    for idx, (center, pt_idx) in enumerate(zip(plot_centers, queries)):
        if len(pt_idx) < min_points:
            continue
        cloud = parcel_cloud[:, pt_idx]
        cloud = pre_transform(cloud, cfg.data.znorm_radius_in_meters)
        plot_id = define_plot_id(idx, center)
        plots[plot_id] = {
            "cloud": cloud,
            "plot_center": np.asarray(center, np.float64),
            "plot_id": plot_id,
            "index": idx,
            "N_points_in_cloud": cloud.shape[1],
        }
    return plots


def save_tiling_figure(
    parcel_cloud: np.ndarray,
    plot_centers: List[np.ndarray],
    parcel_id: str,
    save_path: str,
) -> None:
    """Tiling diagnostic PNG (prepare_utils.py:188-257); without matplotlib
    it logs that the figure is skipped and returns."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed: tiling figure %s skipped", save_path)
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not len(plot_centers):
        # a parcel whose polygon misses its cloud yields zero centers;
        # np.stack([]) would raise and wedge the idempotent prepare
        # worklist (the output pkl is written after this call)
        return
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 10), subplot_kw={"aspect": "equal"})
    sub = parcel_cloud[:, :: max(1, parcel_cloud.shape[1] // 10000)]
    ax.scatter(sub[0], sub[1], s=1, c="g", alpha=0.3)
    centers = np.stack(plot_centers)
    for x, y in centers:
        ax.add_patch(plt.Circle((x, y), PLOT_RADIUS_METERS, fill=True, alpha=0.1))
        ax.add_patch(
            plt.Circle((x, y), PLOT_RADIUS_METERS, fill=False, edgecolor="white", linewidth=0.3)
        )
    ax.scatter(centers[:, 0], centers[:, 1], s=5)
    ax.set_title(f"Parcel {parcel_id}\nsplit in N={len(plot_centers)} plots (r={PLOT_RADIUS_METERS:.0f}m)")
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
