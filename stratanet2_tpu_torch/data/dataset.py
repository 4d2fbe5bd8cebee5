"""Plot-dataset construction (reference utils/load_data.py), a copy of
`stratanet2_tpu/data/dataset.py`. pandas is imported where the ground-truth
CSV is read, not with the module.

Builds the pickled `{plot_id: cloud_data}` dataset from a folder of plot LAS
files and a ground-truth CSV, with the same structure the reference pickles
(utils/load_data.py:52-85): feature-major cloud (10, N), plot_center,
coverages in [0, 1] ordered [COUV_BASSE, COUV_SOL, COUV_INTER, COUV_HAUTE],
insertion `index` for reproducible cross-validation folds.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

from stratanet2_tpu_torch.config import FEATURE_NAMES, Config
from stratanet2_tpu_torch.data.las import read_las
from stratanet2_tpu_torch.data.transforms import pre_transform

if TYPE_CHECKING:
    import pandas as pd

logger = logging.getLogger(__name__)


def load_ground_truths_dataframe(gt_file_path: str) -> pd.DataFrame:
    """GT CSV loader; derives COUV_SOL = 100 - COUV_BASSE
    (utils/load_data.py:26-49). Values stay in percent here."""
    import pandas as pd

    df = pd.read_csv(gt_file_path, sep=",", header=0)
    df = df.rename({"nom": "Name"}, axis=1)
    df["COUV_SOL"] = 100 - df["COUV_BASSE"]
    for col in ("Name", "COUV_BASSE", "COUV_SOL", "COUV_INTER", "COUV_HAUTE"):
        assert col in df, f"ground truth file missing column {col}"
    return df


def load_las_file(filename: str) -> np.ndarray:
    """LAS -> (10, N) float32 feature-major cloud in meters
    (utils/load_data.py:149-184)."""
    las = read_las(filename)
    # float64: absolute Lambert-93 coordinates (y ~ 6.5e6 m) have only
    # 0.5 m float32 spacing — quantizing before centering would put up to
    # ~0.25 m of error on every relative coordinate and geotransform
    # origin. float32 conversion happens after centering (transforms).
    cloud = np.asarray(
        [
            las.x, las.y, las.z,
            las.red, las.green, las.blue, las.nir,
            las.intensity, las.return_num, las.num_returns,
        ],
        dtype=np.float64,
    )
    return cloud


def clean(cloud: np.ndarray, las_filename: str) -> np.ndarray:
    """Per-file hardcoded outlier removal (utils/load_data.py:187-202)."""
    z_idx = FEATURE_NAMES.index("z_flat")
    i_idx = FEATURE_NAMES.index("intensity")
    if las_filename.endswith("Releve_Lidar_F70.las"):
        cloud = cloud[:, cloud[z_idx] < 640]
    if las_filename.endswith("POINT_OBS8.las"):
        cloud = cloud[:, cloud[i_idx] < 32768]
    if las_filename.endswith("Releve_Lidar_F39.las"):
        cloud = cloud[:, cloud[i_idx] < 20000]
    return cloud


def get_plot_center(cloud: np.ndarray) -> np.ndarray:
    """Bounding-box center along x/y (utils/load_data.py:216-225)."""
    return np.array(
        [
            (cloud[0].max() + cloud[0].min()) / 2.0,
            (cloud[1].max() + cloud[1].min()) / 2.0,
        ],
        dtype=np.float64,
    )


def get_plot_ground_truth_coverages(ground_truths: pd.DataFrame, plot_id: str) -> np.ndarray:
    """[COUV_BASSE, COUV_SOL, COUV_INTER, COUV_HAUTE] / 100
    (utils/load_data.py:205-213)."""
    cov = (
        ground_truths[ground_truths["Name"] == plot_id][
            ["COUV_BASSE", "COUV_SOL", "COUV_INTER", "COUV_HAUTE"]
        ].values
        / 100
    )
    return cov.astype(float).squeeze()


def get_cloud_data(filename: str, cfg: Config, ground_truths: pd.DataFrame):
    """Single-plot LAS -> cloud_data dict (utils/load_data.py:122-140)."""
    cloud = load_las_file(filename)
    cloud = clean(cloud, filename)
    cloud = pre_transform(cloud, cfg.data.znorm_radius_in_meters)

    plot_id = os.path.splitext(os.path.basename(filename))[0]
    cloud_data = {
        "cloud": cloud,
        "coverages": get_plot_ground_truth_coverages(ground_truths, plot_id),
        "plot_center": get_plot_center(cloud),
        "plot_id": plot_id,
        "N_points_in_cloud": cloud.shape[1],
    }
    return plot_id, cloud_data


def _files_of_type(folder: str, ext: str) -> List[str]:
    return sorted(
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.lower().endswith(ext)
    )


def sample_filenames_for_dev_crossvalidation(
    filenames: List[str], cfg: Config, n_by_fold: int = 6
) -> List[str]:
    """DEV-mode subset keeping tracked plots (utils/load_data.py:252-261)."""
    selection = [
        f
        for f in filenames
        if any(n in f for n in cfg.plot_name_to_visualize_during_training)
    ]
    rest = [f for f in filenames if f not in selection]
    random.Random(0).shuffle(rest)
    take = cfg.train.folds * n_by_fold - len(selection)
    return selection + rest[:take]


def prepare_and_save_plots_dataset(cfg: Config, gt_file_path: Optional[str] = None) -> Dict:
    """Build and pickle the plot dataset (utils/load_data.py:52-85)."""
    gt_file_path = gt_file_path or cfg.data.corrected_gt_file_path
    las_filenames = _files_of_type(cfg.data.las_plots_folder_path, ".las")
    if cfg.mode == "DEV":
        las_filenames = sample_filenames_for_dev_crossvalidation(las_filenames, cfg)

    ground_truths = load_ground_truths_dataframe(gt_file_path)
    # exact-match names like the reference (utils/load_data.py:69-74): the
    # plot_id later derives from the filename and must hit the same GT row
    by_name = {os.path.splitext(os.path.basename(f))[0]: f for f in las_filenames}
    plot_names = [n for n in ground_truths.Name.values if str(n) in by_name]

    dataset = {}
    for index, plot_name in enumerate(plot_names):
        filename = by_name[str(plot_name)]
        plot_id, cloud_data = get_cloud_data(filename, cfg, ground_truths)
        cloud_data["index"] = index
        dataset[plot_id] = cloud_data

    out = cfg.data.plots_pickled_dataset_path
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(dataset, f)
    logger.info("Prepared dataset with %d plots -> %s", len(dataset), out)
    return dataset


def load_pickled_dataset(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_pseudo_labelled_datasets(cfg: Config, inference_model_id: str) -> Dict:
    """Merge per-parcel pseudo-labelled pickles for SSL pretraining
    (utils/load_data.py:103-119); DEV keeps the first 30 plots of the first
    pickle."""
    input_folder = os.path.join(
        cfg.data.las_parcels_folder_path, "pseudo_labelling", inference_model_id
    )
    full: Dict = {}
    for p in _files_of_type(input_folder, ".pkl"):
        with open(p, "rb") as f:
            full.update(pickle.load(f))
        if cfg.mode == "DEV":
            items = list(full.items())[:30]
            full = dict(items)
            break
    return full


def get_index_sorted_plot_ids(dataset: Dict) -> np.ndarray:
    """Plot ids sorted by insertion index, for reproducible KFold splits
    (data_loader/loader.py:46-54)."""
    items = sorted(dataset.values(), key=lambda c: c["index"])
    return np.array([c["plot_id"] for c in items])
