"""Host-side cloud transforms (reference utils/load_data.py +
data_loader/loader.py), a copy of `stratanet2_tpu/data/transforms.py`.

All transforms operate on feature-major clouds (n_feats, N) with the feature
order of config.FEATURE_NAMES, matching the reference's dataset layout.

`min_z_in_radius` replaces the reference's per-point Python loop over KD-tree
query results (utils/load_data.py:237-249, hot loop #2 in SURVEY.md §3.5)
with an exact, fully vectorized grid algorithm; a C++ native path
(native/gridindex) is used automatically when built, and `min_z_path()` says
which of the two runs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from stratanet2_tpu_torch.config import FEATURE_NAMES, ModelConfig
from stratanet2_tpu_torch.data import native

COLORS_MAX = 65536
INTENSITY_MAX = 32768


# ---------------------------------------------------------------------------
# z normalization
# ---------------------------------------------------------------------------

def min_z_in_radius_numpy(xy: np.ndarray, z: np.ndarray, radius: float) -> np.ndarray:
    """Exact min z among xy-neighbors within `radius`, per point.

    Grid algorithm: hash points to cells of size `radius`; for each of the
    9 neighboring cell offsets, walk the (cell-sorted) candidate ranges in
    lock-step slots — each slot iteration is one vectorized O(N) pass, and
    the slot count is bounded by the max cell occupancy. Exact distance
    check per candidate. Complexity O(9 * max_occupancy * N).
    """
    xy = np.asarray(xy, np.float64)
    z = np.asarray(z, np.float64)
    n = len(z)
    if n == 0:
        return z.copy()
    r2 = radius * radius

    cell = np.floor(xy / radius).astype(np.int64)
    cell -= cell.min(axis=0)
    ncx = int(cell[:, 0].max()) + 1
    ncy = int(cell[:, 1].max()) + 1
    cid = cell[:, 0] * ncy + cell[:, 1]

    order = np.argsort(cid, kind="stable")
    cid_sorted = cid[order]
    xy_s, z_s = xy[order], z[order]

    best = z.copy()  # the point itself is always a neighbor
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            tgt = (cell[:, 0] + dx) * ncy + (cell[:, 1] + dy)
            valid_cell = (
                (cell[:, 0] + dx >= 0)
                & (cell[:, 0] + dx < ncx)
                & (cell[:, 1] + dy >= 0)
                & (cell[:, 1] + dy < ncy)
            )
            start = np.searchsorted(cid_sorted, tgt, side="left")
            end = np.searchsorted(cid_sorted, tgt, side="right")
            length = np.where(valid_cell, end - start, 0)
            lmax = int(length.max()) if n else 0
            for t in range(lmax):
                active = t < length
                j = np.where(active, start + t, 0)
                dxy = xy - xy_s[j]
                ok = active & (dxy[:, 0] ** 2 + dxy[:, 1] ** 2 <= r2)
                best = np.where(ok, np.minimum(best, z_s[j]), best)
    return best


def min_z_path() -> str:
    """The path `min_z_in_radius` takes: "native" when the C++ grid index
    builds and loads (data/native.py), else "numpy"."""
    return "native" if native.available() else "numpy"


def min_z_in_radius(xy: np.ndarray, z: np.ndarray, radius: float) -> np.ndarray:
    """Dispatch to the C++ grid index when available, else numpy."""
    if min_z_path() == "native":
        return native.min_z_in_radius(xy, z, radius)
    return min_z_in_radius_numpy(xy, z, radius)


def normalize_z_with_minz_in_a_radius(
    cloud: np.ndarray, znorm_radius_in_meters: float
) -> np.ndarray:
    """Subtract the local ground level: z -= min z among 1.5 m xy-neighbors
    (utils/load_data.py:237-249)."""
    xy = cloud[:2].T
    zmin = min_z_in_radius(xy, cloud[2], znorm_radius_in_meters)
    cloud = cloud.copy()
    cloud[2] = cloud[2] - zmin
    return cloud


def pre_transform(cloud: np.ndarray, znorm_radius_in_meters: float = 1.5) -> np.ndarray:
    """One-time plot preparation (utils/load_data.py:228-234)."""
    return normalize_z_with_minz_in_a_radius(cloud, znorm_radius_in_meters)


# ---------------------------------------------------------------------------
# per-item pipeline (data_loader/loader.py)
# ---------------------------------------------------------------------------

def get_x_y_meshgrid(width: int):
    """Pixel-center meshgrids around 0 (data_loader/loader.py:108-113)."""
    x = np.arange(-width // 2, width // 2, 1) + 0.5
    y = np.arange(-width // 2, width // 2, 1) + 0.5
    return np.meshgrid(x, y, sparse=True)


def get_normalized_x_y_meshgrid(width: int):
    """Normalized pixel-center meshgrids in [-0.5, 0.5] (loader.py:116-124)."""
    xx, yy = get_x_y_meshgrid(width)
    return xx / width, yy / width


def add_fake_empty_ground_points(
    cloud: np.ndarray, diam_meters: int, n_input_feats: int
) -> np.ndarray:
    """Append one zero-feature ground point per raster-pixel center inside
    the plot disk (data_loader/loader.py:90-105) so empty pixels contribute a
    zero low-vegetation anchor to the projection."""
    xx, yy = get_x_y_meshgrid(diam_meters)
    x = (xx + 0 * yy).ravel()
    y = (yy + 0 * xx).ravel()
    r = np.sqrt(x**2 + y**2)
    keep = r < diam_meters // 2
    k = int(keep.sum())
    fake = np.zeros((n_input_feats, k), np.float32)
    fake[0] = x[keep]
    fake[1] = y[keep]
    return np.concatenate([cloud, fake], axis=1)


def center_cloud(cloud: np.ndarray, plot_center: np.ndarray) -> np.ndarray:
    cloud = cloud.copy()
    cloud[0] -= plot_center[0]
    cloud[1] -= plot_center[1]
    return cloud


def rescale_cloud(cloud: np.ndarray, z_max: float) -> np.ndarray:
    """Feature normalization (data_loader/loader.py:135-158): xy/10, z/z_max,
    colors/65536, intensity/32768, returns (v-1)/6."""
    cloud = cloud.copy()
    cloud[0] /= 10.0
    cloud[1] /= 10.0
    cloud[2] /= z_max
    for name in ("red", "green", "blue", "near_infrared"):
        cloud[FEATURE_NAMES.index(name)] /= COLORS_MAX
    cloud[FEATURE_NAMES.index("intensity")] /= INTENSITY_MAX
    for name in ("return_num", "num_returns"):
        i = FEATURE_NAMES.index(name)
        cloud[i] = (cloud[i] - 1) / (7 - 1)
    return cloud


def rotate_around_z(cloud: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.array(((c, -s), (s, c)))
    cloud = cloud.copy()
    cloud[:2] = (cloud[:2].T @ m).T
    return cloud


def augment(
    cloud: np.ndarray, xyz: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Train-time augmentation (data_loader/loader.py:161-230): shared random
    z-rotation and x/y flips on features and positions; clipped Gaussian xy
    noise on the features only.

    Note: the reference also *intends* RGB+NIR noise but reuses the xy sigma
    (0.1 raw color units out of 65536 — i.e. no effect, loader.py:196-206);
    we reproduce the effective behavior (no color noise) rather than the
    dead code.
    """
    angle = np.radians(rng.choice(360))
    flip_x = rng.random() > 0.5
    flip_y = rng.random() > 0.5

    cloud = rotate_around_z(cloud, angle)
    xyz = rotate_around_z(xyz, angle)
    if flip_x:
        cloud[0] = -cloud[0]
        xyz[0] = -xyz[0]
    if flip_y:
        cloud[1] = -cloud[1]
        xyz[1] = -xyz[1]

    sigma, clip = 0.01 * 10, 0.03 * 10
    noise = np.clip(
        sigma * rng.standard_normal(cloud[:2].shape), -clip, clip
    ).astype(np.float32)
    cloud[:2] = cloud[:2] + noise
    return cloud, xyz


def sample_cloud(
    cloud: np.ndarray, subsample_size: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-size subsample; replacement only when too few points
    (data_loader/loader.py:233-246)."""
    n = cloud.shape[1]
    if n > subsample_size:
        idx = rng.choice(n, subsample_size, replace=False)
    else:
        idx = np.concatenate(
            [np.arange(n), rng.choice(n, subsample_size - n, replace=True)]
        )
    return cloud[:, idx].copy(), idx


def load_cloud_item(
    cloud_data: Dict,
    model_cfg: ModelConfig,
    train: bool,
    rng: np.random.Generator,
) -> Dict:
    """Full per-item pipeline (data_loader/loader.py:73-87): center -> fake
    ground points -> xyz snapshot -> (train) augment -> rescale -> subsample.

    Returns point-major arrays ready for device batching:
      cloud (N, 10) rescaled features, xyz (N, 3) centered meters,
      coverages (4,) GT or empty.
    """
    # center in float64 (absolute Lambert-93 coords lose ~0.25 m in
    # float32); the return casts to float32 once coordinates are relative
    cloud = np.asarray(cloud_data["cloud"], np.float64)
    n_original = cloud.shape[1]  # before fake points / subsampling
    cloud = center_cloud(cloud, cloud_data["plot_center"]).astype(np.float32)
    cloud = add_fake_empty_ground_points(
        cloud, model_cfg.diam_meters, model_cfg.n_input_feats
    )
    xyz = cloud[:3].copy()
    if train:
        cloud, xyz = augment(cloud, xyz, rng)
    cloud = rescale_cloud(cloud, model_cfg.z_max)
    cloud, idx = sample_cloud(cloud, model_cfg.subsample_size, rng)
    xyz = xyz[:, idx]

    coverages = np.asarray(cloud_data.get("coverages", np.empty(0)), np.float32)
    return {
        "cloud": cloud.T.astype(np.float32),  # (N, 10)
        "xyz": xyz.T.astype(np.float32),  # (N, 3)
        "coverages": coverages,
        "plot_id": cloud_data["plot_id"],
        # float64: host-side metadata only (geotransform origins); a
        # float32 absolute center would re-introduce the 0.5 m grid
        "plot_center": np.asarray(cloud_data["plot_center"], np.float64),
        "N_points_in_cloud": cloud_data.get("N_points_in_cloud", n_original),
    }
