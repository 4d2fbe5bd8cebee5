"""Synthetic inputs for `chip_smoke.py` and the tests: serve and train
batches and random models made on the device from a seed, with no data
files; and LiDAR plot clouds for LAS files (`make_plot_cloud`,
`cloud_to_las_fields`, copies of `stratanet2_tpu/utils/synthetic.py`'s), a
parcel's (`make_parcel_cloud`), and plots whose ground truth is built from
their geometry (`make_learnable_plot`, a copy of
`scripts/learnability_check.py`'s)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stratanet2_tpu_torch.config import ModelConfig
from stratanet2_tpu_torch.models.nn import BatchNorm
from stratanet2_tpu_torch.models.pointnet2 import PointNet2, init_pointnet2


def serve_batch(
    b: int, n: int, generator: torch.Generator, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 10) clouds and (B, N, 3) positions as the data layer hands them
    to the serve step: xyz centred metres over a 20 m plot (z up to 3 m),
    cloud = [x/10, y/10, z/z_max, 7 features in [0, 1]]. `generator` lives on
    `device`."""
    xy = torch.rand((b, n, 2), generator=generator, device=device) * 20 - 10
    z = torch.rand((b, n, 1), generator=generator, device=device) * 3
    feats = torch.rand((b, n, 7), generator=generator, device=device)
    return torch.cat([xy / 10, z / ModelConfig.z_max, feats], -1), torch.cat([xy, z], -1)


def train_batch(
    b: int, n: int, generator: torch.Generator, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`serve_batch` clouds and positions plus (B, 4) ground-truth plot
    coverages [low, bare, med, high] in [0, 1] with bare = 1 - low."""
    cloud, xyz = serve_batch(b, n, generator, device)
    low, med, high = torch.rand((3, b), generator=generator, device=device)
    return cloud, xyz, torch.stack([low, 1 - low, med, high], dim=1)


@torch.no_grad()
def random_model(
    cfg: ModelConfig, seed: int, device: torch.device, running_stats: bool = True
) -> PointNet2:
    """`init_pointnet2` weights from `seed`, with BN scale/bias drawn as
    well and, if `running_stats`, the BN running statistics too (so that the
    eval BN fold does real work); otherwise they stay at init (mean 0,
    var 1), the state a first train step starts from."""
    gen = torch.Generator().manual_seed(seed)
    model = init_pointnet2(gen, cfg, device="cpu")
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            c = mod.mean.shape[0]
            mod.scale.copy_(torch.rand(c, generator=gen) + 0.5)
            mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
            mean, var = torch.randn(c, generator=gen) * 0.1, torch.rand(c, generator=gen) + 0.5
            if running_stats:
                mod.mean.copy_(mean)
                mod.var.copy_(var)
    return model.to(device).eval()


def make_plot_cloud(rng, n=400, center=(500.0, 6_500_000.0), radius=10.0):
    """Feature-major (10, N) plot cloud with ground / medium / high strata."""
    theta = rng.uniform(0, 2 * np.pi, n)
    r = radius * np.sqrt(rng.uniform(0, 1, n))
    x = center[0] + r * np.cos(theta)
    y = center[1] + r * np.sin(theta)
    return np.asarray([x, y, *_strata(rng, n)], dtype=np.float32)


def make_parcel_cloud(rng, origin, width: float, density: float) -> np.ndarray:
    """Feature-major (10, N) float64 cloud of a width x width m square whose
    lower-left corner is `origin`, `density` points a square metre spread
    uniformly, with `make_plot_cloud`'s strata and features. Float64: the
    absolute coordinates of a parcel (Lambert-93 y ~ 6.8e6) need it."""
    n = int(round(width * width * density))
    x = origin[0] + rng.uniform(0, width, n)
    y = origin[1] + rng.uniform(0, width, n)
    return np.asarray([x, y, *_strata(rng, n)], dtype=np.float64)


def _strata(rng, n: int):
    """z (half ground, 0-0.3 m; 30% medium, 1-5 m; 20% high, 5-20 m),
    colours, near infrared, intensity and the return numbers of n points."""
    kind = rng.choice(3, n, p=[0.5, 0.3, 0.2])
    z = np.where(
        kind == 0,
        rng.uniform(0, 0.3, n),
        np.where(kind == 1, rng.uniform(1, 5, n), rng.uniform(5, 20, n)),
    )
    colors = rng.uniform(0, 65535, (4, n))
    intensity = rng.uniform(0, 32767, n)
    return_num = rng.integers(1, 4, n).astype(np.float64)
    num_returns = np.maximum(return_num, rng.integers(1, 4, n))
    return z, colors[0], colors[1], colors[2], colors[3], intensity, return_num, num_returns


def cloud_to_las_fields(c: np.ndarray) -> dict:
    """Map a feature-major (10, N) cloud onto data.las.write_las fields."""
    return {
        "x": c[0], "y": c[1], "z": c[2], "red": c[3], "green": c[4],
        "blue": c[5], "nir": c[6], "intensity": c[7],
        "return_num": c[8], "num_returns": c[9],
    }


def make_learnable_plot(rng, n=3000, center=(0.0, 0.0), radius=10.0):
    """Cloud whose per-stratum coverages are controlled area fractions.

    The plot disk is divided into pixel cells; each stratum occupies a random
    subset of cells with known fraction. GT = those fractions (the quantity
    the raster max-projection measures). The same draws in the same order as
    `scripts/learnability_check.py:24-71`, so one seed gives the same cloud
    and ground truth bit for bit.
    """
    cov_low = rng.uniform(0.05, 0.95)
    cov_med = rng.uniform(0.05, 0.95)
    cov_high = rng.uniform(0.05, 0.95)

    # pixel centers inside the disk
    g = np.arange(-radius + 0.5, radius, 1.0)
    xx, yy = np.meshgrid(g, g)
    inside = xx**2 + yy**2 < radius**2
    cells = np.stack([xx[inside], yy[inside]], 1)
    n_cells = len(cells)

    def stratum_points(cov, z_lo, z_hi, count):
        k = max(1, int(round(cov * n_cells)))
        chosen = cells[rng.choice(n_cells, k, replace=False)]
        cell_of_pt = chosen[rng.integers(0, k, count)]
        xy = cell_of_pt + rng.uniform(-0.5, 0.5, (count, 2))
        z = rng.uniform(z_lo, z_hi, count)
        return xy, z

    # ground points everywhere (z ~ 0), strata points in their cells
    counts = [n // 2, n // 6, n // 6, n - n // 2 - 2 * (n // 6)]
    xs, zs = [], []
    xy_g = cells[rng.integers(0, n_cells, counts[0])] + rng.uniform(-0.5, 0.5, (counts[0], 2))
    xs.append(xy_g)
    zs.append(rng.uniform(0, 0.05, counts[0]))
    for cov, (lo, hi), cnt in [
        (cov_low, (0.1, 0.4), counts[1]),
        (cov_med, (1.2, 4.0), counts[2]),
        (cov_high, (6.0, 18.0), counts[3]),
    ]:
        xy, z = stratum_points(cov, lo, hi, cnt)
        xs.append(xy)
        zs.append(z)
    xy = np.concatenate(xs) + np.asarray(center)
    z = np.concatenate(zs)
    n_tot = len(z)
    cloud = np.zeros((10, n_tot), np.float32)
    cloud[0], cloud[1], cloud[2] = xy[:, 0], xy[:, 1], z
    cloud[3:7] = rng.uniform(0, 65535, (4, n_tot))
    cloud[7] = rng.uniform(0, 32767, n_tot)
    cloud[8:] = 1.0
    gt = np.array([cov_low, 1 - cov_low, cov_med, cov_high], np.float32)
    return cloud, gt
