"""KDE mixture prior over point altitudes (counterpart of
`stratanet2_tpu/learning/kde.py`, reference learning/kde_mixture.py:37-118).

The port's own numpy copy of the fit: three weighted Gaussian KDEs (linear
binning onto an equidistant grid, then a convolution with a sampled
kernel), z symmetrised around 0, each stratum gated by its prior z range,
bandwidth 0.1 on a 5000-point grid, the pdfs scaled by their weight sums and
normalised by the global max. The train step reads the fitted (grid, pdfs)
as constants (`learning/losses.nll_loss`). `fit_kde_mixture_from_dataset`
fits it on z values sampled from a plot dataset, and `plot_kde_mixture`
draws it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

BW = 0.1
GRID_SIZE = 5 * 10**3
SUBSAMPLE_SIZE = 5 * 10**5
_KERNEL_SUPPORT = 8.0  # +- 8 sigma


@dataclass(frozen=True)
class KdeMixture:
    """Fitted strata prior: `grid` (G,) and `pdfs` (3, G) for ground, Vm, Vh."""

    grid: np.ndarray
    pdfs: np.ndarray


def _linear_binning(x: np.ndarray, w: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Distribute weights onto the two nearest grid nodes."""
    dx = grid[1] - grid[0]
    pos = (x - grid[0]) / dx
    lo = np.clip(np.floor(pos).astype(np.int64), 0, len(grid) - 2)
    frac = pos - lo
    out = np.zeros(len(grid), np.float64)
    np.add.at(out, lo, w * (1.0 - frac))
    np.add.at(out, lo + 1, w * frac)
    return out


def _weighted_gaussian_kde(x: np.ndarray, w: np.ndarray, grid: np.ndarray, bw: float) -> np.ndarray:
    """Weighted Gaussian KDE density on `grid`, integrating to ~1."""
    w = np.asarray(w, np.float64)
    binned = _linear_binning(x, w / w.sum(), grid)
    dx = grid[1] - grid[0]
    half = int(np.ceil(_KERNEL_SUPPORT * bw / dx))
    t = np.arange(-half, half + 1) * dx
    kernel = np.exp(-0.5 * (t / bw) ** 2) / (bw * np.sqrt(2 * np.pi))
    return np.maximum(np.convolve(binned, kernel, mode="same"), 0.0)


def _strata_weights(z: np.ndarray):
    """Prior z-range gates per stratum (kde_mixture.py:54-58)."""
    a = np.abs(z)
    w1 = np.where(a < 0.5, 1.0, 0.05)
    w2 = np.where((a > 0.5) & (a < 1.5), 1.0, 0.05)
    w3 = np.where(a > 1.5, 1.0, np.where(a > 0.5, 0.5, 0.05))
    return w1, w2, w3


def fit_kde_mixture(z: np.ndarray, bw: float = BW, grid_size: int = GRID_SIZE) -> KdeMixture:
    """Fit the three-KDE mixture on an array of altitudes (metres)."""
    z = np.asarray(z, np.float64).reshape(-1)
    z_sym = np.sort(np.concatenate([-z, z]))
    w1, w2, w3 = _strata_weights(z_sym)
    lo = z_sym.min() - _KERNEL_SUPPORT * bw
    hi = z_sym.max() + _KERNEL_SUPPORT * bw
    grid = np.linspace(lo, hi, grid_size)
    ys = [_weighted_gaussian_kde(z_sym, w, grid, bw) * w.sum() for w in (w1, w2, w3)]
    pdfs = np.stack(ys) / max(y.max() for y in ys)
    return KdeMixture(grid=grid.astype(np.float32), pdfs=pdfs.astype(np.float32))


def sample_z_from_dataset(dataset: dict, subsample_size: int = SUBSAMPLE_SIZE, seed: int = 0) -> np.ndarray:
    """Sample z values from a plot dataset (kde_mixture.py:16-21).
    Clouds are stored feature-major: row 2 is z."""
    all_z = np.concatenate([c["cloud"][2] for c in dataset.values()])
    rng = np.random.default_rng(seed)
    rng.shuffle(all_z)
    return all_z[:subsample_size]


def fit_kde_mixture_from_dataset(dataset: dict, seed: int = 0) -> KdeMixture:
    return fit_kde_mixture(sample_z_from_dataset(dataset, seed=seed))


def plot_kde_mixture(kde: KdeMixture, save_path: str, x_lim: float = 25.0) -> None:
    """Diagnostic figure (kde_mixture.py:102-118); matplotlib is imported
    here, not with the module, and without it the figure is skipped with a
    warning: a figure never stops training."""
    import os

    try:
        import matplotlib
    except ImportError as err:
        logging.getLogger("stratanet2_tpu_torch").warning(
            "KDE figure %s skipped: %s", save_path, err
        )
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(15, 4))
    for i, (label, color) in enumerate(
        [("low elevation", "green"), ("medium elevation", "blue"), ("high elevation", "black")]
    ):
        ax.plot(kde.grid, kde.pdfs[i], label=label, color=color)
    ax.set_xlim([0, x_lim])
    ax.set_ylim([0, 1.2])
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
