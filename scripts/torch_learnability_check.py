"""Learnability check of the PyTorch port (counterpart of
`scripts/learnability_check.py`): train on synthetic plots whose
ground-truth coverages are *constructed from the cloud geometry* (strata
occupy known area fractions, `utils/synthetic.make_learnable_plot`), and
check that the model beats the predict-the-mean baseline.

It runs the port's whole weak-supervision loop, `learning/train.train_full`
(pointwise predictions, the raster max-projection, plot-level coverage
supervision, the KDE prior) on the card, with the JAX script's defaults:
60 plots of 3,000 points, 60 epochs, subsample 4,096, batch 8, an eval
every epochs // 4, the first n_plots // 5 plot ids for validation. It
prints a `LEARNABILITY_SUMMARY` line with the JAX script's keys and exits
non-zero when the final val MAE does not beat the baseline.

Usage:
  python3 scripts/torch_learnability_check.py [--epochs 60] [--n_plots 60]
  python3 scripts/torch_learnability_check.py --device cpu --n_plots 10 \\
      --epochs 4 --subsample_size 256     # the plain versions, on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def make_dataset(n_plots: int, seed: int) -> Dict[str, Dict]:
    """`n_plots` learnable plots of 3,000 points, 100 m apart, drawn from
    `seed` in the JAX script's order, under the ids L000, L001, ..."""
    from stratanet2_tpu_torch.utils.synthetic import make_learnable_plot

    rng = np.random.default_rng(seed)
    dataset = {}
    for i in range(n_plots):
        cloud, gt = make_learnable_plot(rng, center=(100.0 * i, 0.0))
        pid = f"L{i:03d}"
        dataset[pid] = {
            "cloud": cloud,
            "coverages": gt,
            "plot_center": np.array([100.0 * i, 0.0], np.float32),
            "plot_id": pid,
            "N_points_in_cloud": cloud.shape[1],
            "index": i,
        }
    return dataset


def mean_baseline(dataset: Dict[str, Dict], val_ids) -> float:
    """MAE of predicting the mean coverage of the val plots' three strata
    (low, medium, high) for every one of them."""
    gts = np.array([[dataset[i]["coverages"][j] for j in (0, 2, 3)] for i in val_ids])
    return float(np.abs(gts - gts.mean()).mean())


def learnability(
    epochs: int = 60,
    n_plots: int = 60,
    subsample_size: int = 4096,
    ball_query_method: str = "grouped",
    seed: int = 0,
    fps_parts: int = 0,
    device: Optional[str] = None,
) -> Dict:
    """Train one fold of the learnable plots on `device` (default CUDA) and
    return the summary: the JAX script's keys, plus the seconds of the run
    and the device it ran on."""
    from dataclasses import replace

    from stratanet2_tpu_torch.config import Config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from stratanet2_tpu_torch.learning.train import train_full
    from stratanet2_tpu_torch.utils.experiment import MetricSink

    dev = resolve_device(device)
    dataset = make_dataset(n_plots, seed)
    cfg = Config()
    cfg = replace(
        cfg,
        model=replace(
            cfg.model,
            subsample_size=subsample_size,
            ball_query_method=ball_query_method,
            **({"fps_parts": fps_parts, "fps_min_part_samples": 1} if fps_parts else {}),
        ),
        train=replace(cfg.train, n_epoch=epochs, n_epoch_test=max(epochs // 4, 1),
                      batch_size=8),
    )
    kde = fit_kde_mixture_from_dataset(dataset)
    ids = np.array(sorted(dataset.keys()))
    n_val = n_plots // 5
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        sink = MetricSink(td)
        try:
            _, train_losses, test_losses, _ = train_full(
                dataset, ids[n_val:], ids[:n_val], cfg, kde, td, sink, fold_id=1,
                seed=seed, device=dev,
            )
        finally:
            sink.close()
    seconds = time.perf_counter() - t0
    return {
        "seed": seed,
        "policy": ball_query_method,
        "fps_parts": fps_parts,
        "epochs": epochs,
        "n_plots": n_plots,
        "val_MAE": float(test_losses[-1]["MAE_loss"]),
        # predict-the-mean baseline on [0.05, 0.95]-uniform coverages: MAE ~0.2
        "baseline_MAE": mean_baseline(dataset, ids[:n_val]),
        "train_MAE_first": float(train_losses[0]["MAE_loss"]),
        "train_MAE_last": float(train_losses[-1]["MAE_loss"]),
        "seconds": seconds,
        "device": str(dev),
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--n_plots", type=int, default=60)
    ap.add_argument("--subsample_size", type=int, default=4096)
    ap.add_argument("--ball_query_method", default="grouped", choices=["grouped", "nearest"])
    ap.add_argument("--seed", type=int, default=0, help="data + training seed")
    ap.add_argument("--fps_parts", type=int, default=0,
                    help="partitioned-FPS parts (0 = the config's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    s = learnability(ns.epochs, ns.n_plots, ns.subsample_size, ns.ball_query_method, ns.seed,
                     ns.fps_parts, ns.device)
    print(f"val MAE after {ns.epochs} epochs: {s['val_MAE']:.4f}")
    print(f"predict-the-mean baseline:       {s['baseline_MAE']:.4f}")
    print(f"train loss first->last: {s['train_MAE_first']:.4f} -> {s['train_MAE_last']:.4f}")
    print("LEARNABILITY_SUMMARY " + json.dumps(s), flush=True)
    if not s["val_MAE"] < s["baseline_MAE"]:
        raise SystemExit("model failed to beat the mean-predictor baseline")
    print("LEARNABILITY CHECK PASSED")


if __name__ == "__main__":
    main()
