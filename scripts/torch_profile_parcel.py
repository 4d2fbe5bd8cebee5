"""cProfile of bench config 4 (the parcel pipeline): its host-side hot spots
on the PyTorch port (counterpart of `scripts/profile_parcel.py`).

The JAX script's parcel: 400,000 points uniform over a 120 m square from
`numpy.random.default_rng(0)` (z in [0, 20) m, five features in [0, 30000),
the return numbers 1), tiled into plots by the port's
`inference/tiling.get_plot_centers`; the model `init_pointnet2` from seed 0
at `subsample_size` 4,096. Two profiles, each with its wall seconds and the
top functions by cumulative time:

  prepare          `inference/tiling.extract_plots_from_parcel`
  predict+mosaic   `inference/predict.predict_parcel` (task "inference":
                   batches through the serve step, then the port's raster
                   merge and GeoTIFF writer), after a warm-up of the serve
                   step (the kernels' build and the graph's capture)

cProfile charges every Python call and none of the work inside native code
or on the card, so it finds candidates on the host; it is not a time of
the pipeline (`chip_smoke.py`'s phase 15e times that). With `--device cpu`
the plain versions run on the CPU.

Usage:
  python3 scripts/torch_profile_parcel.py
  python3 scripts/torch_profile_parcel.py --device cpu --n_pts 20000 --side 30 --subsample 256
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_pts", type=int, default=400_000)
    ap.add_argument("--side", type=float, default=120.0, help="the parcel's side (m)")
    ap.add_argument("--subsample", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_parcel(n_pts: int, side: float, seed: int = 0) -> np.ndarray:
    """The JAX script's (10, n_pts) parcel cloud."""
    rng = np.random.default_rng(seed)
    parcel = np.zeros((10, n_pts), np.float32)
    parcel[0] = rng.uniform(0, side, n_pts)
    parcel[1] = rng.uniform(0, side, n_pts)
    parcel[2] = rng.uniform(0, 20, n_pts)
    parcel[3:8] = rng.uniform(0, 30000, (5, n_pts))
    parcel[8:] = 1.0
    return parcel


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.inference.polygons import Polygon
    from stratanet2_tpu_torch.inference.predict import (make_predict_program,
                                                        make_predict_step, predict_parcel)
    from stratanet2_tpu_torch.inference.tiling import extract_plots_from_parcel, get_plot_centers
    from stratanet2_tpu_torch.models import init_pointnet2
    from stratanet2_tpu_torch.utils.profiling import card_name

    dev = resolve_device(ns.device)
    cfg = default_config()
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=ns.subsample))
    mcfg = cfg.model
    side = ns.side
    print(f"device: {card_name(dev)}")
    parcel = make_parcel(ns.n_pts, side)
    shape = Polygon([np.array([[0, 0], [side, 0], [side, side], [0, side], [0, 0]])])
    centers = get_plot_centers((0, side), (0, side), shape, mcfg.diam_pix, mcfg.diam_meters)
    model = init_pointnet2(torch.Generator().manual_seed(0), mcfg, device=dev)

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    plots = extract_plots_from_parcel(cfg, parcel, centers)
    pr.disable()
    print(f"prepare: {time.perf_counter() - t0:.2f}s for {len(plots)} plots")
    pstats.Stats(pr, stream=sys.stdout).sort_stats("cumtime").print_stats(18)

    predict_step = make_predict_step(cfg, device=dev)
    b = cfg.train.batch_size
    t0 = time.perf_counter()
    predict_step(model, torch.zeros((b, mcfg.subsample_size, 10), device=dev),
                 torch.zeros((b, mcfg.subsample_size, 3), device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"serve step warm-up (kernels built, graph captured): {time.perf_counter() - t0:.2f}s")
    program = make_predict_program(cfg, dev, step=predict_step)
    pr2 = cProfile.Profile()
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        pr2.enable()
        predict_parcel(model, plots, cfg, "BENCH", td, task="inference", parcel_shape=shape,
                       device=dev, program=program)
        pr2.disable()
        print(f"predict+mosaic: {time.perf_counter() - t0:.2f}s")
    pstats.Stats(pr2, stream=sys.stdout).sort_stats("cumtime").print_stats(25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
