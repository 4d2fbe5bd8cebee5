"""Micro-profile of the projection and loss ops at PROD geometry (b=20 x
10k), on the PyTorch port (counterpart of `scripts/profile_projection.py`).

Each op is timed alone by CUDA events over `--iters` calls in a row after
a warm-up, the best of three, on coverages uniform in [0, 1) and xy in
[-1, 1) drawn from `numpy.random.default_rng(0)` as the JAX script draws
them, P = 20 pixels a side:

  plotwise fwd            `ops/projection.plotwise_coverages` (pixel_max)
  plotwise fwd+bwd        its gradient in the coverages (pixel_max and
                          pixel_max_bwd)
  raster projection fwd   `ops/projection.batched_raster_projection`

With `--device cpu` the plain versions run and every time printed is a
CPU time.

Usage:
  python3 scripts/torch_profile_projection.py
  python3 scripts/torch_profile_projection.py --device cpu --batch 2 --n 500 --iters 1
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TRIALS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--p", type=int, default=20, help="pixels a side")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.ops.projection import batched_raster_projection, plotwise_coverages
    from stratanet2_tpu_torch.utils.profiling import card_name, time_ms

    dev = resolve_device(ns.device)
    b, n, p = ns.batch, ns.n, ns.p
    rng = np.random.default_rng(0)
    cov = torch.as_tensor(rng.uniform(0, 1, (b, n, 4)).astype(np.float32), device=dev)
    xy = torch.as_tensor(rng.uniform(-1, 1, (b, n, 2)).astype(np.float32), device=dev)
    covg = cov.clone().requires_grad_(True)

    def fwd():
        with torch.inference_mode():
            return plotwise_coverages(cov, xy, p).sum()

    def fwdbwd():
        return torch.autograd.grad(plotwise_coverages(covg, xy, p).sum(), covg)[0].sum()

    def rast():
        with torch.inference_mode():
            return torch.nansum(batched_raster_projection(xy, cov, p, p))

    print(f"device: {card_name(dev)}")
    rows = [(name, min(time_ms(fn, ns.iters, dev) for _ in range(TRIALS)))
            for name, fn in (("plotwise fwd", fwd), ("plotwise fwd+bwd", fwdbwd),
                             ("raster projection fwd", rast))]
    what = "CUDA events" if dev.type == "cuda" else "CPU times"
    print(f"b={b} n={n} P={p}, device={dev.type} ({what})")
    for name, ms in rows:
        print(f"{name:<28} {ms:>8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
