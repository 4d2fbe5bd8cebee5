"""Per-stage micro-benchmark of the fused SA eval kernel at bench config-1
geometry, on the PyTorch port (counterpart of `scripts/sa_bench.py`).

`ops/cuda_kernels.sa_fused_eval` alone at SA1 (N -> C1 centroids, K=k1,
two layers 16 -> 16) and at SA2 (C1 -> C2, K=k2, one layer of 32), on the
JAX script's inputs drawn from `numpy.random.default_rng(0)` in its order
(sa_bench.py:64-110): q and cterm standard normal, positions uniform in
[-10, 10) m, the centroids the first C points, identity affines, W2
normal x 0.1. Each stage's time is the mean of `--iters` launches between
two CUDA events, the best of three, after a warm-up (which builds the
kernel).

With `--device cpu` the plain version runs and every time printed is a CPU
time.

Usage:
  python3 scripts/torch_sa_bench.py [--batch 128] [--subsample 4096] [--iters 50]
  python3 scripts/torch_sa_bench.py --device cpu --batch 1 --subsample 512 --iters 1
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TRIALS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--subsample", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def stage_inputs(cfg, b: int, device):
    """The JAX script's SA1 and SA2 arguments of `sa_fused_eval` (the
    radius and K last), drawn in its order."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).contiguous()

    n1, c1, ch1 = cfg.subsample_size, cfg.n_centroids1, 16
    q1 = t(rng.standard_normal((b, n1, ch1)))
    xyz1 = t(rng.uniform(-10, 10, (b, n1, 3)))
    cterm1 = t(rng.standard_normal((b, c1, ch1)))
    w2 = t(rng.standard_normal((ch1, ch1)) * 0.1)
    ones1, zeros1 = t(np.ones(ch1)), t(np.zeros(ch1))
    sa1 = (q1, xyz1, xyz1[:, :c1].contiguous(), cterm1, ones1, zeros1, w2, zeros1, ones1, zeros1,
           cfg.r1, cfg.k1)
    n2, c2, ch2 = c1, cfg.n_centroids2, 32
    q2 = t(rng.standard_normal((b, n2, ch2)))
    xyz2 = xyz1[:, :n2].contiguous()
    cterm2 = t(rng.standard_normal((b, c2, ch2)))
    sa2 = (q2, xyz2, xyz2[:, :c2].contiguous(), cterm2, t(np.ones(ch2)), t(np.zeros(ch2)),
           None, None, None, None, cfg.r2, cfg.k2)
    return sa1, sa2


def time_stage(name: str, args, iters: int, device) -> float:
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.profiling import time_ms

    with torch.inference_mode():
        ms = min(time_ms(lambda: ck.sa_fused_eval(*args), iters, device) for _ in range(TRIALS))
    tail = "" if torch.device(device).type == "cuda" else " [CPU time]"
    print(f"{name:34s} {ms:7.3f} ms/call{tail}")
    return ms


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.utils.profiling import card_name

    dev = resolve_device(ns.device)
    cfg = replace(default_config().model, subsample_size=ns.subsample)
    b = ns.batch
    print(f"device: {card_name(dev)}")
    sa1, sa2 = stage_inputs(cfg, b, dev)
    m1 = time_stage(f"SA1 b={b} n={cfg.subsample_size} c={cfg.n_centroids1} k={cfg.k1}", sa1,
                    ns.iters, dev)
    m2 = time_stage(f"SA2 b={b} n={cfg.n_centroids1} c={cfg.n_centroids2} k={cfg.k2}", sa2,
                    ns.iters, dev)
    print(f"{'TOTAL sa_fused':34s} {m1 + m2:7.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
