"""The eval forward's batch size swept at bench config-1 geometry (4096-point
clouds), on the PyTorch port (counterpart of `scripts/batch_sweep.py`).

For each batch size (the positional arguments, default 16 32 64 128) the
eval forward of `torch_serve_bench.py` (a `StepProgram` replayed back to
back on the card) runs `iters = max(1, 6400 // b)` calls a trial, the same
points a trial at every b, best of three; each line has points/s and ms a
step by the synchronised host clock, and ms a step by CUDA events. b=128 x
4,096 is `bench.py`'s own geometry. SA1's FPS runs 2 b rows of 2,048
points (512 picks each), SA2's b rows of 1,024 (256 picks, unpartitioned:
128 a part is below `fps_min_part_samples`).

With `--device cpu` every time printed is a CPU time.

Usage:
  python3 scripts/torch_batch_sweep.py [16 32 64 128]
  python3 scripts/torch_batch_sweep.py 2 4 --device cpu --subsample 512 --iters 2
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from torch_serve_bench import (build_kernels, chained, forward_program,  # noqa: E402
                               uniform_inputs, warm_up)

BATCHES = (16, 32, 64, 128)
POINTS_A_TRIAL = 200 * 32  # calls x batch: the same points a trial at every b


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", type=int, nargs="*", default=list(BATCHES))
    ap.add_argument("--subsample", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=0,
                    help="calls a trial (default max(1, 6400 // b))")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.models import init_pointnet2
    from stratanet2_tpu_torch.utils.profiling import card_name

    dev = resolve_device(ns.device)
    mcfg = replace(default_config().model, subsample_size=ns.subsample)
    n = mcfg.subsample_size
    print(f"device: {card_name(dev)}")
    built = build_kernels(dev)
    if built is not None:
        print(f"kernels built in {built:.2f} s")
    model = init_pointnet2(torch.Generator().manual_seed(0), mcfg, device=dev)
    forward = forward_program(model)
    tail = "" if dev.type == "cuda" else " [CPU time]"
    for batch in ns.batches:
        cloud, xyz = uniform_inputs(batch, n, mcfg.n_input_feats - 2, dev)
        iters = ns.iters or max(1, POINTS_A_TRIAL // batch)
        first = warm_up(lambda: forward(cloud, xyz), dev)
        host, events = chained(lambda: forward(cloud, xyz), iters, dev)
        pps = batch * n / (host / 1e3)
        line = (f"b={batch:4d} iters={iters:4d}: {pps / 1e6:7.2f}M pts/s "
                f"({host:7.3f} ms/step)")
        if events is not None:
            line += f" {events:7.3f} ms/step by CUDA events"
        print(f"{line}{tail} first call {first:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
