"""The eval forward chained at the reference serve geometry (b=20 x 10000),
on the PyTorch port (counterpart of `scripts/serve_bench.py`).

The forward is `pointnet2_forward(train=False)` without the projection: the
port's `PointNet2` in eval mode on (B, N, 8) features and (B, N, 3)
positions drawn uniform in [0, 1) and [-10, 10) m from a seed, weights
`init_pointnet2` from seed 0. On the card it runs as a
`learning/programs.StepProgram` (a CUDA graph, captured at the first call)
replayed back to back, the counterpart of the JAX script's jitted
`fori_loop` chain; each call returns the coverages' sum, as its loop body
does. A trial times `--iters` calls by a synchronised host clock and by
CUDA events; the best of three is printed, as ms a step and points/s. The
serve step that parcel predict runs (`inference/predict.make_predict_step`:
the forward, the raster projection and the plot coverages) is timed the
same way beside it. The kernels' build and the first call (the warm-up and
the capture) are timed on their own, outside every timed window.

With `--device cpu` the forward runs eagerly on the plain versions of the
kernels and every time printed is a CPU time.

Usage:
  python3 scripts/torch_serve_bench.py                 # the card, PROD
  python3 scripts/torch_serve_bench.py --device cpu --batch 2 --subsample 512 --iters 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace
from typing import Callable, Optional, Tuple

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TRIALS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--subsample", type=int, default=10000)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def uniform_inputs(b: int, n: int, feats: int, device: torch.device, seed: int = 1):
    """(B, N, feats) features in [0, 1) and (B, N, 3) positions in
    [-10, 10) m, drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cloud = torch.rand((b, n, feats), generator=gen, device=device)
    xyz = torch.rand((b, n, 3), generator=gen, device=device) * 20 - 10
    return cloud, xyz


def forward_program(model) -> Callable:
    """run(cloud, xyz) -> the coverages' sum of the eval forward: on the card
    a `StepProgram` (captured at its first call, replayed after), on the CPU
    the body itself."""
    from stratanet2_tpu_torch.learning.programs import (StepProgram, graphed, mode_key,
                                                        model_tensors)

    @torch.inference_mode()
    def body(model, cloud, xyz):
        cov, _proba = model(cloud, xyz)
        return cov.sum()

    dev = next(model.parameters()).device
    program = StepProgram(body) if graphed(dev) else None

    def run(cloud, xyz):
        if program is None:
            return body(model, cloud, xyz)
        return program((model,), (cloud, xyz), lambda: model_tensors(model),
                       mode_key(model, False))

    return run


def build_kernels(device: torch.device) -> Optional[float]:
    """Seconds to build the kernel libraries on the card (None on the CPU)."""
    if device.type != "cuda":
        return None
    from stratanet2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def warm_up(fn: Callable, device: torch.device) -> float:
    """Seconds of the first call (on the card: the eager body and the
    graph's capture)."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def chained(fn: Callable, iters: int, device: torch.device,
            trials: int = TRIALS) -> Tuple[float, Optional[float]]:
    """(host ms a call, CUDA-event ms a call or None on the CPU) of `iters`
    calls of `fn` back to back, each the best of `trials`; the host clock
    runs from a synchronised card to a synchronised card."""
    cuda = device.type == "cuda"
    host = events = float("inf")
    for _ in range(trials):
        if cuda:
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
            events = min(events, start.elapsed_time(end) / iters)
        host = min(host, (time.perf_counter() - t0) * 1e3 / iters)
    return host, (events if cuda else None)


def timing_lines(what: str, points: int, host_ms: float, event_ms: Optional[float],
                 device: torch.device):
    """The JAX script's line (points/s and ms a step of the chained wall)
    and the CUDA events' ms a step, or the CPU's label."""
    pps = points / (host_ms / 1e3)
    tail = "" if device.type == "cuda" else " [CPU time]"
    yield f"{what}: {pps / 1e6:.2f}M pts/s ({host_ms:.3f} ms/step chained wall){tail}"
    if event_ms is not None:
        yield f"{what}: {event_ms:.3f} ms/step by CUDA events"


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.inference.predict import make_predict_step
    from stratanet2_tpu_torch.models import init_pointnet2
    from stratanet2_tpu_torch.utils.profiling import card_name

    dev = resolve_device(ns.device)
    cfg = default_config()
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=ns.subsample))
    mcfg = cfg.model
    b, n = ns.batch, mcfg.subsample_size
    print(f"device: {card_name(dev)}")
    built = build_kernels(dev)
    if built is not None:
        print(f"kernels built in {built:.2f} s")
    model = init_pointnet2(torch.Generator().manual_seed(0), mcfg, device=dev)
    cloud, xyz = uniform_inputs(b, n, mcfg.n_input_feats - 2, dev)
    forward = forward_program(model)
    print(f"first call (warm-up, capture) {warm_up(lambda: forward(cloud, xyz), dev):.2f} s")
    host, events = chained(lambda: forward(cloud, xyz), ns.iters, dev)
    for line in timing_lines(f"PROD serve eval fwd b={b}x{n}", b * n, host, events, dev):
        print(line)

    # the serve step of parcel predict: the forward and both projections
    step = make_predict_step(cfg, device=dev)
    full = torch.cat([xyz[..., :2] / 10, cloud], -1)  # (B, N, 10): rescaled x, y first
    print(f"serve step first call {warm_up(lambda: step(model, full, xyz), dev):.2f} s")
    host, events = chained(lambda: step(model, full, xyz), ns.iters, dev)
    for line in timing_lines(f"PROD serve step (fwd + projections) b={b}x{n}", b * n, host,
                             events, dev):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
