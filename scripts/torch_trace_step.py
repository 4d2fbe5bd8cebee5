"""In-step device-time profile of the PROD train (or eval) step through
`torch.profiler`, on the PyTorch port (counterpart of
`scripts/trace_step.py`).

The train step (on the card the replay of its CUDA graph; `--eager` its
eager body instead, where every operator carries its input shapes; `--mode
eval`: `learning/train.make_eval_step`, which runs its body) runs on one
batch drawn from `numpy.random.default_rng(0)` in the JAX script's order,
the KDE prior fitted on `rng.uniform(0, 20, 10000)`, the model from seed 0.
After a warm-up (the kernels' build and the graph's capture, outside the
trace) the step's wall is the median of synchronised steps by the host
clock; then `--steps` steps run under `utils/profiling.trace` (CPU and
CUDA activities, input shapes recorded), which writes a chrome trace into
`--logdir`. The trace is read back (`utils/profiling.load_trace`), its
device operations (`is_device_op`: kernels, copies, memsets) are grouped by
name into ms a step (`device_table`), the top `--top` printed, then the
device's total ms a step and its idle share, 1 - device busy / step wall.
On the card a trace with no device operation raises, and so does a
profiler that cannot start. `scripts/torch_trace_raw.py` prints the
same trace ungrouped.

With `--device cpu` the trace holds the CPU's operators; their outermost
spans are grouped instead, every time is a CPU time and the idle share is
not measured.

Usage:
  python3 scripts/torch_trace_step.py [--mode train|eval] [--steps 3] [--top 30]
  python3 scripts/torch_trace_step.py --device cpu --batch 2 --subsample 512 --steps 1
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from dataclasses import replace
from typing import Callable

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

WALL_STEPS = 10  # synchronised steps whose median is the step's wall


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="train", choices=["train", "eval"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--batch", type=int, default=0, help="override batch size")
    ap.add_argument("--subsample", type=int, default=0, help="override subsample_size")
    ap.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(), "trace_step"))
    ap.add_argument("--eager", action="store_true",
                    help="trace the step's eager body, not its graph's replay")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_step(mode: str, batch: int = 0, subsample: int = 0, device="cuda",
               eager: bool = False) -> Callable[[], torch.Tensor]:
    """run() -> one PROD step (overridden batch and subsample) on `device`;
    returns its total loss (the eval's summed over the plots), as the JAX
    script's run does."""
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import (init_train_state, make_eval_step,
                                                     make_train_step)

    cfg = default_config()
    if subsample:
        cfg = replace(cfg, model=replace(cfg.model, subsample_size=subsample))
    if batch:
        cfg = replace(cfg, train=replace(cfg.train, batch_size=batch))
    b, n = cfg.train.batch_size, cfg.model.subsample_size
    rng = np.random.default_rng(0)
    cloud = torch.as_tensor(rng.random((b, n, cfg.model.n_input_feats), np.float32),
                            device=device)
    xyz = torch.as_tensor(rng.random((b, n, 3), np.float32) * 10.0, device=device)
    gt = torch.as_tensor(rng.random((b, 4), np.float32), device=device)
    kde = fit_kde_mixture(rng.uniform(0, 20, 10000))
    ts = init_train_state(cfg, steps_per_epoch=10, seed=0, device=device)
    if mode == "train":
        step = make_train_step(cfg, kde, device=device)
        if eager:
            return lambda: step.body(ts.model, ts.optimizer, cloud, xyz, gt)["total_loss"]
        return lambda: step(ts.model, ts.optimizer, ts.scheduler, cloud, xyz, gt)["total_loss"]
    estep = make_eval_step(cfg, kde, device=device)  # runs its body: the eval holds no graph
    return lambda: estep(ts.model, cloud, xyz, gt)[3]["total_loss"].sum()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def step_wall_ms(run: Callable, device, steps: int = WALL_STEPS) -> float:
    """Median ms of `steps` synchronised calls by the host clock."""
    times = []
    for _ in range(steps):
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def traced_events(run: Callable, steps: int, logdir: str, device, warmup: int = 0) -> list:
    """`steps` calls of `run` under `utils/profiling.trace` into `logdir`
    (emptied first), after `warmup` calls under the profiler's warm-up
    (left out of the trace), the trace read back: its device operations (on
    the CPU its outermost operators)."""
    from stratanet2_tpu_torch.utils.profiling import is_device_op, load_trace, outermost, trace

    dev = torch.device(device)
    shutil.rmtree(logdir, ignore_errors=True)
    with trace(logdir, warmup) as prof:
        for _ in range(warmup):
            run()
            sync(dev)
            prof.step()
        for _ in range(steps):
            run()
        sync(dev)
    events = [ev for ev in load_trace(logdir) if is_device_op(ev, dev.type)]
    return outermost(events) if dev.type == "cpu" else events


def trace_table(run: Callable, steps: int, logdir: str, device, wall_ms=None, warmup: int = 0):
    """The step's device table (`utils/profiling.device_table`) over `steps`
    traced calls of `run` (after `warmup` untraced ones, `traced_events`);
    on the card it raises without a device operation. `wall_ms` (a step's
    wall) gives the idle share. `chip_smoke.py`'s step profiles (phases 7,
    14 and 15h) are taken through it."""
    from stratanet2_tpu_torch.utils.profiling import device_table

    dev = torch.device(device)
    events = traced_events(run, steps, logdir, dev, warmup)
    return device_table(events, steps, wall_ms if dev.type == "cuda" else None, dev.type)


def print_table(table, top: int, device) -> None:
    cpu = torch.device(device).type == "cpu"
    print(f"{'op' if not cpu else 'op (outermost CPU operators)':64s} {'ms/step':>8s}")
    for ms, _calls, name in table.rows[:top]:
        print(f"{name[:64]:64s} {ms:8.3f}")
    print(f"{'TOTAL (device ops)' if not cpu else 'TOTAL (CPU time)':64s} {table.busy_ms:8.3f}")
    idle = "not measured" if table.idle_share is None else f"{table.idle_share:.4f}"
    print(f"{'idle share (1 - device busy / step wall)':64s} {idle:>8s}")


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.utils.profiling import card_name, device_sync

    dev = resolve_device(ns.device)
    print(f"device: {card_name(dev)}")
    t0 = time.perf_counter()
    run = build_step(ns.mode, ns.batch, ns.subsample, dev, ns.eager)
    device_sync(run())  # the warm-up: kernels built, the graph captured, outside the trace
    print(f"set-up and first step {time.perf_counter() - t0:.2f} s")
    wall = step_wall_ms(run, dev)
    tail = "" if dev.type == "cuda" else " [CPU time]"
    print(f"step wall {wall:.3f} ms (median of {WALL_STEPS} synchronised steps){tail}")
    table = trace_table(run, ns.steps, ns.logdir, dev, wall)
    print_table(table, ns.top, dev)
    print(f"trace written under {ns.logdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
