"""The PROD train step's time against `fps_parts`, on the PyTorch port
(counterpart of `scripts/fps_parts_steptime.py`).

For `fps_parts` in 2, 4 and 8, with `fps_min_part_samples` 1: the PROD
train step (B=20 x N=10000; on the card a CUDA graph of forward, loss,
backward and Adam) on one batch drawn from `numpy.random.default_rng(0)`
in the JAX script's order, the KDE prior fitted on
`rng.uniform(0, 20, 10000)`, Adam over 10 steps an epoch, the model from
seed 0. After the first step (the warm-up and the capture), a trial
replays 64 steps back to back from one saved state (the model's
parameters and buffers, Adam's state and the schedule put back before
each trial); the best of three trials is printed, as ms a step
(synchronised host clock, and CUDA events) and points/s, with the rows
each SA's FPS took, read from the wrapper's calls in the step's first
(eager) run: parts, rows and points a row.

With `--device cpu` the step runs eagerly on the plain versions and every
time printed is a CPU time.

Usage:
  python3 scripts/torch_fps_parts_steptime.py
  python3 scripts/torch_fps_parts_steptime.py --device cpu --batch 2 --subsample 1024 --iters 1
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from torch_serve_bench import build_kernels, chained  # noqa: E402

PARTS = (2, 4, 8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", type=int, nargs="+", default=list(PARTS))
    ap.add_argument("--batch", type=int, default=0, help="override batch_size (PROD 20)")
    ap.add_argument("--subsample", type=int, default=0,
                    help="override subsample_size (PROD 10000)")
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def parts_config(parts: int, batch: int = 0, subsample: int = 0):
    from stratanet2_tpu_torch.config import default_config

    cfg = default_config()
    model = replace(cfg.model, fps_parts=parts, fps_min_part_samples=1)
    if subsample:
        model = replace(model, subsample_size=subsample)
    train = replace(cfg.train, batch_size=batch) if batch else cfg.train
    return replace(cfg, model=model, train=train)


def fps_rows(cfg):
    """The rows each SA's FPS takes under `cfg`: [(parts, rows, points a
    row, picks a row)] for SA1 and SA2, by `ops/fps.fps_parts_taken`."""
    from stratanet2_tpu_torch.ops.fps import fps_parts_taken

    m, b = cfg.model, cfg.train.batch_size
    out = []
    for n, s in ((m.subsample_size, m.n_centroids1), (m.n_centroids1, m.n_centroids2)):
        p = fps_parts_taken(n, s, m.fps_parts, m.fps_min_part_samples)
        out.append((p, b * p, n // p, s // p))
    return out


def recorded_fps(run):
    """The (rows, points a row, picks) of every FPS kernel call while `run`
    runs (the calls go through)."""
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.profiling import record_calls

    return [(xyz.shape[0], xyz.shape[1], s) for xyz, s, _ in record_calls(ck, ["fps"], run)["fps"]]


def state_of(model, optimizer, scheduler):
    """What a trial starts from: copies of the model's and Adam's tensors
    and the schedule's state."""
    from stratanet2_tpu_torch.learning.programs import model_tensors, optimizer_tensors

    tensors = (*model_tensors(model), *optimizer_tensors(optimizer))
    return tensors, [t.detach().clone() for t in tensors], scheduler.state_dict()


def restore(state, scheduler) -> None:
    """Put a `state_of` back in place (the graphs hold these tensors)."""
    tensors, saved, sched = state
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)
    scheduler.load_state_dict(sched)


def main(argv=None):
    ns = parse_args(argv)
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import init_train_state, make_train_step
    from stratanet2_tpu_torch.utils.profiling import card_name

    dev = resolve_device(ns.device)
    print(f"device: {card_name(dev)}")
    built = build_kernels(dev)
    if built is not None:
        print(f"kernels built in {built:.2f} s")
    rng = np.random.default_rng(0)
    kde = fit_kde_mixture(rng.uniform(0, 20, 10000))
    tail = "" if dev.type == "cuda" else " [CPU time]"
    for parts in ns.parts:
        cfg = parts_config(parts, ns.batch, ns.subsample)
        b, n = cfg.train.batch_size, cfg.model.subsample_size
        cloud = torch.as_tensor(rng.random((b, n, 10), np.float32), device=dev)
        xyz = torch.as_tensor(rng.random((b, n, 3), np.float32) * 10.0, device=dev)
        gt = torch.as_tensor(rng.random((b, 4), np.float32), device=dev)
        ts = init_train_state(cfg, steps_per_epoch=10, seed=0, device=dev)
        step = make_train_step(cfg, kde, device=dev)

        def run():
            return step(ts.model, ts.optimizer, ts.scheduler, cloud, xyz, gt)

        calls = recorded_fps(run)  # the first call: eager, then the capture
        start = state_of(ts.model, ts.optimizer, ts.scheduler)  # Adam's state exists now
        took = fps_rows(cfg)
        best_host, best_events = float("inf"), None
        for _ in range(3):
            restore(start, ts.scheduler)
            host, events = chained(run, ns.iters, dev, trials=1)
            best_host = min(best_host, host)
            if events is not None:
                best_events = events if best_events is None else min(best_events, events)
        line = (f"fps_parts={parts}: {best_host:.2f} ms/step chained "
                f"({b * n / best_host * 1e3 / 1e6:.2f}M pts/s)")
        if best_events is not None:
            line += f" {best_events:.3f} ms/step by CUDA events"
        print(line + tail)
        for sa, (p, rows, npts, picks) in zip(("SA1", "SA2"), took):
            print(f"  {sa} FPS: parts={p} rows={rows} points/row={npts} picks/row={picks}")
        want = [(rows, npts, picks) for _, rows, npts, picks in took]
        if calls[:2] != want:
            raise RuntimeError(f"the step's FPS calls {calls[:2]} are not the rule's {want}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
