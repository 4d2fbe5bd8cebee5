"""Multi-seed learnability sweep of the PyTorch port (counterpart of
`scripts/learnability_sweep.py`).

Runs `scripts/torch_learnability_check.py`'s check for >= 3 seeds x
{grouped, nearest} ball-query policies one after the other on the card
(or, with `--fps_parts`, over partitioned-FPS parts instead of policies),
prints each run's `LEARNABILITY_SUMMARY` dict (with `passed`: val MAE below
the mean baseline, the kernel launches of the run by wrapper and its
graphs captured and replayed), appends it to `--out`, and prints a
`SWEEP_SUMMARY` line a policy (or parts): mean +- std val MAE against the
mean baseline.

The JAX script starts a child a run; this one runs each in this process
(`torch_learnability_check.learnability`). A JAX child gives each run its
own compiled programs; here each run's programs, model, optimizer and
device dataset belong to its `train_full` and go with it, the kernels are
built once, and each run's launches are read from the counters around it,
which a child's process would not hand back.

Usage:
  python3 scripts/torch_learnability_sweep.py --epochs 150 --seeds 0 1 2
  python3 scripts/torch_learnability_sweep.py --device cpu --seeds 0 --epochs 2 \\
      --n_plots 10 --subsample_size 256      # the plain versions, on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(SCRIPTS, ".."))
sys.path.insert(0, SCRIPTS)


def variants(fps_parts: Optional[Sequence[int]]) -> Tuple[str, List[Tuple[Dict, object]]]:
    """The key the runs are grouped by, and each variant's keyword arguments
    of `learnability` with its label."""
    if fps_parts:
        return "fps_parts", [({"fps_parts": p}, p) for p in fps_parts]
    return "policy", [({"ball_query_method": pol}, pol) for pol in ("grouped", "nearest")]


def sweep(seeds: Sequence[int], epochs: int = 150, n_plots: int = 60,
          fps_parts: Optional[Sequence[int]] = None, subsample_size: int = 4096,
          device: Optional[str] = None, out: Optional[str] = None) -> Tuple[List[Dict], List[Dict]]:
    """Every seed x variant's run in this process; returns (the runs'
    summaries, the `SWEEP_SUMMARY` dicts). A run that raises is reported
    with its traceback and left out, as the JAX script leaves out a child
    that fails."""
    from torch_learnability_check import learnability
    from stratanet2_tpu_torch.ops import cuda_kernels as ck

    key, runs = variants(fps_parts)
    records = []
    sink = open(out, "a") if out else None
    try:
        for seed in seeds:
            for kwargs, label in runs:
                print(f"== seed {seed} {label} ==", flush=True)
                launches, graphs = ck.launch_counts(), ck.graph_counts()
                try:
                    summary = learnability(epochs=epochs, n_plots=n_plots,
                                           subsample_size=subsample_size, seed=seed,
                                           device=device, **kwargs)
                except Exception:  # a failed run is reported, the sweep goes on
                    print(f"RUN FAILED:\n{traceback.format_exc()[-4000:]}", flush=True)
                    continue
                summary["passed"] = summary["val_MAE"] < summary["baseline_MAE"]
                summary["launches"] = {k: v - launches[k] for k, v in ck.launch_counts().items()}
                summary["graphs"] = {k: v - graphs[k] for k, v in ck.graph_counts().items()}
                records.append(summary)
                if sink:
                    sink.write(json.dumps(summary) + "\n")
                    sink.flush()
                print(json.dumps(summary), flush=True)
    finally:
        if sink:
            sink.close()

    summaries = []
    for gval in sorted({r[key] for r in records}, key=str):
        group = [r for r in records if r[key] == gval]
        maes = [r["val_MAE"] for r in group]
        summaries.append({
            key: gval,
            "n_runs": len(maes),
            "val_MAE_mean": float(np.mean(maes)),
            "val_MAE_std": float(np.std(maes)),
            "baseline_MAE_mean": float(np.mean([r["baseline_MAE"] for r in group])),
            "seconds_mean": float(np.mean([r["seconds"] for r in group])),
        })
        print("SWEEP_SUMMARY " + json.dumps(summaries[-1]), flush=True)
    return records, summaries


def main(argv: Optional[Sequence[str]] = None) -> Tuple[List[Dict], List[Dict]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--n_plots", type=int, default=60)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument(
        "--fps_parts", type=int, nargs="+", default=None,
        help="sweep partitioned-FPS parts instead of ball-query policies; e.g. "
        "--fps_parts 2 4 8",
    )
    ap.add_argument("--subsample_size", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "learnability_sweep.jsonl"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    return sweep(ns.seeds, ns.epochs, ns.n_plots, ns.fps_parts, ns.subsample_size, ns.device,
                 ns.out)


if __name__ == "__main__":
    main()
