"""The SSL cycle end to end on the card, through the PyTorch port
(counterpart of `scripts/ssl_cycle.py`).

Reference workflow (main_SSL.py:59-102, predict.py:104-111): a model
trained on labelled plots pseudo-labels unlabelled parcel tiles
(`predict --task pseudo_labelling`), `main_ssl` pretrains on those
pseudo-labels, and cross-validation warm-starts from the pretrained
checkpoint (`--PT_model_id`). This script runs the whole cycle through the
port's CLI entry points, in this process, on synthetic learnable data
(ground truth built from the geometry, `utils/synthetic.make_learnable_plot`)
and reports each stage's seconds and the warm and cold final val MAE.

Stages (each through a `stratanet2_tpu_torch.cli.*` main, in this process):
  0. build data: n_plots labelled LAS plots, their GT CSV, n_parcels parcel
     LAS and their shapefile (the JAX script's files, byte for byte)
  1. cold cross-val  (cli.main)                       -> MODEL_ID, cold MAE
  2. prepare         (cli.prepare)
  3. pseudo-label    (cli.predict --task pseudo_labelling)
  4. SSL pretrain    (cli.main_ssl)                   -> PT_ID
  5. warm cross-val  (cli.main --PT_model_id PT_ID)   -> warm MAE

Output: one JSON line a stage and a summary line, with the JAX script's
keys. Each stage line also carries the kernel launches of the stage (the
difference of `ops/cuda_kernels.launch_snapshot()` around it: the CLIs log
the process's cumulative counts), the graphs it captured and replayed and
the card's peak allocated and reserved MB; each fold of a cross-validation
prints a line of its own (`"stage": "fold"`): its seconds and where they
went (`torch_prod_schedule_run.time_split`), the card's allocated and
reserved MB at its end, its peak, its captures and replays, its val MAE
against the predict-the-mean baseline of its val plots.

`--fold_alone F` trains fold F of the cold cross-validation alone in this
process into `<root>/fold<F>_alone` (the same pickled plots, prior, split,
config and seed as `cli.main`); `run_fold_alone` starts it in a fresh
process, and `compare_fold` holds it to the cross-validation's fold F bit
for bit.

Usage:
  python3 scripts/torch_ssl_cycle.py --mode PROD --n_plots 110 --points 12000 \\
      --n_parcels 4 --subsample_size 10000 --batch_size 20   # 5 folds x 300 epochs
  python3 scripts/torch_ssl_cycle.py --device cpu --mode PROD --folds 2 --epochs 2 \\
      --ssl_epochs 2 --n_plots 10 --n_parcels 1 --points 1200 \\
      --subsample_size 512 --batch_size 4     # the plain versions, on the CPU
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(SCRIPTS, ".."))
sys.path.insert(0, SCRIPTS)

ALONE_TIMEOUT = 3600.0  # seconds a fold trained alone in a child may take


def build_data(root: str, n_plots: int, points: int, n_parcels: int, seed: int) -> None:
    """Learnable labelled plots and parcels through the real file formats,
    the JAX script's `build_data` draw for draw: the plot LAS files, the GT
    CSV (percents), the parcels' LAS (3 x 3 learnable clouds each) and one
    shapefile of the parcels' squares."""
    from stratanet2_tpu_torch.data.las import write_las
    from stratanet2_tpu_torch.inference import shapefile_io as S
    from stratanet2_tpu_torch.inference.polygons import Polygon
    from stratanet2_tpu_torch.utils.synthetic import cloud_to_las_fields, make_learnable_plot

    rng = np.random.default_rng(seed)
    las_dir = os.path.join(root, "placettes_dataset", "las_classes")
    os.makedirs(las_dir, exist_ok=True)
    lines = ["nom,COUV_BASSE,COUV_INTER,COUV_HAUTE"]
    for i in range(n_plots):
        cloud, gt = make_learnable_plot(rng, n=points, center=(1000.0 + 40.0 * i, 2000.0))
        write_las(os.path.join(las_dir, f"Plot_{i:03d}.las"), cloud_to_las_fields(cloud))
        # gt = (BASSE, SOL, INTER, HAUTE) fractions; the CSV carries percents
        lines.append(",".join([f"Plot_{i:03d}"] + [str(round(100 * float(gt[j])))
                                                    for j in (0, 2, 3)]))
    with open(os.path.join(root, "placettes_dataset", "placettes_metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")

    parcel_dir = os.path.join(root, "parcelles_dataset_20m", "input")
    os.makedirs(parcel_dir, exist_ok=True)
    recs = []
    for p in range(n_parcels):
        x0 = 200.0 * p
        clouds = [make_learnable_plot(rng, n=points, center=(x0 + cx, cy), radius=14.0)[0]
                  for cx in (15.0, 40.0, 65.0) for cy in (15.0, 40.0, 65.0)]
        pid = f"PARCEL_{p:03d}"
        write_las(os.path.join(parcel_dir, f"{pid}.las"),
                  cloud_to_las_fields(np.concatenate(clouds, 1)))
        ring = np.array([[x0, 0], [x0 + 80, 0], [x0 + 80, 80], [x0, 80], [x0, 0]], float)
        recs.append(S.ShapeRecord(Polygon([ring]), {"ID": pid}))
    S.write_shapefile(os.path.join(parcel_dir, "parcels.shp"),
                      S.Shapefile(fields=[S.FieldSpec("ID", "C", 16)], shape_records=recs))


def last_val_mae(stats_path: str) -> float:
    """Final cross-fold mean val MAE from the run's metrics.jsonl."""
    best = None
    with open(os.path.join(stats_path, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            m = rec.get("metrics", {})
            if rec.get("context") == "val_mean" and "MAE_loss" in m:
                if best is None or rec.get("step", 0) >= best[0]:
                    best = (rec.get("step", 0), m["MAE_loss"])
    if best is None:
        raise ValueError(f"no val_mean MAE in {stats_path}")
    return float(best[1])


class Card:
    """The card's counters around a stage or a fold: launches, graphs and
    memory (None on the CPU). Peaks are taken over windows that a nested
    window (a fold's) resets within: `held` keeps what a reset cleared."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.dev = device
        self.cuda = device.type == "cuda"
        self.held = (0, 0)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(device)

    def peaks(self):
        """(peak allocated, peak reserved) bytes since this object was made."""
        if not self.cuda:
            return None
        now = (self.torch.cuda.max_memory_allocated(self.dev),
               self.torch.cuda.max_memory_reserved(self.dev))
        return tuple(max(a, b) for a, b in zip(self.held, now))

    def reset(self) -> None:
        """Start a nested window: the peaks so far kept, the card's cleared."""
        if self.cuda:
            self.held = self.peaks()
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def now_mb(self) -> Dict[str, Optional[float]]:
        if not self.cuda:
            return {"allocated_mb": None, "reserved_mb": None}
        self.torch.cuda.synchronize(self.dev)
        return {"allocated_mb": self.torch.cuda.memory_allocated(self.dev) / 2**20,
                "reserved_mb": self.torch.cuda.memory_reserved(self.dev) / 2**20}

    def peak_mb(self) -> Dict[str, Optional[float]]:
        peaks = self.peaks()
        return {"peak_allocated_mb": peaks and peaks[0] / 2**20,
                "peak_reserved_mb": peaks and peaks[1] / 2**20}


def _since(before: Dict[str, int], now: Dict[str, int]) -> Dict[str, int]:
    return {k: now[k] - before[k] for k in now}


def _close_log_handlers() -> None:
    """Close the handlers a CLI gave the port's logger (its stdout and its
    run folder's stats.txt), so that the next stage starts with none open."""
    logger = logging.getLogger("stratanet2_tpu_torch")
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()


@contextlib.contextmanager
def fold_lines(stage_name: str, card: Card, folds: List[Dict]):
    """Inside: every fold `learning/crossval.cross_validate` trains prints a
    `"stage": "fold"` line and appends its record, with its loss dicts, to
    `folds`."""
    from stratanet2_tpu_torch.learning import crossval
    from stratanet2_tpu_torch.ops import cuda_kernels as ck

    from torch_learnability_check import mean_baseline
    from torch_prod_schedule_run import _records, time_split

    real = crossval.train_full

    def counted(dataset, train_ids, val_ids, cfg, kde, stats_path, *args, fold_id, **kw):
        graphs = ck.graph_counts()
        card.reset()
        t0 = time.time()
        out = real(dataset, train_ids, val_ids, cfg, kde, stats_path, *args, fold_id=fold_id,
                   **kw)
        end = card.now_mb()  # synchronises the card
        t_end = time.time()
        metrics = _records(os.path.join(stats_path, "metrics.jsonl"))[0]
        line = {"stage": "fold", "of": stage_name, "fold": fold_id, "seconds": t_end - t0,
                **end, **card.peak_mb(), **_since(graphs, ck.graph_counts()),
                "epochs_run": len(out[1]), "evals": len(out[2]),
                "seconds_split": time_split(metrics, fold_id, t0, t_end),
                "val_MAE": float(out[2][-1]["MAE_loss"]),
                "baseline_MAE": mean_baseline(dataset, val_ids)}
        print(json.dumps(line), flush=True)
        folds.append(dict(line, train=out[1], test=out[2]))
        return out

    crossval.train_full = counted
    try:
        yield
    finally:
        crossval.train_full = real


def stage(name: str, fn: Callable, device, describe: Optional[Callable] = None):
    """fn(card) as the stage `name`: prints its line, with what
    `describe(fn's result)` adds, and returns (fn's result, the line)."""
    from stratanet2_tpu_torch.ops import cuda_kernels as ck

    card = Card(device)
    launches, graphs = ck.launch_counts(), ck.graph_counts()
    t0 = time.perf_counter()
    try:
        out = fn(card)
    finally:
        _close_log_handlers()
    card.now_mb()  # synchronises the card
    line = {"stage": name, "wall_s": time.perf_counter() - t0,
            "launches": _since(launches, ck.launch_counts()),
            "graphs": _since(graphs, ck.graph_counts()), **card.peak_mb(),
            **(describe(out) if describe else {})}
    print(json.dumps(line), flush=True)
    return out, line


def cli_args(ns: argparse.Namespace) -> List[str]:
    """The command line every stage's CLI gets (the JAX script's), with
    `--device`."""
    root = ns.root
    min_pl = ns.min_pseudo_points or max(50, (9 * ns.points) // 98)
    args = [
        "--mode", ns.mode,
        "--subsample_size", str(ns.subsample_size),
        "--batch_size", str(ns.batch_size),
        "--las_plots_folder_path", f"{root}/placettes_dataset/las_classes",
        "--gt_file_path", f"{root}/placettes_dataset/placettes_metadata.csv",
        "--corrected_gt_file_path", f"{root}/placettes_dataset/placettes_metadata.csv",
        "--plots_pickled_dataset_path", f"{root}/placettes_dataset/prepared/plots.pkl",
        "--las_parcels_folder_path", f"{root}/parcelles_dataset_20m",
        "--parcel_shapefile_path", f"{root}/parcelles_dataset_20m/input/parcels.shp",
        "--experiments_path", f"{root}/experiments",
        "--min_points_for_pseudo_labelling", str(min_pl),
        "--device", ns.device,
    ]
    if ns.epochs:
        args += ["--n_epoch", str(ns.epochs)]
    if ns.folds:
        args += ["--folds", str(ns.folds)]
    return args


def pseudo_labels(root: str, model_id: str) -> int:
    """The plots `predict --task pseudo_labelling` wrote for `model_id`."""
    import pickle

    folder = os.path.join(root, "parcelles_dataset_20m", "pseudo_labelling", model_id)
    count = 0
    for name in sorted(os.listdir(folder)):
        if name.endswith(".pkl"):
            with open(os.path.join(folder, name), "rb") as f:
                count += len(pickle.load(f))
    return count


def run_cycle(ns: argparse.Namespace) -> Dict:
    """The five stages; returns {"stages": {name: line}, "folds": fold
    records with their loss dicts, "summary": the summary line, "cold_path",
    "pt_path", "warm_path": the run folders}."""
    from stratanet2_tpu_torch.cli import main as cli_main
    from stratanet2_tpu_torch.cli import main_ssl as cli_ssl
    from stratanet2_tpu_torch.cli import predict as cli_predict
    from stratanet2_tpu_torch.cli import prepare as cli_prepare
    from stratanet2_tpu_torch.device import resolve_device

    dev = resolve_device(ns.device)
    root = ns.root
    os.makedirs(root, exist_ok=True)
    build_data(root, ns.n_plots, ns.points, ns.n_parcels, ns.seed)
    print(json.dumps({"stage": "data", "n_plots": ns.n_plots, "n_parcels": ns.n_parcels,
                      "points": ns.points}), flush=True)
    args = cli_args(ns)
    stages: Dict[str, Dict] = {}
    folds: List[Dict] = []

    def crossval(name, argv):
        def run(card):
            with fold_lines(name, card, folds):
                return cli_main.main(argv)
        path, stages[name] = stage(name, run, dev)
        return path

    cold_path = crossval("cold_crossval", args)
    model_id = os.path.basename(os.path.normpath(cold_path))
    cold_mae = last_val_mae(cold_path)
    cold_folds = [f for f in folds if f["of"] == "cold_crossval"]
    print(json.dumps({"stage": "cold_result", "model_id": model_id, "val_MAE": cold_mae,
                      "baseline_MAE": float(np.mean([f["baseline_MAE"] for f in cold_folds]))}),
          flush=True)

    _, stages["prepare"] = stage("prepare", lambda card: cli_prepare.main(args), dev)
    _, stages["pseudo_label"] = stage(
        "pseudo_label", lambda card: cli_predict.main(
            args + ["--task", "pseudo_labelling", "--inference_model_id", model_id]), dev,
        describe=lambda _: {"pseudo_labels": pseudo_labels(root, model_id)})

    ssl_args = args + ["--inference_model_id", model_id]
    if ns.ssl_epochs:
        ssl_args += ["--n_epoch", str(ns.ssl_epochs)]
    pt_path, stages["ssl_pretrain"] = stage("ssl_pretrain", lambda card: cli_ssl.main(ssl_args),
                                            dev)
    pt_id = os.path.basename(os.path.normpath(pt_path))
    ssl_mae = last_val_mae(pt_path)

    warm_path = crossval("warm_crossval", args + ["--PT_model_id", pt_id])
    warm_mae = last_val_mae(warm_path)
    warm_folds = [f for f in folds if f["of"] == "warm_crossval"]

    summary = {
        "stage": "summary",
        "mode": ns.mode,
        "cold_val_MAE": cold_mae,
        "warm_val_MAE": warm_mae,
        "warm_minus_cold": warm_mae - cold_mae,
        "wall_s": {name: stages[name]["wall_s"] for name in (
            "cold_crossval", "prepare", "pseudo_label", "ssl_pretrain", "warm_crossval")},
        "cold_baseline_MAE": float(np.mean([f["baseline_MAE"] for f in cold_folds])),
        "warm_baseline_MAE": float(np.mean([f["baseline_MAE"] for f in warm_folds])),
        "ssl_val_MAE": ssl_mae,
        "pseudo_labels": stages["pseudo_label"]["pseudo_labels"],
        "device": str(dev),
    }
    print(json.dumps(summary), flush=True)
    return {"stages": stages, "folds": folds, "summary": summary, "cold_path": cold_path,
            "pt_path": pt_path, "warm_path": warm_path}


def alone_dir(root: str, fold: int) -> str:
    return os.path.join(root, f"fold{fold}_alone")


def fold_alone(ns: argparse.Namespace, fold: int) -> None:
    """Fold `fold` of the cold cross-validation trained alone in this
    process into `alone_dir`: `cli.main`'s inputs (the pickled plots it
    prepared, the prior fitted on them, its KFold split, its config and
    seed), no pretrained weights. Writes the run's loss dicts to
    `losses.json` there."""
    import torch

    from stratanet2_tpu_torch.config import parse_config
    from stratanet2_tpu_torch.data.dataset import get_index_sorted_plot_ids, load_pickled_dataset
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.learning.crossval import kfold_split
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from stratanet2_tpu_torch.learning.train import train_full
    from stratanet2_tpu_torch.utils.experiment import MetricSink

    cfg, _ = parse_config(cli_args(ns))
    dev = resolve_device(ns.device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # as cli.main's start_ranks
    dataset = load_pickled_dataset(cfg.data.plots_pickled_dataset_path)
    kde = fit_kde_mixture_from_dataset(dataset)
    plot_ids = get_index_sorted_plot_ids(dataset)
    train_idx, val_idx = kfold_split(len(plot_ids), cfg.train.folds)[fold - 1]
    out = alone_dir(ns.root, fold)
    os.makedirs(out, exist_ok=True)
    sink = MetricSink(out)
    try:
        _, train_losses, test_losses, _ = train_full(
            dataset, plot_ids[train_idx], plot_ids[val_idx], cfg, kde, out, sink,
            fold_id=fold, seed=cfg.train.seed, device=dev)
    finally:
        sink.close()
    with open(os.path.join(out, "losses.json"), "w") as f:
        json.dump({"train": train_losses, "test": test_losses}, f, default=float)


def run_fold_alone(argv: Sequence[str], fold: int, timeout: float = ALONE_TIMEOUT) -> float:
    """`fold_alone` in a fresh process on the cycle's command line `argv`;
    returns its seconds, raises if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *argv,
                           "--fold_alone", str(fold)], timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"fold {fold} alone exited with code {proc.returncode}")
    return time.perf_counter() - t0


def compare_fold(result: Dict, root: str, fold: int) -> Dict:
    """The cold cross-validation's fold `fold` (`result` of `run_cycle`)
    against the same fold trained alone (`fold_alone`), bit for bit: both
    checkpoints' params, BN buffers, Adam state and metadata, and the loss
    parts and step of every epoch and eval. The keys of
    `torch_prod_schedule_run.compare_runs`, for its `same_run`."""
    from torch_prod_schedule_run import compare_checkpoints, loss_differences

    (got,) = [f for f in result["folds"] if f["of"] == "cold_crossval" and f["fold"] == fold]
    out = alone_dir(root, fold)
    with open(os.path.join(out, "losses.json")) as f:
        want = json.load(f)
    cmp = compare_checkpoints(result["cold_path"], out, fold)
    epochs_match = all([d["epoch"] for d in got[k]] == [d["epoch"] for d in want[k]]
                       for k in ("train", "test"))
    diffs = loss_differences(got["train"], want["train"], got["test"], want["test"])
    return {**cmp, "fold": fold, "epochs_match": epochs_match,
            "train_epochs_compared": len(got["train"]), "evals_compared": len(got["test"]),
            "loss_values_compared": len(diffs), "differing_losses": sum(d != 0 for d in diffs),
            "loss_max_abs_diff": max(diffs, default=0.0)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "ssl_cycle"))
    ap.add_argument("--mode", default="DEV", choices=["DEV", "PROD"])
    ap.add_argument("--n_plots", type=int, default=40)
    ap.add_argument("--n_parcels", type=int, default=2)
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--subsample_size", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=0, help="0 = mode default")
    ap.add_argument("--ssl_epochs", type=int, default=0, help="0 = mode default")
    ap.add_argument("--folds", type=int, default=0, help="0 = cfg default (5)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument(
        "--min_pseudo_points", type=int, default=0,
        help="min points per pseudo-label tile (0 = auto: scale the "
        "reference's 2000-pt filter, predict_utils.py:65, to the synthetic "
        "parcel density: each 20 m tile holds ~9*points/49 points)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fold_alone", type=int, default=0,
                    help="train this fold of the cold cross-validation alone (data built)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict]:
    ns = parse_args(argv)
    if ns.fold_alone:
        fold_alone(ns, ns.fold_alone)
        return None
    return run_cycle(ns)


if __name__ == "__main__":
    main()
