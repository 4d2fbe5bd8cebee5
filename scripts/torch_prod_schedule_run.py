"""The reference training schedule on the card, through the PyTorch port
(counterpart of `scripts/prod_schedule_run.py`).

The real workload: folds of 300 epochs at PROD geometry (batch 20 x 10,000
points, reference learning/train.py:82-177, config.py:88-97) with early
stopping on, over 110 synthetic plots of 12,000 points whose ground truth
is built from their geometry (`utils/synthetic.make_learnable_plot`, seed
7), each fold in a process of its own through the port's
`learning/train.train_full`. The validation plots of fold f are the
contiguous ids[(f - 1) n_val : f n_val], n_val = plots // 5, as the JAX
script splits them. `--orchestrate` kills fold 1 by SIGTERM once it has
finished `--kill_after` epochs (past two evals, so that a `.resume`
checkpoint exists), resumes it with `--resume` in a new process, then runs
fold 2; `--folds 1-5` runs the whole cross-validation, a process a fold.

Every run prints a `FOLD_SUMMARY` line with the JAX script's keys, plus the
epoch the kill landed after and the one the resume started from, the
kernel launches by wrapper (`ops/cuda_kernels.launch_counts()`, which
counts graph replays), the graphs captured and replayed, and the card's
peak allocated and reserved MB; it is appended to `<root>/fold<f>_summary.json`,
and the run's loss dicts to `<root>/fold<f>_losses.jsonl`.
`compare_runs` holds a killed-and-resumed fold to an unbroken one, bit for
bit.

Usage:
  # data + fold 1 with kill/resume + fold 2:
  python3 scripts/torch_prod_schedule_run.py --orchestrate --root /tmp/sched
  # the whole 5-fold cross-validation, a process a fold:
  python3 scripts/torch_prod_schedule_run.py --folds 1-5 --root /tmp/cv
  # one fold (what the orchestrator spawns):
  python3 scripts/torch_prod_schedule_run.py --root /tmp/sched --fold 1 [--resume]
  # on the CPU at a tiny size:
  python3 scripts/torch_prod_schedule_run.py --orchestrate --root /tmp/s --device cpu \\
      --plots 20 --points 600 --batch 4 --subsample 256 --n_epoch 8 \\
      --n_epoch_test 1 --kill_after 3
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import signal
import subprocess
import sys
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

DATA_SEED = 7
POLL_SECONDS = 0.05  # an epoch on the card takes ~25 ms: poll the metrics at 50 ms
TIMEOUT_SECONDS = 3 * 3600.0  # a child's longest run


def build_dataset(root: str, plots: int = 110, points: int = 12000) -> str:
    """`<root>/plots.pkl`: `plots` learnable plots of `points` points from
    seed 7, under the ids P000, P001, ... (made once; an existing file is
    kept)."""
    from stratanet2_tpu_torch.utils.synthetic import make_learnable_plot

    path = os.path.join(root, "plots.pkl")
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(DATA_SEED)
    dataset = {}
    for i in range(plots):
        cloud, gt = make_learnable_plot(rng, n=points, center=(100.0 * i, 0.0))
        pid = f"P{i:03d}"
        dataset[pid] = {
            "cloud": cloud.astype(np.float32),
            "coverages": gt,
            "plot_center": np.array([100.0 * i, 0.0], np.float32),
            "plot_id": pid,
            "N_points_in_cloud": cloud.shape[1],
            "index": i,
        }
    os.makedirs(root, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(dataset, f)
    os.replace(tmp, path)
    return path


def fold_split(ids: np.ndarray, fold: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train ids, val ids) of `fold` (1-based): the val ids are the
    contiguous ids[(fold - 1) n_val : fold n_val], n_val = len(ids) // 5."""
    n_val = len(ids) // 5
    lo, hi = (fold - 1) * n_val, fold * n_val
    return np.concatenate([ids[:lo], ids[hi:]]), ids[lo:hi]


def fold_config(ns: argparse.Namespace):
    """The PROD `Config()` with `n_epoch` and early stopping on, and the
    flags that cut it (batch, subsample, n_epoch_test) where given."""
    from dataclasses import replace

    from stratanet2_tpu_torch.config import Config

    cfg = Config()
    train = replace(cfg.train, n_epoch=ns.n_epoch, use_early_stopping=True)
    if ns.batch:
        train = replace(train, batch_size=ns.batch)
    if ns.n_epoch_test:
        train = replace(train, n_epoch_test=ns.n_epoch_test)
    cfg = replace(cfg, train=train)
    if ns.subsample:
        cfg = replace(cfg, model=replace(cfg.model, subsample_size=ns.subsample))
    return cfg


def _records(path: str, offset: int = 0) -> Tuple[List[Dict], int]:
    """The whole JSON lines of `path` from byte `offset` on, and the offset
    after the last whole line (a torn last line, racing the writer's
    append, is left for the next read)."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read()
    except FileNotFoundError:
        return [], offset
    end = data.rfind(b"\n") + 1
    return [json.loads(line) for line in data[:end].splitlines() if line.strip()], offset + end


def _train_records(records: List[Dict], fold: int) -> List[Dict]:
    """The fold's train records (one an epoch) among the metric sink's."""
    return [r for r in records
            if r.get("context") == f"fold_{fold}_train" and "epoch_seconds" in r["metrics"]]


def train_epochs(metrics_path: str, fold: int, offset: int = 0) -> List[int]:
    """The epochs whose train record the fold's runs wrote to the metric
    sink from byte `offset` on, in file order."""
    return [r["epoch"] for r in _train_records(_records(metrics_path, offset)[0], fold)]


def time_split(records: List[Dict], fold: int, t0: float, t_end: float) -> Dict[str, float]:
    """Where the seconds of a `train_full` run begun at `t0` and ended at
    `t_end` went, from the train records its metric sink wrote (`records`,
    each stamped when its epoch ended): `setup` before the first epoch
    (datasets, model, a resume's checkpoint), `epochs` (their
    `epoch_seconds`, the first epoch's capture apart in `first_epoch`),
    `between_epochs` (the evals and their checkpoints) and `final` (the
    last eval on the best weights)."""
    train = _train_records(records, fold)
    if not train:
        return {"setup": 0.0, "first_epoch": 0.0, "epochs": 0.0, "between_epochs": 0.0,
                "final": t_end - t0}
    secs = [r["metrics"]["epoch_seconds"] for r in train]
    starts = [r["t"] - e for r, e in zip(train, secs)]
    return {"setup": starts[0] - t0, "first_epoch": secs[0], "epochs": sum(secs),
            "between_epochs": sum(b - a["t"] for a, b in zip(train, starts[1:])),
            "final": t_end - train[-1]["t"]}


def run_fold(root: str, fold: int, resume: bool, ns: argparse.Namespace) -> Dict:
    """One fold of the schedule in this process on `ns.device` (default
    CUDA); appends its summary and loss dicts to the root's files, prints
    `FOLD_SUMMARY` and returns the summary."""
    import torch

    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from stratanet2_tpu_torch.learning.train import train_full
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.experiment import MetricSink

    dev = resolve_device(ns.device)
    with open(os.path.join(root, "plots.pkl"), "rb") as f:
        dataset = pickle.load(f)
    cfg = fold_config(ns)
    kde = fit_kde_mixture_from_dataset(dataset)
    ids = np.array(sorted(dataset.keys()))
    train_ids, val_ids = fold_split(ids, fold)

    stats = os.path.join(root, f"fold{fold}")
    os.makedirs(stats, exist_ok=True)
    metrics_path = os.path.join(stats, "metrics.jsonl")
    killed_after = (train_epochs(metrics_path, fold) or [None])[-1] if resume else None
    offset = os.path.getsize(metrics_path) if os.path.exists(metrics_path) else 0
    ck.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sink = MetricSink(stats)
    t0 = time.time()
    try:
        _, train_losses, test_losses, _ = train_full(
            dataset, train_ids, val_ids, cfg, kde, stats, sink,
            fold_id=fold, resume=resume, device=dev,
        )
    finally:
        sink.close()
    t_end = time.time()
    wall = t_end - t0
    b, n = cfg.train.batch_size, cfg.model.subsample_size
    steps = len(train_ids) // b
    epoch_secs = [t["epoch_seconds"] for t in train_losses]
    median = float(np.median(epoch_secs)) if epoch_secs else float("nan")
    gts = np.array([[dataset[i]["coverages"][j] for j in (0, 2, 3)] for i in val_ids])
    cuda = dev.type == "cuda"
    try:  # the last eval draws a figure a val plot where matplotlib imports
        import matplotlib  # noqa: F401

        figures = True
    except ImportError:
        figures = False
    summary = {
        "fold": fold,
        "resumed": resume,
        "epochs_run": len(train_losses),
        "wall_seconds": wall,
        "median_epoch_seconds": median,
        "train_points_per_sec": b * n * steps / median,
        "final_val_MAE": float(test_losses[-1]["MAE_loss"]) if test_losses else None,
        "mean_baseline_MAE": float(np.abs(gts - gts.mean()).mean()),
        "first_train_MAE": float(train_losses[0]["MAE_loss"]) if train_losses else None,
        "last_train_MAE": float(train_losses[-1]["MAE_loss"]) if train_losses else None,
        "killed_after_epoch": killed_after,
        "resumed_from_epoch": train_losses[0]["epoch"] if train_losses else None,
        "last_epoch": train_losses[-1]["epoch"] if train_losses else None,
        "train_batches": steps * len(train_losses),
        "evals": len(test_losses),
        "eval_batches": len(test_losses) * -(-len(val_ids) // b),
        "launches": ck.launch_counts(),
        "graphs": ck.graph_counts(),
        "figures": figures,
        "seconds_split": time_split(_records(metrics_path, offset)[0], fold, t0, t_end),
        "peak_allocated_mb": torch.cuda.max_memory_allocated(dev) / 2**20 if cuda else None,
        "peak_reserved_mb": torch.cuda.max_memory_reserved(dev) / 2**20 if cuda else None,
        "B": b,
        "N": n,
        "train_plots": len(train_ids),
        "val_plots": len(val_ids),
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
    }
    mode = "a" if resume else "w"
    with open(os.path.join(root, f"fold{fold}_summary.json"), mode) as f:
        f.write(json.dumps(summary) + "\n")
    with open(os.path.join(root, f"fold{fold}_losses.jsonl"), mode) as f:
        f.write(json.dumps({"resumed": resume, "train": train_losses, "test": test_losses},
                           default=float) + "\n")
    print("FOLD_SUMMARY " + json.dumps(summary), flush=True)
    return summary


def last_summary(root: str, fold: int) -> Dict:
    recs, _ = _records(os.path.join(root, f"fold{fold}_summary.json"))
    return recs[-1]


def child_args(ns: argparse.Namespace, root: str, fold: int, resume: bool = False) -> List[str]:
    """The command line of a child running `fold` under `ns`'s flags."""
    args = [sys.executable, os.path.abspath(__file__), "--root", root, "--fold", str(fold),
            "--plots", str(ns.plots), "--points", str(ns.points), "--n_epoch", str(ns.n_epoch),
            "--device", ns.device]
    for flag in ("batch", "subsample", "n_epoch_test"):
        if getattr(ns, flag):
            args += [f"--{flag}", str(getattr(ns, flag))]
    return args + (["--resume"] if resume else [])


@contextlib.contextmanager
def child(ns: argparse.Namespace, root: str, fold: int,
          resume: bool = False) -> Iterator[subprocess.Popen]:
    """A child process running `fold`, killed on the way out if it still
    runs, so that no child outlives its caller."""
    proc = subprocess.Popen(child_args(ns, root, fold, resume))
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_child(ns: argparse.Namespace, root: str, fold: int, resume: bool = False,
              timeout: float = TIMEOUT_SECONDS) -> Dict:
    """Run `fold` in a child to its end and return its summary, with the
    child's seconds from its start to its exit (`process_seconds`); raises
    if the child fails or outlasts `timeout` seconds."""
    what = f"fold {fold}" + (" (resumed)" if resume else "")
    t0 = time.time()
    with child(ns, root, fold, resume) as proc:
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{what} still running after {timeout} s") from None
    print(f"{what} exit code {rc}", flush=True)
    if rc != 0:
        raise RuntimeError(f"{what} exited with code {rc}")
    return dict(last_summary(root, fold), process_seconds=time.time() - t0)


def wait_for_epoch(metrics_path: str, fold: int, epoch: int, proc: subprocess.Popen,
                   timeout: float, offset: int = 0) -> bool:
    """Poll the metric sink from byte `offset` on, every POLL_SECONDS, until
    the fold's train record of `epoch` or a later one appears (True) or the
    child exits (False); raises after `timeout` seconds."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc.poll() is not None:
            return False
        recs, offset = _records(metrics_path, offset)
        if any(r["epoch"] >= epoch for r in _train_records(recs, fold)):
            return True
        time.sleep(POLL_SECONDS)
    raise RuntimeError(f"fold {fold} did not reach epoch {epoch} in {timeout} s")


def orchestrate(ns: argparse.Namespace, timeout: float = TIMEOUT_SECONDS) -> List[Dict]:
    """Spawn fold 1, SIGTERM it once it has finished `ns.kill_after` epochs
    (default max(25, n_epoch // 6): past two evals), resume it with
    `--resume` in a new process, then run fold 2. Returns a record of each
    run: the killed one's (exit code, epochs, seconds) and the two
    summaries. Raises when fold 1 ends before the kill, when the kill lands
    after its last epoch, when the resume reads no `.resume` checkpoint or
    when a child fails.

    SIGTERM, not SIGKILL, as the JAX orchestrator sends; Python's default
    disposition of SIGTERM still dies without running atexit or finally
    blocks, so the resume path is exercised as a crash."""
    root = ns.root
    build_dataset(root, ns.plots, ns.points)
    kill_after = ns.kill_after or max(2 * 10 + 5, ns.n_epoch // 6)
    if kill_after >= ns.n_epoch:
        raise ValueError(f"--kill_after {kill_after} is not before the last epoch {ns.n_epoch}")
    metrics = os.path.join(root, "fold1", "metrics.jsonl")
    offset = os.path.getsize(metrics) if os.path.exists(metrics) else 0
    t0 = time.time()
    with child(ns, root, 1) as proc:
        if not wait_for_epoch(metrics, 1, kill_after, proc, timeout, offset):
            raise RuntimeError(f"fold 1 ended (exit code {proc.returncode}) before epoch "
                               f"{kill_after}: the kill never landed")
        print(f"KILLING fold-1 run (pid {proc.pid}) past epoch {kill_after}", flush=True)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout)
    epochs = train_epochs(metrics, 1, offset)
    killed = {"fold": 1, "run": "killed", "exit_code": rc, "epochs_run": len(epochs),
              "killed_after_epoch": epochs[-1], "wall_seconds": time.time() - t0}
    if rc != -signal.SIGTERM or epochs[-1] >= ns.n_epoch:
        raise RuntimeError(f"fold 1 was not killed mid-schedule: exit code {rc}, last epoch "
                           f"{epochs[-1]} of {ns.n_epoch}")
    resumed = run_child(ns, root, 1, resume=True, timeout=timeout)
    start = resumed["resumed_from_epoch"]
    if resumed["killed_after_epoch"] != epochs[-1] or not 1 < start <= epochs[-1] + 1:
        raise RuntimeError(f"fold 1 resumed from epoch {start} after a kill past epoch "
                           f"{epochs[-1]} (it read {resumed['killed_after_epoch']}): "
                           "no .resume checkpoint was read")
    fold2 = run_child(ns, root, 2, timeout=timeout)
    return [killed, dict(resumed, run="resumed"), dict(fold2, run="first")]


def cross_validate(ns: argparse.Namespace, folds: Sequence[int],
                   timeout: float = TIMEOUT_SECONDS) -> Dict:
    """Each fold of `folds` in a child of its own, one after the other;
    prints and returns the folds' val MAE and baselines with their means
    and (population) standard deviations."""
    build_dataset(ns.root, ns.plots, ns.points)
    runs = [run_child(ns, ns.root, fold, timeout=timeout) for fold in folds]
    mae = [r["final_val_MAE"] for r in runs]
    base = [r["mean_baseline_MAE"] for r in runs]
    cv = {"folds": list(folds), "val_MAE": mae, "baseline_MAE": base,
          "val_MAE_mean": float(np.mean(mae)), "val_MAE_std": float(np.std(mae)),
          "baseline_MAE_mean": float(np.mean(base)), "baseline_MAE_std": float(np.std(base)),
          "epochs_run": [r["epochs_run"] for r in runs],
          "wall_seconds": [r["wall_seconds"] for r in runs]}
    print(f"cross-validation MAE {cv['val_MAE_mean']:.4f} +- {cv['val_MAE_std']:.4f} vs "
          f"{cv['baseline_MAE_mean']:.4f} +- {cv['baseline_MAE_std']:.4f} mean baseline",
          flush=True)
    print("CV_SUMMARY " + json.dumps(cv), flush=True)
    return cv


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def compare_checkpoints(got_dir: str, want_dir: str, fold: int) -> Dict:
    """The fold's best and `.resume` checkpoints in `got_dir` against those
    in `want_dir`, bit for bit: params, BN buffers and optimizer state
    (Adam's moments and counts, the schedule's count) of each, and both
    files' metadata (the early-stopping state among it). A run without an
    eval before its last epoch writes no `.resume`: then neither dir may
    hold one."""
    from stratanet2_tpu_torch.utils import checkpoint as ckpt

    name = ckpt.checkpoint_name(fold)
    tensors, differing, max_diff, metadata_equal = 0, [], 0.0, True
    for label, file in (("best", name), ("resume", name + ".resume")):
        paths = [os.path.join(d, file) for d in (got_dir, want_dir)]
        held = [os.path.exists(p) for p in paths]
        if label == "resume" and held == [False, False]:
            continue
        if not all(held):
            differing.append(f"{label}: {file} missing from one run")
            continue
        got, want = (ckpt.load_checkpoint(p) for p in paths)
        metadata_equal &= got["metadata"] == want["metadata"]
        for key in ("params", "model_state", "opt_state"):
            lg, lw = list(_leaves(got[key])), list(_leaves(want[key]))
            if [p for p, _ in lg] != [p for p, _ in lw]:
                raise ValueError(f"{label} {key}: the two checkpoints' trees differ")
            for (path, x), (_, y) in zip(lg, lw):
                tensors += 1
                if not (x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)):
                    differing.append(f"{label}:{key}{path}")
                if x.shape == y.shape and x.size:
                    max_diff = max(max_diff, float(np.abs(
                        x.astype(np.float64) - y.astype(np.float64)).max()))
    return {"tensors": tensors, "differing_tensors": len(differing),
            "differing": differing[:8], "max_abs_diff": max_diff,
            "metadata_equal": bool(metadata_equal)}


def loss_differences(got_train: List[Dict], want_train: List[Dict], got_test: List[Dict],
                     want_test: List[Dict]) -> List[float]:
    """|got - want| of every loss part and step of each pair of train dicts
    and of eval dicts, in order."""
    from stratanet2_tpu_torch.learning.evaluate import LOSS_KEYS
    from stratanet2_tpu_torch.learning.train import TRAIN_LOSS_KEYS

    pairs = ([(g, w, TRAIN_LOSS_KEYS) for g, w in zip(got_train, want_train)]
             + [(g, w, LOSS_KEYS) for g, w in zip(got_test, want_test)])
    return [abs(g[k] - w[k]) for g, w, keys in pairs for k in (*keys, "step")]


def compare_runs(resumed_root: str, unbroken_root: str, fold: int) -> Dict:
    """A killed-and-resumed fold (`resumed_root`) against an unbroken run of
    the same fold (`unbroken_root`), bit for bit: both checkpoints
    (`compare_checkpoints`), and the loss parts and step of every epoch and
    every eval the resumed run ran, against the unbroken run's of the same
    epochs."""
    cmp = compare_checkpoints(os.path.join(resumed_root, f"fold{fold}"),
                              os.path.join(unbroken_root, f"fold{fold}"), fold)
    (got,) = [r for r in _records(os.path.join(resumed_root, f"fold{fold}_losses.jsonl"))[0]
              if r["resumed"]][-1:]
    want = _records(os.path.join(unbroken_root, f"fold{fold}_losses.jsonl"))[0][-1]
    start = got["train"][0]["epoch"]
    want_train = [d for d in want["train"] if d["epoch"] >= start]
    want_test = want["test"][len(want["test"]) - len(got["test"]):]
    epochs_match = ([d["epoch"] for d in got["train"]] == [d["epoch"] for d in want_train]
                    and [d["epoch"] for d in got["test"]] == [d["epoch"] for d in want_test])
    diffs = loss_differences(got["train"], want_train, got["test"], want_test)
    return {**cmp, "epochs_match": bool(epochs_match),
            "train_epochs_compared": len(got["train"]), "evals_compared": len(got["test"]),
            "loss_values_compared": len(diffs),
            "differing_losses": sum(d != 0 for d in diffs),
            "loss_max_abs_diff": max(diffs, default=0.0),
            "resumed_from_epoch": start}


def same_run(cmp: Dict) -> bool:
    """Whether `compare_runs` found the two runs equal bit for bit."""
    return (cmp["tensors"] > 0 and cmp["differing_tensors"] == 0 and cmp["metadata_equal"]
            and cmp["epochs_match"] and cmp["loss_values_compared"] > 0
            and cmp["differing_losses"] == 0)


def parse_folds(text: str) -> List[int]:
    """'1-5' -> [1, 2, 3, 4, 5]; '1,3' -> [1, 3]."""
    folds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        folds += range(int(lo), int(hi or lo) + 1)
    return folds


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="folder of the data, folds and summaries")
    ap.add_argument("--fold", type=int, help="run this fold in this process")
    ap.add_argument("--resume", action="store_true",
                    help="continue the fold from its .resume checkpoint")
    ap.add_argument("--orchestrate", action="store_true",
                    help="fold 1 killed by SIGTERM and resumed, then fold 2")
    ap.add_argument("--folds", help="run these folds, a process each (e.g. 1-5)")
    ap.add_argument("--plots", type=int, default=110)
    ap.add_argument("--points", type=int, default=12000, help="points a plot")
    ap.add_argument("--batch", type=int, default=0, help="batch size (0 = PROD's 20)")
    ap.add_argument("--subsample", type=int, default=0,
                    help="points a cloud is subsampled to (0 = PROD's 10,000)")
    ap.add_argument("--n_epoch", type=int, default=300)
    ap.add_argument("--n_epoch_test", type=int, default=0,
                    help="epochs between evals before early stopping starts (0 = PROD's 10)")
    ap.add_argument("--kill_after", type=int, default=0,
                    help="epochs fold 1 finishes before the kill (0 = max(25, n_epoch // 6))")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ns = parse_args(argv)
    if ns.orchestrate:
        orchestrate(ns)
    elif ns.folds:
        cross_validate(ns, parse_folds(ns.folds))
    elif ns.fold:
        build_dataset(ns.root, ns.plots, ns.points)
        run_fold(ns.root, ns.fold, ns.resume, ns)
    else:
        raise SystemExit("one of --fold, --folds and --orchestrate is required")


if __name__ == "__main__":
    main()
