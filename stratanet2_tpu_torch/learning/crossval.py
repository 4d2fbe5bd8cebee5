"""Cross-validated training (counterpart of
`stratanet2_tpu/learning/crossval.py`, reference main.py:61-137) and the
post-cross-validation analytics (learning/accuracy.py:335-509).

The fold split is sklearn's `KFold(folds, shuffle=True, random_state=42)`
written out in numpy (`kfold_split`), and the statistics across folds are
computed on dicts, so the fold loop needs neither sklearn nor pandas;
`post_cross_validation_logging` imports pandas itself.
"""

from __future__ import annotations

import logging
import os
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data.dataset import (
    get_index_sorted_plot_ids,
    get_plot_ground_truth_coverages,
    load_ground_truths_dataframe,
)
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.learning import metrics as M
from stratanet2_tpu_torch.learning.kde import KdeMixture
from stratanet2_tpu_torch.learning.train import train_full
from stratanet2_tpu_torch.parallel import multihost

if TYPE_CHECKING:
    import pandas as pd

logger = logging.getLogger("stratanet2_tpu_torch")

KFOLD_SEED = 42  # the reference's KFold random_state


def kfold_split(n: int, folds: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train, test) indices of each fold over n items, as sklearn's
    `KFold(folds, shuffle=True, random_state=KFOLD_SEED).split` gives them
    (reference crossval.py): the items shuffled by
    `np.random.RandomState(KFOLD_SEED)`, folds of n // folds
    items with the first n % folds one larger, and both index arrays
    sorted."""
    if not 2 <= folds <= n:
        raise ValueError(f"cannot split {n} items into {folds} folds")
    order = np.arange(n)
    np.random.RandomState(KFOLD_SEED).shuffle(order)
    sizes = np.full(folds, n // folds)
    sizes[: n % folds] += 1
    splits = []
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start : start + size]] = True
        splits.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return splits


def cross_validate(
    dataset: Dict,
    cfg: Config,
    kde: KdeMixture,
    stats_path: str,
    sink,
    pretrained_path: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
    point_sharded: bool = False,
) -> Optional[pd.DataFrame]:
    """K-fold cross-validation on `device` (default CUDA; main.py:66-99),
    then two analytics passes: with class-center-snapped GT (main.py:102-117)
    and with the original GT (main.py:120-137). DEV runs one fold.

    `mesh` and `point_sharded` go to every fold's `train_full`
    (crossval.py:33-51). In a process group every rank trains; rank 0
    alone logs and writes the analytics, and the others return None."""
    dev = resolve_device(device)
    plot_ids = get_index_sorted_plot_ids(dataset)
    writer = multihost.is_writer()

    all_train, all_test = [], []
    cloud_info_by_fold: Dict[int, List[Dict]] = {}
    for fold_id, (train_idx, val_idx) in enumerate(
        kfold_split(len(plot_ids), cfg.train.folds), start=1
    ):
        logger.info("Cross-validation FOLD = %d", fold_id)
        if writer:
            sink.log_metric("Fold_ID", fold_id)
        _, train_losses, test_losses, cloud_infos = train_full(
            dataset, plot_ids[train_idx], plot_ids[val_idx],
            cfg, kde, stats_path, sink, fold_id=fold_id,
            pretrained_path=pretrained_path, seed=cfg.train.seed, device=dev,
            mesh=mesh, point_sharded=point_sharded,
        )
        log_last_stats_of_fold(train_losses, test_losses, fold_id)
        all_train.append(train_losses)
        all_test.append(test_losses)
        cloud_info_by_fold[fold_id] = cloud_infos
        if cfg.mode == "DEV" and fold_id >= 1:
            break
    if not writer:
        return None

    stats_for_all_folds(all_train, all_test, sink)

    # pass 1: relabeled GT (snap to class centers)
    for infos in cloud_info_by_fold.values():
        for info in infos:
            for key in ("vt_veg_b", "vt_sol_nu", "vt_veg_moy", "vt_veg_h"):
                info[key] = float(M.closest_class_center(info[key]))
    df_rel = post_cross_validation_logging(
        "relabeled_summary", cloud_info_by_fold, cfg, stats_path, sink
    )

    # pass 2: original GT from the uncorrected file (main.py:120-129)
    try:
        gts = load_ground_truths_dataframe(cfg.data.gt_file_path)
        for infos in cloud_info_by_fold.values():
            for info in infos:
                cov = get_plot_ground_truth_coverages(gts, info["pl_id"])
                (
                    info["vt_veg_b"], info["vt_sol_nu"],
                    info["vt_veg_moy"], info["vt_veg_h"],
                ) = [float(c) for c in cov]
        post_cross_validation_logging(
            "summary", cloud_info_by_fold, cfg, stats_path, sink
        )
    except (FileNotFoundError, KeyError, ValueError, TypeError) as err:
        # a plot missing from (empty coverages -> unpack ValueError) or
        # duplicated in (TypeError) the uncorrected GT file must skip this
        # analytics pass, not kill the run after all folds trained
        logger.warning("original-GT summary skipped: %s", err)
    return df_rel


def mean_by_step(rows: List[Dict]) -> Dict[int, Dict[str, float]]:
    """`pd.DataFrame(rows).groupby("step").mean().to_dict("index")` on
    dicts: for each step, in ascending order, each column's mean over that
    step's rows that have it with a value that is not NaN (NaN where none
    has one: pandas skips NaN), the columns in the order they first
    appear."""
    columns = list(dict.fromkeys(k for row in rows for k in row if k != "step"))
    out = {}
    for step in sorted({row["step"] for row in rows}):
        group = [row for row in rows if row["step"] == step]
        out[step] = {}
        for col in columns:
            values = [float(row[col]) for row in group if col in row]
            values = [v for v in values if not np.isnan(v)]
            out[step][col] = float(np.mean(values)) if values else float("nan")
    return out


def stats_for_all_folds(all_train: List[List[Dict]], all_test: List[List[Dict]], sink):
    """Per-step means across folds (accuracy.py:335-394)."""
    for name, lists in (("train_mean", all_train), ("val_mean", all_test)):
        rows = [d for fold in lists for d in fold]
        if not rows:
            continue
        by_step = mean_by_step(rows)
        with sink.context(name):
            for step, metrics in by_step.items():
                sink.log_metrics(metrics, epoch=int(metrics.get("epoch", 0)), step=int(step))
        last = by_step[max(by_step)]
        logger.info(
            "MEAN - %s Loss: %1.2f Loss Abs (MAE): %1.2f Loss Log: %1.2f",
            name, last["total_loss"], last["MAE_loss"], last["log_loss"],
        )


def log_last_stats_of_fold(train_losses, test_losses, fold_id: int):
    """(accuracy.py:398-430)"""
    for task, losses in (("Train", train_losses), ("Test", test_losses)):
        if not losses:
            continue
        last = max(losses, key=lambda d: d["epoch"])
        logger.info(
            "Fold %3d %s Loss: %1.2f Loss Abs (MAE): %1.2f Loss Log: %1.2f",
            fold_id, task, last["total_loss"], last["MAE_loss"], last["log_loss"],
        )


def post_cross_validation_logging(
    summary_context_name: str,
    cloud_info_by_fold: Dict[int, List[Dict]],
    cfg: Config,
    stats_path: str,
    sink,
) -> pd.DataFrame:
    """Indicator computation, CSV export and confusion matrices over all
    cross-validated predictions (accuracy.py:463-509)."""
    import pandas as pd

    rows = [
        dict(info, fold_id=fold_id)
        for fold_id, infos in cloud_info_by_fold.items()
        for info in infos
    ]
    df = pd.DataFrame(rows)
    try:
        df = M.calculate_performance_indicators_v1(df)
        df = M.calculate_performance_indicators_v2(df)
        df = M.calculate_performance_indicators_v3(df)
    except KeyError:
        logger.info(
            "Cannot calculate class-based performance indicators due to "
            "continuous ground truths."
        )

    csv_path = os.path.join(
        stats_path, f"PCC_inference_all_placettes_{summary_context_name}.csv"
    )
    df.to_csv(csv_path, index=False)
    logger.info("Saved inferred, cross-validated results to %s", csv_path)

    with sink.context(summary_context_name):
        sink.log_metrics(df.mean(numeric_only=True).to_dict())
        sink.log_table(csv_path)
        cm_dir = os.path.join(stats_path, "img", "confusion_matrices", summary_context_name)
        for normalize in ("true", "all", "pred"):
            try:
                M.log_confusion_matrices(df, cm_dir, normalize=normalize)
            except Exception as err:
                logger.warning("confusion matrices (%s) failed: %s", normalize, err)

    if "acc2_veg_b" in df:
        with sink.context(summary_context_name + "_with_margin"):
            df_margin = M.adjust_predictions_based_on_margin(df)
            cm_dir = os.path.join(
                stats_path, "img", "confusion_matrices", summary_context_name + "_margin"
            )
            for normalize in ("true", "all", "pred"):
                try:
                    M.log_confusion_matrices(
                        df_margin, cm_dir, normalize=normalize, name_prefix="confusion_10pp"
                    )
                except Exception as err:
                    logger.warning("margin confusion matrices failed: %s", err)
    return df
