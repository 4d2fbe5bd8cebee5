"""Coverage-class metrics and cross-validation analytics.

Same class system and indicator families as the reference
(learning/accuracy.py): coverage classes centered at
[0, .10, .25, .33, .50, .75, .90, 1.0] with borders at midpoints (:13-42);
three MAE variants (exact :77-82; distance-to-class-borders :85-93;
distance-to-neighbor-class-borders :96-106) and three accuracy variants
(:109-137). Implemented vectorized over arrays instead of pandas
`df.apply` per row.

A copy of `stratanet2_tpu/learning/metrics.py`. The DataFrame functions take
pandas frames from their callers; pandas, matplotlib and sklearn are
imported inside the functions that use them, not with the module.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

bins_centers = np.round(np.array([0.0, 0.10, 0.25, 0.33, 0.50, 0.75, 0.90, 1.00]), 3)
_borders = np.append((bins_centers[:-1] + bins_centers[1:]) / 2, 1.05)
# round half up to 2 decimals, matching accuracy.py:36
bins_borders = np.floor(_borders * 100 + 0.5) / 100
_bb = np.concatenate([[0.0], bins_borders])
# class i spans [_bb[i], _bb[i+1]]
CLASS_LOWER = _bb[:-1]
CLASS_UPPER = _bb[1:]

STRATA = ("veg_b", "veg_moy", "veg_h")


def closest_class_center_index(y) -> np.ndarray:
    """Index of the nearest class center (accuracy.py:45-48), vectorized."""
    y = np.asarray(y, np.float64)
    return np.argmin(np.abs(bins_centers[None, :] - y.reshape(-1, 1)), axis=1).reshape(
        y.shape
    )


def closest_class_center(y) -> np.ndarray:
    return bins_centers[closest_class_center_index(y)]


def _class_bounds(y: np.ndarray):
    """Lower/upper border of the class whose center is y (y must be a center)."""
    idx = closest_class_center_index(y)
    return CLASS_LOWER[idx], CLASS_UPPER[idx]


def _neighbor_external_bounds(y: np.ndarray):
    """Outer borders of the neighbor classes (accuracy.py:58-73)."""
    idx = closest_class_center_index(y)
    lo_idx = np.maximum(idx - 1, 0)
    hi_idx = np.minimum(idx + 1, len(bins_centers) - 1)
    return CLASS_LOWER[lo_idx], CLASS_UPPER[hi_idx]


def mae(y_pred, y):
    return np.abs(np.asarray(y_pred) - np.asarray(y))


def mae2(y_pred, y):
    """Distance to the GT class borders; 0 inside (accuracy.py:85-93)."""
    y_pred = np.asarray(y_pred, np.float64)
    lo, hi = _class_bounds(np.asarray(y, np.float64))
    return np.where(
        (lo <= y_pred) & (y_pred <= hi),
        0.0,
        np.minimum(np.abs(lo - y_pred), np.abs(hi - y_pred)),
    )


def mae3(y_pred, y):
    """Distance to the neighbor classes' outer borders (accuracy.py:96-106)."""
    y_pred = np.asarray(y_pred, np.float64)
    lo, hi = _neighbor_external_bounds(np.asarray(y, np.float64))
    return np.where(
        (lo <= y_pred) & (y_pred <= hi),
        0.0,
        np.minimum(np.abs(lo - y_pred), np.abs(hi - y_pred)),
    )


def accuracy(y_pred, y):
    y_pred = np.asarray(y_pred, np.float64)
    lo, hi = _class_bounds(np.asarray(y, np.float64))
    return ((lo <= y_pred) & (y_pred <= hi)).astype(np.int64)


def accuracy2(y_pred, y, margin: float = 0.1):
    y_pred = np.asarray(y_pred, np.float64)
    lo, hi = _class_bounds(np.asarray(y, np.float64))
    return ((lo - margin <= y_pred) & (y_pred <= hi + margin)).astype(np.int64)


def accuracy3(y_pred, y):
    y_pred = np.asarray(y_pred, np.float64)
    lo, hi = _neighbor_external_bounds(np.asarray(y, np.float64))
    return ((lo <= y_pred) & (y_pred <= hi)).astype(np.int64)


def _round_gt(df: pd.DataFrame) -> pd.DataFrame:
    cols = [f"vt_{s}" for s in STRATA]
    df[cols] = df[cols].astype(float).round(3)
    return df


def _gt_are_class_centers(df: pd.DataFrame) -> bool:
    """The reference's class-based indicators key a dict by the GT value and
    raise KeyError on continuous (non-relabeled) ground truths
    (accuracy.py:158-173, :481-484); we make the check explicit."""
    for s in STRATA:
        v = df[f"vt_{s}"].astype(float).round(3).values
        if not np.all(np.isin(v, bins_centers)):
            return False
    return True


def calculate_performance_indicators_v1(df: pd.DataFrame) -> pd.DataFrame:
    """MAE + in-class accuracy (accuracy.py:140-174)."""
    df = _round_gt(df)
    for s in STRATA:
        df[f"error_{s}"] = mae(df[f"pred_{s}"], df[f"vt_{s}"])
    df["error_veg_b_and_moy"] = df[["error_veg_b", "error_veg_moy"]].mean(axis=1)
    df["error_all"] = df[[f"error_{s}" for s in STRATA]].mean(axis=1)
    if _gt_are_class_centers(df):
        for s in STRATA:
            df[f"acc_{s}"] = accuracy(df[f"pred_{s}"].values, df[f"vt_{s}"].values)
        df["acc_veg_b_and_moy"] = df[["acc_veg_b", "acc_veg_moy"]].mean(axis=1)
        # reference quirk preserved: acc_all averages only veg_b & veg_moy
        # (accuracy.py:169)
        df["acc_all"] = df[["acc_veg_b", "acc_veg_moy"]].mean(axis=1)
    return df


def calculate_performance_indicators_v2(df: pd.DataFrame) -> pd.DataFrame:
    """MAE2 + accuracy2 with 10pp margin (accuracy.py:177-218)."""
    df = _round_gt(df)
    if not _gt_are_class_centers(df):
        raise KeyError("class-based indicators need class-center ground truths")
    for s in STRATA:
        df[f"error2_{s}"] = mae2(df[f"pred_{s}"].values, df[f"vt_{s}"].values)
        df[f"acc2_{s}"] = accuracy2(df[f"pred_{s}"].values, df[f"vt_{s}"].values)
    df["error2_veg_b_and_moy"] = df[["error2_veg_b", "error2_veg_moy"]].mean(axis=1)
    df["error2_all"] = df[[f"error2_{s}" for s in STRATA]].mean(axis=1)
    df["acc2_veg_b_and_moy"] = df[["acc2_veg_b", "acc2_veg_moy"]].mean(axis=1)
    df["acc2_all"] = df[[f"acc2_{s}" for s in STRATA]].mean(axis=1)
    return df


def calculate_performance_indicators_v3(df: pd.DataFrame) -> pd.DataFrame:
    """MAE3 + accuracy3 over neighbor classes (accuracy.py:221-262)."""
    df = _round_gt(df)
    if not _gt_are_class_centers(df):
        raise KeyError("class-based indicators need class-center ground truths")
    for s in STRATA:
        df[f"error3_{s}"] = mae3(df[f"pred_{s}"].values, df[f"vt_{s}"].values)
        df[f"acc3_{s}"] = accuracy3(df[f"pred_{s}"].values, df[f"vt_{s}"].values)
    df["error3_veg_b_and_moy"] = df[["error3_veg_b", "error3_veg_moy"]].mean(axis=1)
    # reference quirk preserved: error3_all mixes error2_veg_moy in
    # (accuracy.py:242)
    df["error3_all"] = df[["error3_veg_b", "error2_veg_moy", "error3_veg_h"]].mean(axis=1) \
        if "error2_veg_moy" in df else df[[f"error3_{s}" for s in STRATA]].mean(axis=1)
    df["acc3_veg_b_and_moy"] = df[["acc3_veg_b", "acc3_veg_moy"]].mean(axis=1)
    df["acc3_all"] = df[[f"acc3_{s}" for s in STRATA]].mean(axis=1)
    return df


def adjust_predictions_based_on_margin(df: pd.DataFrame) -> pd.DataFrame:
    """Snap predictions within 10pp of the target class border onto the GT
    (accuracy.py:265-273)."""
    out = df.copy()
    for s in STRATA:
        where = out[f"acc2_{s}"] == 1
        out.loc[where, f"pred_{s}"] = out.loc[where, f"vt_{s}"]
    return out


def compute_confusion_matrix(df: pd.DataFrame, strata: str, normalize: str = "true"):
    """8-class confusion matrix over coverage classes (accuracy.py:317-331)."""
    from sklearn.metrics import confusion_matrix

    y_true = closest_class_center_index(df[f"vt_{strata}"].values)
    y_pred = closest_class_center_index(df[f"pred_{strata}"].values)
    return confusion_matrix(
        y_true, y_pred, labels=range(len(bins_centers)), normalize=normalize
    )


def save_confusion_matrix_png(
    cm: np.ndarray, out_path: str, title: str = ""
) -> None:
    """Confusion matrix PNG artifact (accuracy.py:284-314)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.metrics import ConfusionMatrixDisplay

    labels = [f"{c:.0%}" for c in bins_centers]
    disp = ConfusionMatrixDisplay(confusion_matrix=cm, display_labels=labels)
    fig, ax = plt.subplots(1, 1, figsize=(8, 8))
    disp.plot(ax=ax, cmap=plt.get_cmap("Blues"), colorbar=False, values_format=".0%")
    ax.set_xlabel("Predicted coverage")
    ax.set_ylabel("Observed coverage")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=100, transparent=True)
    plt.close(fig)


def log_confusion_matrices(
    df: pd.DataFrame,
    out_dir: str,
    normalize: str = "true",
    name_prefix: str = "confusion",
    fold_id: int = 0,
    epoch: int = 0,
    qualified: bool = False,
) -> None:
    """``qualified=True`` appends fold/epoch to the filename. The reference
    uses a fold/epoch-free filename too (accuracy.py:294-309) but ALSO logs
    every save to Comet keyed by epoch — with a file-only sink, the bare
    name means every fold/epoch silently overwrites the previous matrices.
    Offline metascripts (one-shot, no fold) keep the bare reference name."""
    for s in STRATA:
        cm = compute_confusion_matrix(df, s, normalize=normalize)
        stem = f"{name_prefix}_{normalize}_{s}"
        fname = f"{stem}_fold_{fold_id}_ep_{epoch}.png" if qualified else f"{stem}.png"
        save_confusion_matrix_png(
            cm,
            os.path.join(out_dir, fname),
            title=f"{stem} [N={len(df)}]\n(fold={fold_id}|epoch={epoch})",
        )
