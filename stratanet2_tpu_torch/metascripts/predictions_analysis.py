"""Offline predictions analysis (copy of
`stratanet2_tpu/metascripts/predictions_analysis.py`, reference
metascripts/predictions_analysis.py): re-score a cross-validation result
CSV; emit confusion matrices (3 normalizations, raw and 10pp-margin-
adjusted), the signed-error correlation between the low and medium strata,
and forest / non-forest subsets split at vt_veg_h >= 0.90.

The confusion matrices need sklearn and matplotlib. Where either is
missing they are skipped with a warning and the rest of the analysis runs
(JAX's `analyse` stops there with an ImportError).
"""

from __future__ import annotations

import logging
import os
from argparse import ArgumentParser

from stratanet2_tpu_torch.learning import metrics as M
from stratanet2_tpu_torch.metascripts.benchmark_all_models import format_cols

logger = logging.getLogger("stratanet2_tpu_torch")


def _confusion_matrices(df, out_dir: str, name_prefix: str = "confusion") -> None:
    """`metrics.log_confusion_matrices` for the three normalizations, or a
    warning where sklearn or matplotlib is missing."""
    try:
        import matplotlib  # noqa: F401
        import sklearn  # noqa: F401
    except ImportError as err:
        logger.warning("confusion matrices %s skipped: %s", out_dir, err)
        return
    for normalize in ("true", "all", "pred"):
        M.log_confusion_matrices(df, out_dir, normalize=normalize, name_prefix=name_prefix)


def analyse(results_file: str, out_dir: str) -> dict:
    import pandas as pd
    from scipy import stats

    df = pd.read_csv(results_file)
    if "acc2_veg_b" not in df:
        df = format_cols(df)
        try:
            df = M.calculate_performance_indicators_v1(df)
            df = M.calculate_performance_indicators_v2(df)
            df = M.calculate_performance_indicators_v3(df)
        except KeyError:
            # reference predictions_analysis.py:58-66: continuous (non
            # class-center) ground truths cannot yield class-based
            # indicators — continue to the confusion matrices, which snap
            # continuous GT to the nearest class center
            print(
                "Cannot calculate class-based performance indicators due "
                "to continuous ground truths."
            )

    os.makedirs(out_dir, exist_ok=True)
    _confusion_matrices(df, os.path.join(out_dir, "confusion"))

    # signed-error anticorrelation between Vb and Vm
    # (predictions_analysis.py:74-88); needs the class-based error2
    # columns, which continuous GT could not produce above
    if "error2_veg_b" not in df:
        print("skipping signed-error / margin studies (no class indicators)")
        return {"n": len(df)}
    signed_b = df["error2_veg_b"] * 2 * ((df["pred_veg_b"] >= df["vt_veg_b"]) - 0.5)
    signed_m = df["error2_veg_moy"] * 2 * ((df["pred_veg_moy"] >= df["vt_veg_moy"]) - 0.5)
    r, pvalue = stats.pearsonr(signed_b, signed_m)
    print(f"signed-error pearson r={r:.4f} p={pvalue:.4g}")

    df_margin = M.adjust_predictions_based_on_margin(df)
    _confusion_matrices(df_margin, os.path.join(out_dir, "confusion_10pp"), "confusion_10pp")

    # forest / non-forest subsets (predictions_analysis.py:103-123)
    subsets = {
        "FORESTNONE": df_margin[df_margin["vt_veg_h"] < 0.90],
        "FOREST": df_margin[df_margin["vt_veg_h"] >= 0.90],
    }
    for tag, sub in subsets.items():
        if len(sub) == 0:
            continue
        _confusion_matrices(sub, os.path.join(out_dir, tag), f"{tag}_confusion_10pp")
    return {"pearson_r": float(r), "pvalue": float(pvalue), "n": len(df)}


def main(argv=None):
    p = ArgumentParser(description="predictions_analysis")
    p.add_argument("--results_file", required=True)
    p.add_argument("--out_dir", default="")
    ns, _ = p.parse_known_args(argv)
    out_dir = ns.out_dir or os.path.join(
        os.path.dirname(ns.results_file), "analyses", "predictions_analysis"
    )
    return analyse(ns.results_file, out_dir)


if __name__ == "__main__":
    main()
