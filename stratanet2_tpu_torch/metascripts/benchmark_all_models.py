"""Offline model benchmark (copy of
`stratanet2_tpu/metascripts/benchmark_all_models.py`, reference
metascripts/benchmark_all_models.py): glob cross-validation result CSVs,
recompute the V1/V2/V3 indicator families on each, and write one benchmark
CSV of per-model means. Result files under a `/DEV/` folder or named
"(copie)" are skipped, as JAX's are."""

from __future__ import annotations

import glob
import os
import sys
import time
from argparse import ArgumentParser
from typing import TYPE_CHECKING

from stratanet2_tpu_torch.learning import metrics as M

if TYPE_CHECKING:
    import pandas as pd


def format_cols(df: "pd.DataFrame") -> "pd.DataFrame":
    """Normalize historical result-file column names and units
    (benchmark_all_models.py:44-80 / utils/load_data.py:264-303)."""
    import pandas as pd

    mapper = {
        "nom": "pl_id",
        "COUV BASSE": "vt_veg_b",
        "COUV INTER": "vt_veg_moy",
        "COUV HAUTE": "vt_veg_h",
        "couverture basse calibree": "pred_veg_b",
        "couverture inter calibree": "pred_veg_moy",
        "Taux de couverture haute lidar": "pred_veg_h",
    }
    df = df.rename(mapper, axis=1)
    cols = ["pl_id", "vt_veg_b", "vt_veg_moy", "vt_veg_h",
            "pred_veg_b", "pred_veg_moy", "pred_veg_h"]
    missing = [c for c in cols if c not in df]
    if missing:
        raise ValueError(f"missing columns {missing}, have {list(df)}")
    df = df[cols].copy()
    if df["vt_veg_b"].astype(float).max() > 1:
        df[["vt_veg_b", "vt_veg_moy", "vt_veg_h"]] = (
            df[["vt_veg_b", "vt_veg_moy", "vt_veg_h"]].astype(float) / 100
        )
    # per column: a mixed file (one percent-string column, two numeric-ratio
    # columns) must not get its numeric columns divided by 100 again
    for c in ("pred_veg_b", "pred_veg_moy", "pred_veg_h"):
        if pd.api.types.is_numeric_dtype(df[c]):
            continue
        if df[c].astype(str).str.contains("%").any():
            df[c] = df[c].map(lambda x: float(str(x).replace("%", "")) / 100)
        else:
            sys.exit(f"ERROR: UNKNOWN CASE (non-numeric column {c} without %)")
    return df


def benchmark(lookup_expression: str, benchmark_file_path: str) -> "pd.DataFrame":
    import pandas as pd

    paths = sorted(
        f
        for f in glob.glob(lookup_expression, recursive=True)
        if "(copie)" not in f and "/DEV/" not in f
    )
    if not paths:
        sys.exit(f"No result file found via regex {lookup_expression}")
    means, names = [], []
    for fname in paths:
        df = format_cols(pd.read_csv(fname))
        try:
            df = M.calculate_performance_indicators_v1(df)
            df = M.calculate_performance_indicators_v2(df)
            df = M.calculate_performance_indicators_v3(df)
            means.append(df.mean(numeric_only=True))
            names.append(fname.replace(".csv", ""))
        except KeyError:
            print(f"{fname}: ground truths are not discrete, skipped")
    out = pd.DataFrame(means, index=names).reset_index().sort_values(
        "index", ascending=False
    )
    os.makedirs(os.path.dirname(benchmark_file_path) or ".", exist_ok=True)
    out.to_csv(benchmark_file_path, index=False)
    print(f"Benchmark written to {benchmark_file_path}")
    return out


def main(argv=None):
    p = ArgumentParser(description="describe_perf")
    p.add_argument(
        "--results_files_lookup_expression",
        default="experiments/**/*placettes*.csv",
    )
    p.add_argument(
        "--benchmark_file_path",
        default=f"experiments/benchmarks/models_benchmark_at_{time.strftime('%Y-%m-%d_%Hh%Mm%Ss')}.csv",
    )
    ns, _ = p.parse_known_args(argv)
    return benchmark(ns.results_files_lookup_expression, ns.benchmark_file_path)


if __name__ == "__main__":
    main()
