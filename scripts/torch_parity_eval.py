"""Coverage-MAE parity evaluation of a *reference* PyTorch checkpoint on the
PyTorch port (counterpart of `scripts/parity_eval.py`).

Given an archived reference checkpoint (PCC_model_*.pt from
IGNF/StrataNet2-Vegetation-Coverage-Maps) plus plot LAS files and the GT
CSV, imports the weights (`utils/torch_import.load_reference_checkpoint`),
runs the port's evaluation pipeline (`learning/kde`,
`learning/train.make_eval_step`, `learning/evaluate.evaluate`) on
`--device` (default cuda), and prints the per-stratum MAEs and the
indicator families of `learning/metrics`, with the per-plot results in
`parity_eval.csv` of a new experiment folder.

pandas is imported in `main`. Without it the MAEs are still printed, and a
line of their own says that the indicator families and the CSV were
skipped, and why. For continuous ground truth the class-based families
(v2, v3) are skipped with a log line, as the JAX script does.

Usage:
  python3 scripts/torch_parity_eval.py --checkpoint PCC_model_full.pt \\
      --las_plots_folder_path .../las_classes --gt_file_path .../metadata.csv \\
      [--device cpu]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

MEAN_KEYS = ("MAE_veg_b", "MAE_veg_moy", "MAE_veg_h", "MAE_loss", "total_loss")
INDICATORS = ("error_all", "acc_all", "error2_all", "acc2_all")


def indicator_table(summaries: List[Dict], logger) -> Tuple[object, Optional[str]]:
    """(the per-plot DataFrame with the indicator families, None), or (None,
    the reason) where pandas does not import."""
    from stratanet2_tpu_torch.learning import metrics as M

    try:
        import pandas as pd
    except ImportError as err:
        return None, f"{type(err).__name__}: {err}"
    df = M.calculate_performance_indicators_v1(pd.DataFrame(summaries))
    try:
        df = M.calculate_performance_indicators_v2(df)
        df = M.calculate_performance_indicators_v3(df)
    except KeyError:
        logger.info("continuous GT: class indicators skipped")
    return df, None


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Evaluate the checkpoint; returns {"means", "indicators" (column ->
    mean), "csv", "skipped" (why the indicators were skipped, or None),
    "plots", "launches", "device"}."""
    from argparse import ArgumentParser

    import numpy as np

    from stratanet2_tpu_torch.config import parse_config
    from stratanet2_tpu_torch.data.dataset import prepare_and_save_plots_dataset
    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.learning.evaluate import evaluate
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from stratanet2_tpu_torch.learning.train import make_eval_step
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.utils.experiment import (
        MetricSink,
        create_logger,
        setup_experiment_folder,
    )
    from stratanet2_tpu_torch.utils.torch_import import load_reference_checkpoint

    ap = ArgumentParser(add_help=False)
    ap.add_argument("--checkpoint", required=True)
    ns, _ = ap.parse_known_args(argv)
    cfg, flags = parse_config(argv)
    dev = resolve_device(flags.device)

    stats_path = setup_experiment_folder(cfg.experiments_path, "parity_eval", cfg.mode)
    logger = create_logger(stats_path)
    sink = MetricSink(stats_path)
    try:
        dataset = prepare_and_save_plots_dataset(cfg, cfg.data.corrected_gt_file_path)
        logger.info("Evaluating reference checkpoint on %d plots", len(dataset))
        model = load_reference_checkpoint(ns.checkpoint, cfg.model, dev)
        kde = fit_kde_mixture_from_dataset(dataset)
        eval_step = make_eval_step(cfg, kde, dev)

        ids = sorted(dataset.keys())
        before = ck.launch_counts()
        means, summaries = evaluate(
            model, dataset, np.array(ids), cfg, kde, eval_step, stats_path, sink,
            fold_id=-1, epoch=0, last_epoch=True, device=dev,
        )
        launches = {k: v - before[k] for k, v in ck.launch_counts().items()}
    finally:
        sink.close()
    df, skipped = indicator_table(summaries, logger)
    out_csv = None
    if df is not None:
        out_csv = os.path.join(stats_path, "parity_eval.csv")
        df.to_csv(out_csv, index=False)

    print("\n=== reference-checkpoint parity evaluation ===")
    for key in MEAN_KEYS:
        print(f"{key:14s} {means[key]:.4f}")
    indicators = {}
    if df is None:
        print(f"indicator families and per-plot CSV skipped: {skipped}")
    else:
        for col in INDICATORS:
            if col in df:
                indicators[col] = float(df[col].mean())
                print(f"{col:14s} {indicators[col]:.4f}")
        print(f"per-plot results: {out_csv}")
    print(f"device {dev}; kernel launches: {launches}", flush=True)
    return {"means": means, "indicators": indicators, "csv": out_csv, "skipped": skipped,
            "plots": len(summaries), "launches": launches, "device": str(dev)}


if __name__ == "__main__":
    main(sys.argv[1:])
