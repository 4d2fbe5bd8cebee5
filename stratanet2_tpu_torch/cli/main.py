"""Cross-validated training entry point (reference main.py), a copy of
`stratanet2_tpu/cli/main.py` on `--device` (default CUDA).

Usage: python -m stratanet2_tpu_torch.cli.main --mode DEV --las_plots_folder_path ...
"""

from __future__ import annotations

import os
import sys

from stratanet2_tpu_torch.cli import log_ignored_flags, log_kernel_launches
from stratanet2_tpu_torch.config import parse_config
from stratanet2_tpu_torch.data.dataset import prepare_and_save_plots_dataset
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.learning.crossval import cross_validate
from stratanet2_tpu_torch.learning.kde import (
    fit_kde_mixture_from_dataset,
    plot_kde_mixture,
)
from stratanet2_tpu_torch.utils.experiment import (
    MetricSink,
    create_logger,
    setup_experiment_folder,
)


def main(argv=None):
    cfg, ns = parse_config(argv)
    device = resolve_device(ns.device)
    stats_path = setup_experiment_folder(cfg.experiments_path, "learning", cfg.mode)
    logger = create_logger(stats_path)
    sink = MetricSink(stats_path)
    sink.log_parameters({"cfg": str(cfg)})
    logger.info("cfg: %s", cfg)
    log_ignored_flags(ns, logger)

    dataset = prepare_and_save_plots_dataset(cfg, cfg.data.corrected_gt_file_path)
    if not dataset:
        raise SystemExit(
            f"No plots found: no .las files in {cfg.data.las_plots_folder_path} "
            f"matching names in {cfg.data.corrected_gt_file_path}"
        )
    logger.info("Dataset contains %d plots.", len(dataset))

    kde = fit_kde_mixture_from_dataset(dataset)
    for x_lim in (3, 25):
        plot_kde_mixture(
            kde,
            os.path.join(stats_path, f"img/kde_mixture/kde_mixture_x_lim={x_lim}.png"),
            x_lim=x_lim,
        )

    # warm start from an SSL-pretrained checkpoint (--PT_model_id,
    # reference learning/train.py:212-223)
    pretrained_path = None
    if ns.PT_model_id:
        from stratanet2_tpu_torch.utils.checkpoint import find_checkpoint_by_experiment

        pretrained_path = find_checkpoint_by_experiment(cfg.experiments_path, ns.PT_model_id)
        logger.info("Warm-starting from pretrained model %s", pretrained_path)

    cross_validate(
        dataset, cfg, kde, stats_path, sink,
        pretrained_path=pretrained_path, device=device,
    )
    log_kernel_launches(logger)
    sink.close()
    return stats_path


if __name__ == "__main__":
    main(sys.argv[1:])
