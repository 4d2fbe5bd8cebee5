"""Self-supervised pretraining entry point (reference main_SSL.py), a copy of
`stratanet2_tpu/cli/main_ssl.py` on `--device` (default CUDA): train on
model-generated pseudo-labels from `predict --task pseudo_labelling`.

Schedule overrides per main_SSL.py:46-52 (200 epochs, eval every epoch,
lr decay 0.75, and the early-stop knobs start-epoch 1 / patience 10 —
which, exactly as in the reference, only take effect when
--use_early_stopping is passed: config.py:91 defaults it off and
main_SSL.py never flips it), single train/val split with up to 20%/100
validation plots (main_SSL.py:70-74), fold_id = -1 ("full" checkpoint
name).

Usage: python -m stratanet2_tpu_torch.cli.main_ssl --inference_model_id ID ...
"""

from __future__ import annotations

import sys
from dataclasses import replace

from stratanet2_tpu_torch.cli import log_sa_route, log_kernel_launches
from stratanet2_tpu_torch.config import parse_config
from stratanet2_tpu_torch.data.dataset import (
    get_index_sorted_plot_ids,
    load_pseudo_labelled_datasets,
)
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.learning.crossval import (
    log_last_stats_of_fold,
    post_cross_validation_logging,
    stats_for_all_folds,
)
from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
from stratanet2_tpu_torch.learning.train import train_full
from stratanet2_tpu_torch.utils.experiment import (
    MetricSink,
    create_logger,
    setup_experiment_folder,
)


def main(argv=None):
    cfg, ns = parse_config(argv)
    device = resolve_device(ns.device)
    dev = cfg.mode == "DEV"
    # SSL schedule defaults (main_SSL.py:46-52); CLI overrides still win.
    overrides = dict(
        n_epoch=200 if not dev else 2,
        n_epoch_test=1,
        epoch_to_start_early_stop=1,
        patience_in_epochs=10 if not dev else 1,
        lr_decay=0.75,
    )
    provided = {k for k in overrides if getattr(ns, k, None) is not None}
    cfg = replace(
        cfg,
        train=replace(
            cfg.train, **{k: v for k, v in overrides.items() if k not in provided}
        ),
    )

    stats_path = setup_experiment_folder(cfg.experiments_path, "pretraining", cfg.mode)
    logger = create_logger(stats_path)
    sink = MetricSink(stats_path)
    log_sa_route(cfg.model, logger)

    logger.info("Loading pseudo-labelled data...")
    assert ns.inference_model_id, "--inference_model_id required (pseudo-label source)"
    dataset = load_pseudo_labelled_datasets(cfg, ns.inference_model_id)
    n_plots = len(dataset)
    logger.info("Training on N=%d pseudo-labeled plots.", n_plots)

    kde = fit_kde_mixture_from_dataset(dataset)

    plot_ids = get_index_sorted_plot_ids(dataset)
    n_val = min(int(0.2 * n_plots), 100)
    train_ids, val_ids = plot_ids[: n_plots - n_val], plot_ids[n_plots - n_val :]

    fold_id = -1
    _, train_losses, test_losses, cloud_infos = train_full(
        dataset, train_ids, val_ids, cfg, kde, stats_path, sink,
        fold_id=fold_id, seed=cfg.train.seed, device=device,
    )
    log_last_stats_of_fold(train_losses, test_losses, fold_id)
    stats_for_all_folds([train_losses], [test_losses], sink)
    post_cross_validation_logging(
        "pretraining_summary", {fold_id: cloud_infos}, cfg, stats_path, sink
    )
    log_kernel_launches(logger)
    sink.close()
    logger.info("Pretrained checkpoint saved under %s", stats_path)
    return stats_path


if __name__ == "__main__":
    main(sys.argv[1:])
