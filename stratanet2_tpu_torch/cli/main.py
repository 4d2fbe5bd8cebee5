"""Cross-validated training entry point (reference main.py), a copy of
`stratanet2_tpu/cli/main.py` on `--device` (default CUDA).

With several ranks (cli/main.py:65-97) training is data-parallel when the
batch divides over them, or point-sharded with `--point_sharded` where
`point_sharded_eligible` allows it (else a warning and data parallelism),
as JAX chooses; with one rank `--point_sharded` is refused with JAX's
warning.

Usage: python -m stratanet2_tpu_torch.cli.main --mode DEV --las_plots_folder_path ...
       torchrun --nproc_per_node 2 -m stratanet2_tpu_torch.cli.main ... \
           --device cuda:0 --dist_backend gloo     # two ranks on one card
"""

from __future__ import annotations

import os
import sys

from stratanet2_tpu_torch.cli import log_sa_route, log_kernel_launches, start_ranks
from stratanet2_tpu_torch.config import parse_config
from stratanet2_tpu_torch.data.dataset import prepare_and_save_plots_dataset
from stratanet2_tpu_torch.learning.crossval import cross_validate
from stratanet2_tpu_torch.learning.kde import (
    fit_kde_mixture_from_dataset,
    plot_kde_mixture,
)
from stratanet2_tpu_torch.parallel import multihost
from stratanet2_tpu_torch.utils.experiment import MetricSink, NullSink


def main(argv=None):
    cfg, ns = parse_config(argv)
    device, stats_path, logger = start_ranks(ns, "learning", cfg.experiments_path, cfg.mode)
    writer = multihost.is_writer()
    sink = MetricSink(stats_path) if writer else NullSink()
    sink.log_parameters({"cfg": str(cfg)})
    logger.info("cfg: %s", cfg)
    log_sa_route(cfg.model, logger)

    # rank 0 prepares and pickles the plots and sends them to every rank
    dataset = multihost.from_writer(
        lambda: prepare_and_save_plots_dataset(cfg, cfg.data.corrected_gt_file_path))
    if not dataset:
        raise SystemExit(
            f"No plots found: no .las files in {cfg.data.las_plots_folder_path} "
            f"matching names in {cfg.data.corrected_gt_file_path}"
        )
    logger.info("Dataset contains %d plots.", len(dataset))

    kde = fit_kde_mixture_from_dataset(dataset)
    for x_lim in (3, 25) if writer else ():
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

    # data-parallel over every rank when the batch divides evenly;
    # --point_sharded shards the POINT axis instead (cli/main.py:65-92)
    mesh = None
    n_dev = multihost.world_size()
    point_sharded = ns.point_sharded
    if point_sharded:
        from stratanet2_tpu_torch.learning.train import point_sharded_eligible

        ok, why = point_sharded_eligible(cfg)
        if not ok:
            logger.warning("--point_sharded unavailable (%s); falling back to data-parallel",
                           why)
            point_sharded = False
    if not point_sharded and n_dev > 1 and cfg.train.batch_size % n_dev == 0:
        from stratanet2_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        logger.info("Using %d-device data-parallel mesh", n_dev)

    cross_validate(
        dataset, cfg, kde, stats_path, sink,
        pretrained_path=pretrained_path, device=device, mesh=mesh,
        point_sharded=point_sharded,
    )
    log_kernel_launches(logger)
    sink.close()
    return stats_path


if __name__ == "__main__":
    main(sys.argv[1:])
    multihost.shutdown()
