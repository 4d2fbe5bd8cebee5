"""The port's command-line entry points, copies of `stratanet2_tpu/cli/`:
`main` (cross-validated training), `prepare` (parcel tiling), `predict`
(parcel inference or pseudo-labelling) and `main_ssl` (SSL pretraining),
with the JAX package's flags (`config.parse_config`), `--device` and
`--dist_backend`.

`main` and `predict` run as several ranks when launched so (torchrun, or
the JAX package's JAX_NUM_PROCESSES environment): `start_ranks` joins the
group, and rank 0 makes the run folder, writes every file and logs each
rank's kernel launches."""

from __future__ import annotations

import argparse
import json
import logging


def log_sa_route(mcfg, logger: logging.Logger) -> None:
    """Log the route SA1 and SA2 take under the model config's opt-ins
    (`models/pointnet2.fused_eligible`; point-sharded runs keep the grouped
    selection in float32 whatever they say)."""
    from stratanet2_tpu_torch.models.pointnet2 import fused_eligible

    logger.info("SA route: %s (ball_query_method=%s, use_pallas=%s, compute_dtype=%s)",
                "fused" if fused_eligible(mcfg) else "unfused", mcfg.ball_query_method,
                mcfg.use_pallas, mcfg.compute_dtype)


def start_ranks(ns: argparse.Namespace, task: str, experiments_path: str, mode: str):
    """Join the process group the launcher describes (one process: none),
    pick this rank's device and make the run folder on rank 0. Returns
    (device, run folder, logger): rank 0's logger writes stats.txt, the
    others' stdout alone."""
    import torch

    from stratanet2_tpu_torch.device import resolve_device
    from stratanet2_tpu_torch.parallel import multihost
    from stratanet2_tpu_torch.utils.experiment import create_logger, setup_experiment_folder

    multihost.initialize(backend=ns.dist_backend)
    device = resolve_device(multihost.rank_device(ns.device))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # the object collectives of nccl run there
    writer = multihost.is_writer()
    stats_path = multihost.broadcast_object(
        setup_experiment_folder(experiments_path, task, mode) if writer else None)
    return device, stats_path, create_logger(stats_path if writer else None)


def log_kernel_launches(logger: logging.Logger) -> None:
    """Log the kernel launches of this process (`ops/cuda_kernels.
    launch_counts`; all 0 on the CPU, where the plain versions run), and in
    a group of several ranks every rank's, on rank 0."""
    import torch.distributed as dist

    from stratanet2_tpu_torch.ops import cuda_kernels
    from stratanet2_tpu_torch.parallel import multihost

    counts = cuda_kernels.launch_counts()
    logger.info("Kernel launches: %s", json.dumps(counts))
    if multihost.world_size() > 1:
        every = [None] * multihost.world_size()
        dist.all_gather_object(every, counts)
        logger.info("Kernel launches by rank: %s", json.dumps(every))
