"""The port's command-line entry points, copies of `stratanet2_tpu/cli/`:
`main` (cross-validated training), `prepare` (parcel tiling), `predict`
(parcel inference or pseudo-labelling) and `main_ssl` (SSL pretraining),
with the JAX package's flags (`config.parse_config`) and `--device`."""

from __future__ import annotations

import argparse
import json
import logging


def log_ignored_flags(ns: argparse.Namespace, logger: logging.Logger) -> None:
    """Log the JAX package's flags that the port accepts and ignores."""
    if ns.use_pallas is not None:
        logger.info("--use_pallas ignored: the port has one kernel path per device")
    if ns.point_sharded:
        logger.warning("--point_sharded ignored: point sharding is not ported")


def log_kernel_launches(logger: logging.Logger) -> None:
    """Log the kernel launches of this process (`ops/cuda_kernels.
    launch_counts`; all 0 on the CPU, where the plain versions run)."""
    from stratanet2_tpu_torch.ops import cuda_kernels

    logger.info("Kernel launches: %s", json.dumps(cuda_kernels.launch_counts()))
