"""Prediction entry point (reference predict.py): per-parcel batched
inference on the card producing fused coverage GeoTIFFs (--task inference)
or pseudo-labels for SSL pretraining (--task pseudo_labelling). A copy of
`stratanet2_tpu/cli/predict.py`: the checkpoint (of either package) is read
by `utils/checkpoint.load_checkpoint` and becomes a model by
`utils/convert.from_jax_params`; `DataConfig.predict_chain` sets how many
batches `predict_parcel` runs between reads of the card.

With several ranks (cli/predict.py:40, 72-102) each batch is point-sharded
with `--point_sharded` (else a warning, and the fallback), or split over
the ranks when the batch divides, as JAX chooses; with one rank
`--point_sharded` is ignored with JAX's warning. Rank 0 lists the
worklist and broadcasts each parcel, and alone reads and writes files.

Usage: python -m stratanet2_tpu_torch.cli.predict --task inference --inference_model_id ID ...
       torchrun --nproc_per_node 2 -m stratanet2_tpu_torch.cli.predict ... \
           --device cuda:0 --dist_backend gloo     # two ranks on one card
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

from stratanet2_tpu_torch.cli import log_sa_route, log_kernel_launches, start_ranks
from stratanet2_tpu_torch.config import parse_config
from stratanet2_tpu_torch.inference.predict import (
    make_point_sharded_predict_step,
    make_predict_program,
    predict_parcel,
    update_shapefile_with_predictions,
)
from stratanet2_tpu_torch.inference.shapefile_io import read_shapefile
from stratanet2_tpu_torch.parallel import multihost
from stratanet2_tpu_torch.utils import checkpoint as ckpt
from stratanet2_tpu_torch.utils.convert import from_jax_params
from stratanet2_tpu_torch.utils.worklist import get_unprocessed_files, stem


def main(argv=None):
    parser = argparse.ArgumentParser(description="predict", add_help=False)
    parser.add_argument(
        "--task", default="inference", choices=["inference", "pseudo_labelling"]
    )
    ns_local, _ = parser.parse_known_args(argv)
    cfg, ns = parse_config(argv)
    device, stats_path, logger = start_ranks(ns, ns_local.task, cfg.experiments_path, cfg.mode)
    writer = multihost.is_writer()
    log_sa_route(cfg.model, logger)
    is_pseudo = ns_local.task == "pseudo_labelling"

    model_id = ns.inference_model_id
    assert model_id, "--inference_model_id required (experiment id of checkpoint)"
    # rank 0 alone reads files (the checkpoint, each parcel, the
    # shapefile) and sends what every rank needs
    model_path = multihost.from_writer(
        lambda: ckpt.find_checkpoint_by_experiment(cfg.experiments_path, model_id))
    payload = multihost.from_writer(lambda: ckpt.load_checkpoint(model_path))
    model = from_jax_params(payload["params"], payload["model_state"], cfg.model, device=device)
    logger.info("Loaded model %s from %s", model_id, model_path)

    input_folder = os.path.join(cfg.data.las_parcels_folder_path, "prepared")
    output_folder = os.path.join(
        cfg.data.las_parcels_folder_path, ns_local.task, model_id
    )
    if writer:
        os.makedirs(output_folder, exist_ok=True)

    shp = None
    if writer and not is_pseudo:  # the parcel's shape clips rank 0's mosaic
        shp = read_shapefile(cfg.data.parcel_shapefile_path)
    max_batches = 10 if cfg.mode == "DEV" else None

    n_dev = multihost.world_size()
    program = None
    if ns.point_sharded and n_dev == 1:
        logger.warning("--point_sharded ignored: only one device visible; "
                       "running the plain predict step")
    if ns.point_sharded and n_dev > 1:
        try:
            program = make_predict_program(
                cfg, device, step=make_point_sharded_predict_step(cfg, n_dev, device))
            logger.info("Using %d-device POINT-sharded inference mesh", n_dev)
        except ValueError as e:
            logger.warning("point sharding unavailable (%s); falling back", e)
    if program is None:
        mesh = None
        if n_dev > 1 and cfg.train.batch_size % n_dev == 0:
            from stratanet2_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh()
            logger.info("Using %d-device data-parallel inference mesh", n_dev)
        program = make_predict_program(cfg, device, mesh)

    # Parcels whose prediction wrote NO output this run (e.g. every plot
    # invalid -> "Nothing to merge"): the worklist diff would re-offer them
    # forever, so track attempts and skip.
    # Rank 0 alone lists the folders and broadcasts its pick: a rank that
    # listed the output folder while rank 0 writes to it would diverge.
    attempted: set = set()
    while True:
        filename = None
        if writer:
            unprocessed = [
                f
                for f in get_unprocessed_files(input_folder, output_folder)
                if f.endswith(".pkl") and stem(f) not in attempted
            ]
            if unprocessed:
                logger.info("N=%d prepared parcels to process.", len(unprocessed))
                filename = unprocessed[0]
            else:
                logger.info("No more prepared parcel to predict on in %s", input_folder)
        filename = multihost.broadcast_object(filename)
        if filename is None:
            break
        parcel_id = stem(filename)
        attempted.add(parcel_id)

        dataset = multihost.from_writer(lambda: _load_pickle(filename))
        parcel_shape = shp.get_shape(parcel_id) if shp is not None else None
        predict_parcel(
            model, dataset, cfg, parcel_id, output_folder,
            task=ns_local.task, parcel_shape=parcel_shape,
            max_batches=max_batches, device=device, program=program,
        )
        if cfg.mode == "DEV":
            break

    if writer and not is_pseudo:
        update_shapefile_with_predictions(
            cfg.data.parcel_shapefile_path, output_folder
        )
    log_kernel_launches(logger)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    main(sys.argv[1:])
    multihost.shutdown()
