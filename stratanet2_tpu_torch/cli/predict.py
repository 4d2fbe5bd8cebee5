"""Prediction entry point (reference predict.py): per-parcel batched
inference on the card producing fused coverage GeoTIFFs (--task inference)
or pseudo-labels for SSL pretraining (--task pseudo_labelling). A copy of
`stratanet2_tpu/cli/predict.py`: the checkpoint (of either package) is read
by `utils/checkpoint.load_checkpoint` and becomes a model by
`utils/convert.from_jax_params`; `DataConfig.predict_chain` sets how many
batches `predict_parcel` runs between reads of the card.

Usage: python -m stratanet2_tpu_torch.cli.predict --task inference --inference_model_id ID ...
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

from stratanet2_tpu_torch.cli import log_ignored_flags, log_kernel_launches
from stratanet2_tpu_torch.config import parse_config
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.inference.predict import (
    predict_parcel,
    update_shapefile_with_predictions,
)
from stratanet2_tpu_torch.inference.shapefile_io import read_shapefile
from stratanet2_tpu_torch.utils import checkpoint as ckpt
from stratanet2_tpu_torch.utils.convert import from_jax_params
from stratanet2_tpu_torch.utils.experiment import create_logger, setup_experiment_folder
from stratanet2_tpu_torch.utils.worklist import get_unprocessed_files, stem


def main(argv=None):
    parser = argparse.ArgumentParser(description="predict", add_help=False)
    parser.add_argument(
        "--task", default="inference", choices=["inference", "pseudo_labelling"]
    )
    ns_local, _ = parser.parse_known_args(argv)
    cfg, ns = parse_config(argv)
    device = resolve_device(ns.device)

    stats_path = setup_experiment_folder(cfg.experiments_path, ns_local.task, cfg.mode)
    logger = create_logger(stats_path)
    log_ignored_flags(ns, logger)
    is_pseudo = ns_local.task == "pseudo_labelling"

    model_id = ns.inference_model_id
    assert model_id, "--inference_model_id required (experiment id of checkpoint)"
    model_path = ckpt.find_checkpoint_by_experiment(cfg.experiments_path, model_id)
    payload = ckpt.load_checkpoint(model_path)
    model = from_jax_params(payload["params"], payload["model_state"], cfg.model, device=device)
    logger.info("Loaded model %s from %s", model_id, model_path)

    input_folder = os.path.join(cfg.data.las_parcels_folder_path, "prepared")
    output_folder = os.path.join(
        cfg.data.las_parcels_folder_path, ns_local.task, model_id
    )
    os.makedirs(output_folder, exist_ok=True)

    shp = None
    if not is_pseudo:
        shp = read_shapefile(cfg.data.parcel_shapefile_path)
    max_batches = 10 if cfg.mode == "DEV" else None

    # Parcels whose prediction wrote NO output this run (e.g. every plot
    # invalid -> "Nothing to merge"): the worklist diff would re-offer them
    # forever, so track attempts and skip.
    attempted: set = set()
    while True:
        unprocessed = [
            f
            for f in get_unprocessed_files(input_folder, output_folder)
            if f.endswith(".pkl") and stem(f) not in attempted
        ]
        if not unprocessed:
            logger.info("No more prepared parcel to predict on in %s", input_folder)
            break
        logger.info("N=%d prepared parcels to process.", len(unprocessed))
        filename = unprocessed.pop(0)
        parcel_id = stem(filename)
        attempted.add(parcel_id)

        with open(filename, "rb") as f:
            dataset = pickle.load(f)
        parcel_shape = shp.get_shape(parcel_id) if shp is not None else None
        predict_parcel(
            model, dataset, cfg, parcel_id, output_folder,
            task=ns_local.task, parcel_shape=parcel_shape,
            max_batches=max_batches, device=device,
        )
        if cfg.mode == "DEV":
            break

    if not is_pseudo:
        update_shapefile_with_predictions(
            cfg.data.parcel_shapefile_path, output_folder
        )
    log_kernel_launches(logger)


if __name__ == "__main__":
    main(sys.argv[1:])
