"""Parcel preparation entry point (reference prepare.py): tile each unprocessed
parcel LAS into 10 m-radius plot clouds and pickle them per parcel. A copy of
`stratanet2_tpu/cli/prepare.py`; it runs on the host alone.

Idempotent worklist (input minus produced outputs) so concurrent/restarted
jobs cooperate (prepare.py:48-59).

Usage: python -m stratanet2_tpu_torch.cli.prepare --mode DEV --las_parcels_folder_path ...
"""

from __future__ import annotations

import os
import pickle
import sys

from stratanet2_tpu_torch.config import parse_config
from stratanet2_tpu_torch.inference.shapefile_io import read_shapefile
from stratanet2_tpu_torch.inference.tiling import (
    divide_parcel_las_and_get_disk_centers,
    extract_plots_from_parcel,
    save_tiling_figure,
)
from stratanet2_tpu_torch.utils.experiment import create_logger, setup_experiment_folder
from stratanet2_tpu_torch.utils.worklist import get_unprocessed_files, stem


def main(argv=None):
    cfg, _ = parse_config(argv)
    stats_path = setup_experiment_folder(cfg.experiments_path, "prepare", cfg.mode)
    logger = create_logger(stats_path)

    input_folder = os.path.join(cfg.data.las_parcels_folder_path, "input")
    output_folder = os.path.join(cfg.data.las_parcels_folder_path, "prepared")
    os.makedirs(output_folder, exist_ok=True)

    shp = read_shapefile(cfg.data.parcel_shapefile_path)

    while True:
        unprocessed = [
            f
            for f in get_unprocessed_files(input_folder, output_folder)
            if f.lower().endswith(".las")
        ]
        if not unprocessed:
            logger.info("No unprepared parcel found in %s", input_folder)
            break
        logger.info("N=%d parcels to prepare.", len(unprocessed))
        filename = unprocessed.pop()
        parcel_id = stem(filename)

        parcel_shape = shp.get_shape(parcel_id)
        centers, parcel_cloud = divide_parcel_las_and_get_disk_centers(
            cfg, filename, parcel_shape
        )
        save_tiling_figure(
            parcel_cloud, centers, parcel_id,
            os.path.join(output_folder, "divisions", f"{parcel_id}.png"),
        )
        plots = extract_plots_from_parcel(cfg, parcel_cloud, centers)
        logger.info("Parcel %s: kept %d plots", parcel_id, len(plots))

        # atomic: the worklist treats any same-stem file as done, so a
        # truncated pkl from a mid-dump crash would poison every later run
        out_path = os.path.join(output_folder, f"{parcel_id}.pkl")
        tmp_path = out_path + ".tmp"
        with open(tmp_path, "wb") as f:
            pickle.dump(plots, f)
        os.replace(tmp_path, out_path)
        if cfg.mode == "DEV":
            break


if __name__ == "__main__":
    main(sys.argv[1:])
