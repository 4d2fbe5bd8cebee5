"""Parcel predict (counterpart of `stratanet2_tpu/inference/predict.py`,
reference predict.py + inference/predict_utils.py).

`make_predict_step` is the serve step: forward, raster projection and
plotwise coverages of a batch of plot clouds, on the card through the four
serve kernels. `predict_parcel` runs it over a parcel's plots as
`PlotLoader` batches them, in chains of `DataConfig.predict_chain` batches
whose outputs stay on the device and are read with one copy a chain (the
JAX package scans a chain in one program; here a chain's batches are
launched one after another as the loader makes them, and the chain sets
how often the host waits for the card). Per-plot GeoTIFF tiles, their
weighted mosaic and the shapefile update stay on the host. Both tasks:
- inference: per-plot rasters -> weighted parcel mosaic -> shapefile fields
  (predict.py:113-148);
- pseudo_labelling: plot-level coverages written back into the parcel's
  plots as labels for SSL pretraining (predict.py:104-111, min 2000 points
  at predict_utils.py:62-71).

In a process group (predict.py:55-200): `make_predict_step(mesh=...)` runs
each rank on its rows of every batch and all-gathers the outputs, with the
model broadcast from rank 0 once per model (`_cached_replicator`);
`make_point_sharded_predict_step` runs each rank on its shard of every
cloud's points, all-gathers the coverages and projects them unsharded, as
JAX's GSPMD does. Every rank then holds the whole batch's outputs, and
`predict_parcel` writes on rank 0 alone. The loader pads a parcel's last
batch to `batch_size` with invalid plots, as JAX's does, so every batch
divides over a data-parallel mesh whose size divides `batch_size`.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, Optional, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data.loader import PlotLoader
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.inference.geotiff import GeoTiff, get_geotransform, write_geotiff
from stratanet2_tpu_torch.inference.polygons import Polygon
from stratanet2_tpu_torch.inference.rasters import (
    SHP_FIELDS_NAME_DICT,
    add_weights_band_to_rasters,
    get_parcel_predicted_values,
    merge_geotiff_rasters,
)
from stratanet2_tpu_torch.inference.shapefile_io import FieldSpec, read_shapefile, write_shapefile
from stratanet2_tpu_torch.models.pointnet2 import PointNet2, check_opt_ins
from stratanet2_tpu_torch.ops.projection import (
    batched_raster_projection,
    plotwise_coverages,
)
from stratanet2_tpu_torch.parallel import multihost
from stratanet2_tpu_torch.parallel.collectives import all_gather
from stratanet2_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch, shard_points

logger = logging.getLogger("stratanet2_tpu_torch")


def _check_model(model: PointNet2, dev: torch.device) -> None:
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step runs on {dev}")


def make_predict_step(
    cfg: Config,
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Mesh] = None,
):
    """Return step(model, cloud, xyz) -> (rasters (B, 3, P, P), pred_pl (B, 4)).

    `cloud` is (B, N, 10) with the rescaled x, y in its first two columns,
    `xyz` (B, N, 3) centred positions in metres (arrays or tensors, any
    float type; computed in float32 on `device`, default CUDA). `model` must
    already be on that device. The model runs in eval mode, as JAX's
    `train=False` does (running BN statistics, the fused SA eval kernel),
    and is left in the mode the caller had it in.

    With a data-parallel `mesh`, every rank passes the whole batch, steps
    on its rows and returns the whole batch's outputs (predict.py:99-131)."""
    mcfg = cfg.model
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(model: PointNet2, cloud, xyz):
        _check_model(model, dev)
        check_opt_ins(model, mcfg)
        cloud = torch.as_tensor(cloud, device=dev).float()
        xyz = torch.as_tensor(xyz, device=dev).float()
        was_training = model.training
        model.eval()
        try:
            cov, _proba = model(cloud[..., 2:], xyz)
        finally:
            model.train(was_training)
        rasters = batched_raster_projection(
            cloud[..., :2], cov, mcfg.diam_pix, mcfg.diam_meters
        )
        pred_pl = plotwise_coverages(cov, cloud[..., :2], mcfg.diam_pix)
        return rasters, pred_pl

    if mesh is None:
        return step
    replicator = _cached_replicator(mesh)

    def sharded_step(model: PointNet2, cloud, xyz):
        replicator(model)
        rasters, pred_pl = step(model, shard_batch(mesh, cloud), shard_batch(mesh, xyz))
        return tuple(all_gather(out, mesh.group).flatten(0, 1) for out in (rasters, pred_pl))

    return sharded_step


def _cached_replicator(mesh: Mesh):
    """replicator(model): rank 0's parameters and buffers broadcast into
    `model`, once per model (predict.py:133): keyed on the identity of its
    tensors, held alive with the key, so that a new checkpoint (or a BN
    update, which binds new buffers) is broadcast again."""
    cache = {}

    def replicator(model: PointNet2) -> PointNet2:
        tensors = list(model.parameters()) + list(model.buffers())
        key = tuple(id(t) for t in tensors)
        if key not in cache:
            cache.clear()
            replicate(mesh, model)
            cache[key] = tensors
        return model

    return replicator


def make_point_sharded_predict_step(
    cfg: Config, n_devices: int, device: Optional[Union[str, torch.device]] = None
):
    """Return step(model, cloud, xyz) -> (rasters, pred_pl), as
    `make_predict_step`'s, with the point axis sharded over `n_devices`
    ranks (predict.py:55-97): every rank passes the whole batch, runs the
    sharded forward (`parallel/point_sharded.pointnet2_forward_point_sharded`)
    on its shard of the points, the coverages are all-gathered and both
    projections run on the whole clouds. Raises ValueError unless N, k1 and
    n_centroids1 divide by `n_devices`; needs a process group of that many
    ranks."""
    from stratanet2_tpu_torch.parallel.mesh import make_mesh_2d
    from stratanet2_tpu_torch.parallel.point_sharded import (
        _gather_shards,
        check_divisible,
        pointnet2_forward_point_sharded,
    )

    mcfg = cfg.model
    check_divisible(mcfg, n_devices)
    dev = resolve_device(device)
    mesh = make_mesh_2d(1, n_devices)
    replicator = _cached_replicator(mesh)

    @torch.inference_mode()
    def project(model: PointNet2, cloud, xyz):
        cov_l, _ = pointnet2_forward_point_sharded(
            model, shard_points(mesh, cloud[..., 2:]), shard_points(mesh, xyz), mcfg, mesh
        )
        cov = _gather_shards(cov_l, mesh, axis=1)
        rasters = batched_raster_projection(cloud[..., :2], cov, mcfg.diam_pix,
                                            mcfg.diam_meters)
        return rasters, plotwise_coverages(cov, cloud[..., :2], mcfg.diam_pix)

    def step(model: PointNet2, cloud, xyz):
        _check_model(model, dev)
        replicator(model)
        return project(model, torch.as_tensor(cloud, device=dev).float(),
                       torch.as_tensor(xyz, device=dev).float())

    return step


def filter_dataset(dataset: Dict, is_pseudo_labelling: bool, min_points: int = 2000) -> Dict:
    """Min-points filter for pseudo-labelling (predict_utils.py:62-71)."""
    if is_pseudo_labelling:
        return {
            pid: cd
            for pid, cd in dataset.items()
            if cd["N_points_in_cloud"] > min_points
        }
    return dataset


def make_predict_program(
    cfg: Config,
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Mesh] = None,
    step=None,
):
    """Return program(model, clouds, xyzs) -> (rasters (S, B, 3, P, P),
    preds (S, B, 4)): `step` (default `make_predict_step(cfg, device,
    mesh)`, predict.py:157-200: `mesh` is read only then) over each batch
    of a chain,
    clouds (S, B, N, F) and xyzs (S, B, N, 3) (stacked arrays, or sequences
    of S batches). Each batch is uploaded and launched in turn; the stacked
    outputs stay on `device` (default CUDA). The batches go to the card
    from pageable memory: pinned memory and non-blocking copies measured no
    faster on the H100, where the host loader sets the pace (PERF.md)."""
    if step is None:
        step = make_predict_step(cfg, device, mesh)

    def program(model: PointNet2, clouds, xyzs):
        outs = [step(model, c, x) for c, x in zip(clouds, xyzs)]
        return torch.stack([r for r, _ in outs]), torch.stack([p for _, p in outs])

    return program


def _chain_batches(loader, chain: int, max_batches: Optional[int]):
    """Group loader batches into chains of `chain`, the last one shorter
    when the batches run out, stopping after `max_batches`. (The JAX package
    pads the last chain with all-invalid batches so that every program call
    has one shape; launches from the host need no such padding.)"""
    group = []
    for n_seen, batch in enumerate(loader, 1):
        group.append(batch)
        if len(group) == chain:
            yield group
            group = []
        if max_batches is not None and n_seen >= max_batches:
            break
    if group:
        yield group


def _copy_to_host(out: torch.Tensor):
    """Start one copy of `out` to the host: (host tensor, the event that
    marks the copy done, or None off the card). On the card the copy goes
    into pinned memory without blocking, behind the work already queued."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    return host, done


def predict_parcel(
    model: PointNet2,
    dataset: Dict,
    cfg: Config,
    parcel_id: str,
    output_folder: str,
    task: str = "inference",
    parcel_shape: Optional[Polygon] = None,
    max_batches: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    program=None,
) -> Optional[str]:
    """Run one parcel's plots through `model` (on `device`, default CUDA),
    by `program` (default `make_predict_program(cfg, device)`; a
    data-parallel or point-sharded one in a process group, where every
    rank runs this with the same arguments and rank 0 alone writes).
    Returns the merged parcel tif's path for inference, or the
    pseudo-labelled pkl's path for pseudo_labelling; None when no plot is
    left to predict or no tile holds a prediction, and on ranks other
    than 0."""
    is_pseudo = task == "pseudo_labelling"
    dataset = filter_dataset(dataset, is_pseudo, cfg.data.min_points_for_pseudo_labelling)
    if not dataset:
        logger.warning("Parcel %s: no plots to predict", parcel_id)
        return None
    chain = max(1, int(cfg.data.predict_chain))
    program = program or make_predict_program(cfg, device)
    writer = multihost.is_writer()
    loader = PlotLoader(dataset, cfg, train=False)

    # In-memory tiles: only the merged tif (the worklist's done-marker) is
    # written, unless keep_plot_tiffs also asks for each plot's
    # (the reference's intermediate tifs, predict.py:113-126).
    tiff_folder = os.path.join(output_folder, parcel_id)
    p = cfg.model.diam_pix
    mem_tiles = []

    def drain(metas, host, done):
        """A chain's results into pseudo-labels or tiles, once its copy is done."""
        if done is not None:
            done.synchronize()
        out_s = host.numpy()
        rasters_s = out_s[..., : 3 * p * p].reshape(out_s.shape[:2] + (3, p, p))
        preds_s = out_s[..., 3 * p * p :]  # pred_pl (S, B, 4)
        for batch, rasters, pred_pl in zip(metas, rasters_s, preds_s):
            for j in np.where(batch["valid"])[0]:
                plot_id = batch["plot_id"][j]
                if is_pseudo:
                    dataset[plot_id]["coverages"] = pred_pl[j]
                else:
                    with_weights = add_weights_band_to_rasters(rasters[j], p)
                    gt = get_geotransform(
                        batch["plot_center"][j], cfg.model.diam_meters, p
                    )
                    mem_tiles.append(GeoTiff(bands=with_weights, geotransform=list(gt)))
                    if cfg.data.keep_plot_tiffs:
                        write_geotiff(
                            os.path.join(tiff_folder, f"{plot_id}.tif"), with_weights, gt
                        )

    # A chain's outputs, (B, 3, P, P) rasters and (B, 4) preds a batch, go
    # to the host in one copy queued behind its batches; the host drains the
    # previous chain while the card runs this one, keeping only the batch
    # fields the drain reads.
    pending = None
    for group in _chain_batches(loader, chain, max_batches):
        rasters_s, preds_s = program(
            model, [b["cloud"] for b in group], [b["xyz"] for b in group]
        )
        out = torch.cat([rasters_s.flatten(2), preds_s], dim=2)
        metas = [{k: b[k] for k in ("valid", "plot_id", "plot_center")} for b in group]
        if pending is not None:
            drain(*pending)
        if writer:
            pending = (metas, *_copy_to_host(out))
    if pending is not None:
        drain(*pending)
    if not writer:
        return None

    if is_pseudo:
        # max_batches can leave plots unpredicted: keep only the plots that
        # received pseudo-labels (the reference pickles them all,
        # predict.py:128-134, and its SSL loader then fails on them)
        labelled = {pid: cd for pid, cd in dataset.items() if "coverages" in cd}
        if len(labelled) < len(dataset):
            logger.info(
                "Parcel %s: %d/%d plots pseudo-labelled (batch cap)",
                parcel_id, len(labelled), len(dataset),
            )
        out_path = os.path.join(output_folder, parcel_id + ".pkl")
        os.makedirs(output_folder, exist_ok=True)
        # atomic: a crash mid-dump must not leave a truncated pkl that the
        # idempotent worklist treats as done
        tmp_path = out_path + ".tmp"
        with open(tmp_path, "wb") as f:
            pickle.dump(labelled, f)
        os.replace(tmp_path, out_path)
        return out_path

    final_tif = os.path.join(output_folder, f"{parcel_id}.tif")
    # every plot invalid: no tiles, and the merge says there is nothing to
    # merge, as the reference's does (inference/geotiff_raster.py:203-207)
    msg = merge_geotiff_rasters(final_tif, (), parcel_shape, tiles=mem_tiles)
    logger.info(msg)
    return final_tif if os.path.exists(final_tif) else None


def update_shapefile_with_predictions(parcel_shapefile_path: str, output_folder: str) -> str:
    """Copy the parcel shapefile, appending PRED_* float fields from parcel
    tif band means (inference/predict_utils.py:149-177)."""
    tifs = {
        os.path.splitext(f)[0]: os.path.join(output_folder, f)
        for f in os.listdir(output_folder)
        if f.endswith(".tif")
    }
    if not tifs:
        logger.error("No prediction tif file found in %s", output_folder)

    shp = read_shapefile(parcel_shapefile_path)
    for field in SHP_FIELDS_NAME_DICT:
        shp.fields.append(FieldSpec(field, "F", length=20, decimals=10))
    for sr in shp.shape_records:
        parcel_id = str(sr.record.get("ID"))
        preds = get_parcel_predicted_values(tifs.get(parcel_id))
        sr.record.update(preds)

    out_path = os.path.join(
        output_folder,
        os.path.splitext(os.path.basename(parcel_shapefile_path))[0],
    )
    write_shapefile(out_path, shp)
    return out_path
