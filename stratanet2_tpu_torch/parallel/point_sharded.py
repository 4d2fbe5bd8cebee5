"""Point-axis sharding, the point-cloud analogue of context parallelism
(counterpart of `stratanet2_tpu/parallel/point_sharded.py`). A rank holds
its rows of the batch (mesh batch index) and a contiguous shard of their
points (mesh point index); the ops here stitch shards with the collectives
of `parallel/collectives.py` over the mesh's point group.

- `ball_query_point_sharded` (point_sharded.py:67): centroids replicated,
  each rank selects k/D grouped slots from its own shard, the slots of all
  shards concatenate in rank order with global point ids.
- `plotwise_coverages_point_sharded` (:109) and
  `raster_projection_point_sharded` (:165): each rank's per-pixel maxima
  from the `pixel_max` kernel over its shard, merged by a max across
  ranks. JAX builds a dense (P^2, N) masked max because TPU scatters
  serialize (:132-134); the port takes the math, not that layout.
- `pointnet2_forward_point_sharded` (:210-358), eval: SA1 sharded (local
  FPS of C1/D centroids a shard, all-gathered; the fused SA eval kernel
  over the shard with k1/D slots, merged by a max across ranks); SA2, SA3,
  FP3, FP2 replicated (their point sets are small); FP1 and the head on
  the shard's targets.
- `make_point_sharded_train_step` (:366-598): the same plan in train mode
  with forward, the plotwise projection, the 3-term loss, backward and
  Adam. SA takes the unfused route, as JAX's does (`axis_names` makes the
  fused train kernels ineligible, models/pointnet2.py:130-137); every
  BatchNorm sums its statistics over all ranks of the mesh. The
  cross-shard max of SA1 and of the pixel maxima is differentiable
  (gather then `torch.amax`, which splits ties evenly like `jnp.max`).

Exactness against the unsharded model: local FPS on a shard is the
partitioned FPS with the shared start residue, so sharded centroids equal
`fps(parts=D)`'s; the per-shard groups of the ball query equal the
unsharded groups only when N % k1 == 0 (PROD's N=10000 with k1=32 is not:
a 5000-point shard starts its own 313-point groups). At such geometries the
sharded step is JAX's own sharded function, and it is held to that.

Gradients: each rank's loss is its share of the global loss (the means of
equal shares divided by the mesh size), every collective's backward sums
the cotangents of all ranks, and the parameter gradients are all-reduced
with SUM once before Adam (`collectives.reduce_gradients`). Dropout
draws from the generator the caller gives each rank (seeded from the seed,
the epoch and both mesh indices in `learning/train.rank_generator`), so
the masks differ across shards.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.learning.losses import total_loss
from stratanet2_tpu_torch.ops import cuda_kernels
from stratanet2_tpu_torch.ops.fps import farthest_point_sampling
from stratanet2_tpu_torch.ops.gather import gather_rows
from stratanet2_tpu_torch.ops.projection import _low_med_high, _PixelMax, _raster_bins
from stratanet2_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    max_across,
    mean_parts,
    reduce_gradients,
)
from stratanet2_tpu_torch.parallel.mesh import Mesh

NEG_FILL = -1e30  # a masked slot's value before the max (point_sharded.py:430)


def _gather_shards(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """Concatenate every point shard's `x` along `axis`, in rank order."""
    parts = all_gather(x.contiguous(), mesh.point_group)  # (D, ...)
    return torch.cat(parts.unbind(0), dim=axis)


def ball_query_point_sharded(
    mesh: Mesh, centroids: torch.Tensor, points: torch.Tensor, radius: float, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped ball query with the point axis sharded over the mesh's point
    ranks: `centroids` (C, 3) or (B, C, 3) replicated, `points` this rank's
    shard (N/D, 3) or (B, N/D, 3); k divisible by D. Returns, on every rank,
    idx (..., C, k) into the global point axis (0 where masked) and mask."""
    d = mesh.points
    if k % d:
        raise ValueError(f"k={k} must be divisible by the {d} point ranks")
    single = centroids.dim() == 2
    if single:
        centroids, points = centroids[None], points[None]
    li, lm = cuda_kernels.ball_query(centroids.float().contiguous(),
                                     points.float().contiguous(), radius, k // d)
    gi = torch.where(lm, li + mesh.point_index * points.shape[1], 0)
    b, c, _ = gi.shape
    gi = all_gather(gi, mesh.point_group).permute(1, 2, 0, 3).reshape(b, c, k)
    gm = all_gather(lm, mesh.point_group).permute(1, 2, 0, 3).reshape(b, c, k)
    return (gi[0], gm[0]) if single else (gi, gm)


def _minmax_bins(xy: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor, diam_pix: int):
    """`projection._pixel_bins_minmax` with the extent given: (B, N) ids."""
    b = torch.floor((xy - mn) / (mx - mn + 1e-4) * diam_pix).int()
    b = torch.clamp(b, 0, diam_pix - 1)
    return (b[..., 0] * diam_pix + b[..., 1]).contiguous()


def _plotwise_merge(cov: torch.Tensor, pix: torch.Tensor, diam_pix: int, group):
    """(B, 4) plot coverages from this shard's (B, N/D, 4) coverages and
    pixel ids: local maxima (differentiable), max across `group`."""
    vmax, amax = _PixelMax.apply(pix, _low_med_high(cov.float()), diam_pix * diam_pix)
    vmax = max_across(vmax, group)  # an empty pixel's NEG loses to any value
    occ = all_reduce(amax[..., 0] >= 0, "max", group)
    pm = torch.where(occ[..., None], vmax, 0.0)
    n_occ = torch.clamp_min(occ.float().sum(1), 1.0)
    low, med, high = pm[..., 0], pm[..., 1], pm[..., 2]
    bare = torch.where(occ, 1.0 - low, 0.0)
    sums = torch.stack([low.sum(1), bare.sum(1), med.sum(1), high.sum(1)], dim=1)
    return sums / n_occ[:, None]


def plotwise_coverages_point_sharded(
    mesh: Mesh,
    coverages_pointwise: torch.Tensor,
    xy: torch.Tensor,
    diam_pix: int,
    xy_min: torch.Tensor,
    xy_max: torch.Tensor,
) -> torch.Tensor:
    """Plot coverages (`ops.projection.plotwise_coverages`) of a cloud whose
    points are sharded: this rank's (N/D, 4) coverages and (N/D, 2) xy, the
    cloud's xy extent given. Returns the (4,) coverages on every rank."""
    pix = _minmax_bins(xy[None].float(), xy_min.float(), xy_max.float(), diam_pix)
    return _plotwise_merge(coverages_pointwise[None], pix, diam_pix, mesh.point_group)[0]


def raster_projection_point_sharded(
    mesh: Mesh,
    xy_rescaled: torch.Tensor,
    coverages_pointwise: torch.Tensor,
    diam_pix: int,
    diam_meters: int,
) -> torch.Tensor:
    """`ops.projection.raster_projection` of a cloud whose points are
    sharded: this rank's (N/D, 2) rescaled xy and (N/D, 4) coverages ->
    (3, P, P) on every rank, NaN where no rank has a point."""
    pix = _raster_bins(xy_rescaled[None].float(), diam_pix, diam_meters).contiguous()
    vmax, amax = cuda_kernels.pixel_max(pix, _low_med_high(coverages_pointwise[None].float()),
                                        diam_pix * diam_pix)
    vmax = all_reduce(vmax, "max", mesh.point_group)
    occ = all_reduce(amax[..., :1] >= 0, "max", mesh.point_group)
    sel = torch.where(occ, vmax, float("nan"))[0]  # (P^2, 3)
    return torch.flip(sel.T.reshape(3, diam_pix, diam_pix), dims=[1])


def check_divisible(mcfg, d: int) -> None:
    """N, k1 and n_centroids1 must divide over d point ranks."""
    if mcfg.subsample_size % d or mcfg.k1 % d or mcfg.n_centroids1 % d:
        raise ValueError(
            f"point sharding over {d} ranks needs N({mcfg.subsample_size}), "
            f"k1({mcfg.k1}) and n_centroids1({mcfg.n_centroids1}) divisible by it"
        )


def _sa1_centroids(pos0: torch.Tensor, c1: int, mesh: Mesh) -> torch.Tensor:
    """Exact FPS of C1/D centroids on this shard, all shards' in rank
    order: the partitioned FPS of `ops.fps` with D parts."""
    idx = farthest_point_sampling(pos0, c1 // mesh.points)
    rows = torch.arange(pos0.shape[0], device=pos0.device)[:, None]
    return _gather_shards(pos0[rows, idx.long()], mesh, axis=1)


def pointnet2_forward_point_sharded(model, cloud: torch.Tensor, xyz: torch.Tensor, cfg,
                                    mesh: Mesh):
    """Eval forward of this rank's shard: `cloud` (B/Db, N/D, 8) features
    and `xyz` (B/Db, N/D, 3) positions -> (coverages, proba), each
    (B/Db, N/D, 4), the model in eval mode (and left in the caller's)."""
    from stratanet2_tpu_torch.models.pointnet2 import sa_eval_interior, set_abstraction

    mcfg = cfg if hasattr(cfg, "n_centroids1") else cfg.model
    d = mesh.points
    if mcfg.k1 % d or mcfg.n_centroids1 % d:
        raise ValueError(f"k1({mcfg.k1}) and n_centroids1({mcfg.n_centroids1}) must divide "
                         f"over {d} point ranks")
    x0, pos0 = cloud.float(), xyz.float()
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            cent1 = _sa1_centroids(pos0, mcfg.n_centroids1, mesh)
            x1 = all_reduce(sa_eval_interior(model.sa1, x0, pos0, cent1, mcfg.r1, mcfg.k1 // d),
                            "max", mesh.point_group)
            x2, cent2 = set_abstraction(model.sa2, x1, cent1, mcfg.n_centroids2, mcfg.r2,
                                        mcfg.k2, mcfg.fps_parts, mcfg.fps_min_part_samples)
            return model.decode(x0, pos0, x1, cent1, x2, cent2)
    finally:
        model.train(was_training)


def _forward_train(model, mcfg, x0, pos0, mesh: Mesh, generator):
    """Train forward of this rank's shard (point_sharded.py:426-497)."""
    from stratanet2_tpu_torch.models.pointnet2 import set_abstraction_unfused

    cent1 = _sa1_centroids(pos0, mcfg.n_centroids1, mesh)
    nbr_idx, nbr_mask = cuda_kernels.ball_query(cent1.contiguous(), pos0.contiguous(), mcfg.r1,
                                                mcfg.k1 // mesh.points)
    both = gather_rows(torch.cat([x0, pos0], dim=-1), nbr_idx)  # (B, C1, k1/D, F + 3)
    offset = torch.nn.functional.pad(cent1, (x0.shape[-1], 0))  # [0, pos_c]
    h = model.sa1(both - offset[:, :, None, :], nbr_mask, mesh.group)
    h = h.masked_fill(~nbr_mask[..., None], NEG_FILL)
    x1 = max_across(torch.amax(h, dim=2), mesh.point_group)  # (B, C1, F1) on every shard
    x2, cent2 = set_abstraction_unfused(
        model.sa2, x1, cent1, mcfg.n_centroids2, mcfg.r2, mcfg.k2, mcfg.fps_parts,
        mcfg.fps_min_part_samples, preproject=True, group=mesh.group,
    )
    return model.decode(x0, pos0, x1, cent1, x2, cent2, generator, group=mesh.group)


def _plotwise_train(cov: torch.Tensor, xy: torch.Tensor, diam_pix: int, mesh: Mesh):
    """Plot coverages of sharded clouds with each cloud's xy extent agreed
    across its shards (point_sharded.py:499-531)."""
    xy = xy.float()
    mn = all_reduce(torch.amin(xy, dim=1, keepdim=True), "min", mesh.point_group)
    mx = all_reduce(torch.amax(xy, dim=1, keepdim=True), "max", mesh.point_group)
    return _plotwise_merge(cov, _minmax_bins(xy, mn, mx, diam_pix), diam_pix, mesh.point_group)


def make_point_sharded_train_step(cfg, kde, mesh: Mesh,
                                  device: Optional[Union[str, torch.device]] = None):
    """Return step(model, optimizer, scheduler, cloud, xyz, gt, generator=None)
    -> the global batch's loss parts (detached scalars, equal on every rank).

    This rank's inputs: `cloud` (B/Db, N/D, 10) and `xyz` (B/Db, N/D, 3),
    its rows and its point shard (`mesh.shard_batch`, `mesh.shard_points`),
    and `gt` (B/Db, 4). The step is `learning/train.make_train_step`'s on
    the sharded forward: the parameter gradients are all-reduced before
    Adam, so parameters and BN state stay equal on every rank."""
    from stratanet2_tpu_torch.learning.train import _check_model_device

    mcfg, tcfg = cfg.model, cfg.train
    check_divisible(mcfg, mesh.points)
    if tcfg.batch_size % mesh.batch:
        raise ValueError(f"batch_size {tcfg.batch_size} must divide over {mesh.batch} rows")
    dev = resolve_device(device)
    kde_grid = torch.as_tensor(kde.grid, dtype=torch.float32, device=dev)
    kde_pdfs = torch.as_tensor(kde.pdfs, dtype=torch.float32, device=dev)

    def step(model, optimizer, scheduler, cloud, xyz, gt, generator=None):
        _check_model_device(model, dev)
        cloud = torch.as_tensor(cloud, device=dev).float()
        xyz = torch.as_tensor(xyz, device=dev).float()
        gt = torch.as_tensor(gt, device=dev).float()
        model.train()
        cov, proba = _forward_train(model, mcfg, cloud[..., 2:], xyz, mesh, generator)
        pred_pl = _plotwise_train(cov, cloud[..., :2], mcfg.diam_pix, mesh)
        z_m = cloud[..., 2] * mcfg.z_max
        loss, (comps, _aux) = total_loss(
            pred_pl, gt, proba, z_m, kde_grid, kde_pdfs, tcfg.m, tcfg.e
        )
        optimizer.zero_grad(set_to_none=True)
        (loss / mesh.size).backward()
        reduce_gradients(model, mesh.group)
        optimizer.step()
        scheduler.step()
        return mean_parts(comps, mesh.group)

    return step
