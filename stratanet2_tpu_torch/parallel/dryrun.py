"""Every parallel path once, on `n` ranks (counterpart of
`__graft_entry__.dryrun_multichip`, :80-352).

    python -m stratanet2_tpu_torch.parallel.dryrun 2 --device cpu     # gloo, CPU
    python -m stratanet2_tpu_torch.parallel.dryrun 2 --device cuda:0  # both ranks on one card
    python -m stratanet2_tpu_torch.parallel.dryrun 2                 # a card a rank

`dryrun_multichip(n, backend, device)` starts n ranks (`launch.run_ranks`)
that run, at a small size: one data-parallel train step, one data-parallel
device-resident epoch, one point-sharded train step on a 1 x n mesh, one
on a 2 x n/2 mesh when n >= 4, one point-sharded predict step, and the
partition checks of `host_batch_slice` and the parcel worklist. It raises
(and the command exits non-zero) if any rank fails.

The `case_*` functions are the rank side of those paths: each runs in a
started process group, on inputs every rank is given whole, takes its own
share and returns numpy results. `run_cases` runs a list of them in one
rank; the tests hold them to the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.parallel import multihost
from stratanet2_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    gather_across,
    max_across,
    sum_across,
)
from stratanet2_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    shard_batch,
    shard_points,
)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _model(mcfg, params, state, device):
    from stratanet2_tpu_torch.utils.convert import from_jax_params

    return from_jax_params(params, state, mcfg, device=device)


def _kde(grid, pdfs):
    from stratanet2_tpu_torch.learning.kde import KdeMixture

    return KdeMixture(np.asarray(grid, np.float32), np.asarray(pdfs, np.float32))


def _after_step(model, comps) -> Dict:
    from stratanet2_tpu_torch.utils.convert import grads_to_jax, to_jax_params

    params, state = to_jax_params(model)
    return dict(comps={k: float(v) for k, v in comps.items()}, grads=grads_to_jax(model),
                params=params, state=state)


# ---------------------------------------------------------------------------
# the rank side of each path
# ---------------------------------------------------------------------------


def case_collectives(device, values) -> Dict:
    """The collectives on rank r's row of `values` (D, n): forward values
    and the gradients of per-rank losses (see the tests for the sums)."""
    group, r = dist.group.WORLD, multihost.rank()
    d = multihost.world_size()
    c = float(r + 1)
    out = {}
    x = torch.tensor(values[r], device=device, requires_grad=True)
    y = sum_across(x, group)
    (y * c).sum().backward()
    out["sum"], out["sum_grad"] = _np(y), _np(x.grad)
    x.grad = None
    y = gather_across(x, group)
    (y * c * torch.arange(1.0, d + 1, device=device)[:, None]).sum().backward()
    out["gather"], out["gather_grad"] = _np(y), _np(x.grad)
    for name, scale in (("max_replicated", 1.0), ("max_shared", 1.0 / d)):
        x.grad = None
        y = max_across(x, group)
        (y.sum() * scale).backward()
        out[name], out[name + "_grad"] = _np(y), _np(x.grad)
    tied = torch.full((3,), 2.5, device=device, requires_grad=True)
    max_across(tied, group).sum().backward()
    out["tied_grad"] = _np(tied.grad)
    odd = torch.tensor([-1e30, float("nan"), -0.0, 3.4e38], device=device) * (r + 1)
    out["gather_exact"] = _np(all_gather(odd, group))
    out["gather_int"] = _np(all_gather(torch.arange(4, device=device, dtype=torch.int32) + r,
                                       group))
    out["gather_bool"] = _np(all_gather(torch.tensor([r == 0, True], device=device), group))
    out["max_bool"] = _np(all_reduce(torch.tensor([r == 0, False], device=device), "max",
                                     group))
    out["min"] = _np(all_reduce(torch.tensor([float(r)], device=device), "min", group))
    return out


def case_sharded_ops(device, points, centroids, radius, k, cov, xy, diam_pix, xy_rescaled,
                     cov_raster, diam_meters) -> Dict:
    """The three point-sharded ops over a 1 x D mesh, each rank given its
    shard of the (N, .) inputs."""
    from stratanet2_tpu_torch.parallel import point_sharded as ps

    mesh = make_mesh_2d(1, multihost.world_size())

    def shard(a):
        return shard_points(mesh, torch.as_tensor(a, device=device)[None])[0]

    gi, gm = ps.ball_query_point_sharded(mesh, torch.as_tensor(centroids, device=device),
                                         shard(points), radius, k)
    xy_t = torch.as_tensor(xy, device=device)
    pl = ps.plotwise_coverages_point_sharded(mesh, shard(cov), shard(xy), diam_pix,
                                             xy_t.amin(0), xy_t.amax(0))
    raster = ps.raster_projection_point_sharded(mesh, shard(xy_rescaled), shard(cov_raster),
                                                diam_pix, diam_meters)
    return dict(idx=_np(gi), mask=_np(gm), plotwise=_np(pl), raster=_np(raster))


def case_forward(device, mcfg, params, state, cloud, xyz, db, dp) -> Dict:
    """`pointnet2_forward_point_sharded` on this rank's rows and shard."""
    from stratanet2_tpu_torch.parallel.point_sharded import pointnet2_forward_point_sharded

    mesh = make_mesh_2d(db, dp)
    model = _model(mcfg, params, state, device)
    local = [shard_points(mesh, shard_batch(mesh, torch.as_tensor(a, device=device)))
             for a in (cloud, xyz)]
    cov, proba = pointnet2_forward_point_sharded(model, local[0], local[1], mcfg, mesh)
    return dict(batch_index=mesh.batch_index, point_index=mesh.point_index, cov=_np(cov),
                proba=_np(proba))


def case_point_sharded_step(device, cfg, kde_grid, kde_pdfs, params, state, cloud, xyz, gt,
                            db, dp, steps_per_epoch=1, seed=0) -> Dict:
    """One `make_point_sharded_train_step` on a db x dp mesh from the given
    weights, its dropout drawn from `rank_generator(seed, 1)`: the loss
    parts, the reduced gradients, params and BN state."""
    from stratanet2_tpu_torch.learning.train import make_optimizer, rank_generator
    from stratanet2_tpu_torch.parallel.point_sharded import make_point_sharded_train_step

    mesh = make_mesh_2d(db, dp)
    model = _model(cfg.model, params, state, device)
    opt, sched = make_optimizer(cfg, model, steps_per_epoch)
    step = make_point_sharded_train_step(cfg, _kde(kde_grid, kde_pdfs), mesh, device)
    local = [shard_points(mesh, shard_batch(mesh, torch.as_tensor(a, device=device)))
             for a in (cloud, xyz)]
    comps = step(model, opt, sched, local[0], local[1],
                 shard_batch(mesh, torch.as_tensor(gt, device=device)),
                 rank_generator(seed, 1, mesh, device))
    return _after_step(model, comps)


def case_data_parallel_step(device, cfg, kde_grid, kde_pdfs, params, state, cloud, xyz,
                            gt, steps_per_epoch=1) -> Dict:
    """One data-parallel `make_train_step` on this rank's rows."""
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step

    mesh = make_mesh()
    model = _model(cfg.model, params, state, device)
    opt, sched = make_optimizer(cfg, model, steps_per_epoch)
    step = make_train_step(cfg, _kde(kde_grid, kde_pdfs), device, mesh)
    rows = [shard_batch(mesh, torch.as_tensor(a, device=device)) for a in (cloud, xyz, gt)]
    return _after_step(model, step(model, opt, sched, *rows))


def case_device_epoch(device, cfg, kde_grid, kde_pdfs, params, state, feats, xyz, n,
                      coverages, idx, draws) -> Dict:
    """One data-parallel device-resident epoch over the given table and
    index table, each batch sampled from `draws` (a list of the global
    batch's Draws fields, as numpy)."""
    from stratanet2_tpu_torch.data import device_dataset as D
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step

    mesh = make_mesh()
    model = _model(cfg.model, params, state, device)
    opt, sched = make_optimizer(cfg, model, idx.shape[0])
    dd = D.replicate_device_dataset(mesh, D.DeviceDataset(
        *(torch.as_tensor(a, device=device) for a in (feats, xyz, n, coverages)),
        plot_ids=tuple(str(i) for i in range(len(n)))))
    feed = [D.Draws(*(None if f is None else torch.as_tensor(f, device=device) for f in dr))
            for dr in draws]
    run = D.make_device_epoch(cfg, make_train_step(cfg, _kde(kde_grid, kde_pdfs), device,
                                                   mesh), mesh)
    sums = run(model, opt, sched, dd, torch.as_tensor(idx, device=device),
               torch.Generator(device=device).manual_seed(0), lambda i, b, m, t: feed[i])
    return _after_step(model, sums)


def case_predict(device, cfg, params, state, cloud, xyz,
                 paths=("data_parallel", "point_sharded")) -> Dict:
    """The data-parallel and/or the point-sharded predict step on the whole
    batch: (rasters, pred_pl) of each, whole on every rank."""
    from stratanet2_tpu_torch.inference.predict import (
        make_point_sharded_predict_step,
        make_predict_step,
    )

    model = _model(cfg.model, params, state, device)
    makers = {"data_parallel": lambda: make_predict_step(cfg, device, make_mesh()),
              "point_sharded": lambda: make_point_sharded_predict_step(
                  cfg, multihost.world_size(), device)}
    out = {}
    for name in paths:
        rasters, pred_pl = makers[name]()(model, cloud, xyz)
        out[name] = (_np(rasters), _np(pred_pl))
    return out


def case_train_full(device, dataset, train_ids, val_ids, cfg, kde_grid, kde_pdfs, stats_path,
                    data_parallel, point_sharded) -> Dict:
    """`train_full` with a data-parallel mesh and/or `point_sharded`: the
    loss lists, the warnings logged, and the BN state and params at the
    end (to compare across ranks)."""
    import logging

    from stratanet2_tpu_torch.learning.train import train_full
    from stratanet2_tpu_torch.utils.convert import to_jax_params
    from stratanet2_tpu_torch.utils.experiment import MetricSink, NullSink

    warnings: List[str] = []

    class _Keep(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    logger = logging.getLogger("stratanet2_tpu_torch")
    keep = _Keep()
    logger.addHandler(keep)
    try:
        if multihost.is_writer():
            os.makedirs(stats_path, exist_ok=True)
        multihost.broadcast_object(None)  # the folder exists before any rank uses it
        sink = MetricSink(stats_path) if multihost.is_writer() else NullSink()
        ts, train_losses, test_losses, infos = train_full(
            dataset, np.asarray(train_ids), np.asarray(val_ids), cfg,
            _kde(kde_grid, kde_pdfs), stats_path, sink, fold_id=1, device=device,
            mesh=make_mesh() if data_parallel else None, point_sharded=point_sharded)
        sink.close()
    finally:
        logger.removeHandler(keep)
    params, state = to_jax_params(ts.model)
    return dict(train=train_losses, test=test_losses, infos=infos, warnings=warnings,
                params=params, state=state)


def case_cli(device, module, argv) -> str:
    """A CLI (`stratanet2_tpu_torch.cli.<module>.main`) on every rank."""
    import importlib

    return importlib.import_module(f"stratanet2_tpu_torch.cli.{module}").main(list(argv))


def case_group(device, cfgs) -> Dict:
    """What a rank reads of its group: rank, world, its host slice, the
    memoized meshes, `point_sharded_eligible` of each config and the first
    draws of its dropout generator."""
    from stratanet2_tpu_torch.learning.train import point_sharded_eligible, rank_generator

    w = multihost.world_size()
    mesh = make_mesh_2d(1, w)
    return dict(rank=multihost.rank(), world=w, slice=multihost.host_batch_slice(4 * w),
                dropout_draws=_np(torch.rand(4, generator=rank_generator(0, 1, mesh, device),
                                             device=device)),
                memoized=mesh is make_mesh_2d(1, w) and make_mesh() is make_mesh_2d(w, 1),
                point_index=mesh.point_index, batch_index=make_mesh().batch_index,
                eligible=[point_sharded_eligible(c) for c in cfgs])


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def run_cases(payload, device) -> Dict:
    """Launch target: [(key, case name, kwargs)] -> {key: the case's result},
    the cases run in order (every rank runs the same list)."""
    return {key: CASES[name](device, **kwargs) for key, name, kwargs in payload}


# ---------------------------------------------------------------------------
# the dryrun
# ---------------------------------------------------------------------------


def _dryrun_config(n: int):
    """N=256, k 8/16 (k1 and C1 = 64 divide over 2, 4 and 8 ranks), batch
    2n, no early stop."""
    from stratanet2_tpu_torch.config import Config

    cfg = Config().as_dev()
    return replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16),
                   train=replace(cfg.train, batch_size=2 * n))


def _weights(cfg, seed: int):
    from stratanet2_tpu_torch.models.pointnet2 import init_pointnet2
    from stratanet2_tpu_torch.utils.convert import to_jax_params

    return to_jax_params(init_pointnet2(torch.Generator().manual_seed(seed), cfg.model, "cpu"))


def dryrun_rank(payload, device) -> Dict:
    """A rank of `dryrun_multichip`: the same inputs on every rank (from a
    seed), each path once; returns each path's loss or mean coverage."""
    from stratanet2_tpu_torch.data.device_dataset import epoch_index_table
    from stratanet2_tpu_torch.utils.worklist import get_unprocessed_files, stem

    n = payload["n"]
    cfg = _dryrun_config(n)
    b, npts = cfg.train.batch_size, cfg.model.subsample_size
    rng = np.random.default_rng(0)
    grid = np.linspace(0.0, 20.0, 64, dtype=np.float32)
    pdfs = rng.uniform(0.05, 1.0, (3, 64)).astype(np.float32)
    params, state = _weights(cfg, 0)

    def batch(bb, nn):
        return (rng.uniform(0, 1, (bb, nn, 10)).astype(np.float32),
                rng.uniform(-10, 10, (bb, nn, 3)).astype(np.float32),
                rng.uniform(0, 1, (bb, 4)).astype(np.float32))

    out = {}
    cloud, xyz, gt = batch(b, npts)
    dp = case_data_parallel_step(device, cfg, grid, pdfs, params, state, cloud, xyz, gt, 10)
    out["dp_loss"] = dp["comps"]["total_loss"]

    p, m = 2 * b, npts + 32
    idx = epoch_index_table(p, b, seed=0, epoch=1)
    draws = [(rng.integers(0, 360, b), rng.uniform(size=b) > 0.5, rng.uniform(size=b) > 0.5,
              rng.normal(size=(b, m, 2)).astype(np.float32),
              rng.uniform(size=(b, m)).astype(np.float32)) for _ in range(idx.shape[0])]
    ep = case_device_epoch(device, cfg, grid, pdfs, params, state,
                           rng.uniform(0, 1, (p, m, 10)).astype(np.float32),
                           rng.uniform(-10, 10, (p, m, 3)).astype(np.float32),
                           np.full(p, npts + 16, np.int32),
                           rng.uniform(0, 1, (p, 4)).astype(np.float32), idx, draws)
    out["epoch_loss"] = ep["comps"]["total_loss"] / idx.shape[0]

    ps = case_point_sharded_step(device, cfg, grid, pdfs, params, state, cloud, xyz, gt, 1, n)
    out["point_sharded_loss"] = ps["comps"]["total_loss"]
    if n >= 4:
        cfg2 = replace(cfg, train=replace(cfg.train, batch_size=4))
        c2, x2, g2 = batch(4, npts)
        out["mesh_2d_loss"] = case_point_sharded_step(
            device, cfg2, grid, pdfs, params, state, c2, x2, g2, 2, n // 2)["comps"]["total_loss"]

    cp, xp, _ = batch(2, npts)
    rasters, pred_pl = case_predict(device, cfg, params, state, cp, xp,
                                    ("point_sharded",))["point_sharded"]
    if rasters.shape[0] != 2 or pred_pl.shape != (2, 4) or not np.isfinite(pred_pl).all():
        raise RuntimeError(f"point-sharded predict: {rasters.shape} {pred_pl}")
    out["predict_mean_cov"] = float(pred_pl.mean())

    with tempfile.TemporaryDirectory() as td:
        parcels = [f"parcel_{i:04d}" for i in range(37)]
        for name in parcels:
            open(os.path.join(td, name + ".pkl"), "w").close()
        for n_hosts in (2, 4, 8):
            gb = 2 * n_hosts * 3
            covered = []
            for pid in range(n_hosts):
                covered.extend(range(gb)[multihost.host_batch_slice(gb, pid, n_hosts)])
            shards = [sorted(stem(f) for f in get_unprocessed_files(
                td, os.path.join(td, "out"), host_id=pid, n_hosts=n_hosts))
                for pid in range(n_hosts)]
            if covered != list(range(gb)) or sorted(sum(shards, [])) != parcels \
                    or not all(shards):
                raise RuntimeError(f"host slices or worklist shards at {n_hosts} hosts")
    losses = [v for k, v in out.items() if k.endswith("loss")]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite losses {out}")
    if multihost.broadcast_object(out) != out:
        raise RuntimeError("the ranks disagree on the losses")
    return out


def dryrun_multichip(n: int, backend: str = "gloo", device: Optional[str] = None,
                     timeout: float = 600.0) -> Dict:
    """Run every parallel path once on `n` ranks; the summary of rank 0.
    `device` defaults to the card (rank r on "cuda:r") and raises without
    one; "cpu" runs the ranks on the CPU, "cuda:0" puts every rank on one
    card."""
    device = str(resolve_device(device))
    if torch.device(device).type == "cuda":
        from stratanet2_tpu_torch.ops import _build

        _build.build_all()  # once, before the ranks start
    from stratanet2_tpu_torch.parallel.launch import run_ranks

    out = run_ranks(n, "stratanet2_tpu_torch.parallel.dryrun:dryrun_rank", {"n": n},
                    backend=backend, device=device, timeout=timeout)[0]
    print(f"dryrun_multichip OK: {n} ranks ({backend}, {device}), "
          + ", ".join(f"{k}={v:.4f}" for k, v in out.items()), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="every parallel path once, on n ranks")
    p.add_argument("n", type=int)
    p.add_argument("--backend", default="gloo", choices=multihost.BACKENDS)
    p.add_argument("--device", default=None,
                   help="cpu, cuda:N (every rank on that card) or cuda (default: a card a rank)")
    p.add_argument("--timeout", type=float, default=600.0)
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.backend, a.device, a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
