"""Train step, eval step and the training loop (counterpart of
`stratanet2_tpu/learning/train.py`, reference learning/train.py).

- `make_train_step` (train.py:81-130): forward in train mode, in-graph plot
  projection, the 3-term loss, backward, one Adam update and one step of
  the learning-rate schedule.
- `make_eval_step` (train.py:179-200): the eval-mode forward with the SA3
  global feature, plot coverages and the per-plot loss parts of
  `_eval_per_item` (train.py:133-154); `make_eval_core` (:157-176), its
  per-plot outputs alone, for the device-resident eval.
- `train_one_epoch` (train.py:203-255): the epoch over `PlotLoader`'s
  shuffled batches; the loss parts are summed on the device and read once,
  at the end of the epoch. `train_one_epoch_device_resident` (:260-288):
  the epoch over a fold on the card (`data/device_dataset.py`), read once.
- `EarlyStopper` and `train_full` (train.py:300-340, 414-699): one fold with
  periodic evaluation, early stopping, the best checkpoint, a `.resume`
  checkpoint after every eval and `resume=True` to continue from it, and a
  final eval on the best or last weights; on the device-resident path when
  JAX's would take it (`use_device_resident`), else on the host loader's.

The parallel paths (train.py:203-258, 393-535): given a data-parallel mesh
(`parallel/mesh.make_mesh`) each rank steps on its rows of every batch and
the gradients are all-reduced; with `point_sharded` (and more than one
rank, `point_sharded_eligible`) every rank steps on its shard of every
cloud's points (`parallel/point_sharded.make_point_sharded_train_step`).
Rank 0 is the one writer: it evaluates, decides early stopping and resume,
writes checkpoints and metrics, and broadcasts each decision.

Optimizer parity: optax `add_decayed_weights(wd)` -> `scale_by_adam` adds
wd * param to the gradient before the moments (coupled L2), which is
`torch.optim.Adam(weight_decay=wd)`; the staircase `exponential_decay` is
lr * lr_decay ** (u // (steps_per_epoch * step_size)) at the u-th update,
counted from 0 before the update, as optax counts.

Dropout (`ModelConfig.drop` > 0), and on the device-resident path each
batch's augmentation and subsample, draw from a `torch.Generator`: the one
of epoch e is seeded from (seed + 1, e) alone, as JAX folds e into
PRNGKey(seed + 1), so a resumed run draws what an unbroken one draws. A
rank of a mesh draws its dropout from one seeded from (seed + 1, e, its
batch index, its point index), as JAX folds both mesh indices into the key
(point_sharded.py:488-493); the device-resident draws stay the epoch's, so
every rank samples what one process would. The
device-resident eval draws from a generator seeded from the fold's id, as
JAX's draws from PRNGKey(fold_id), so every eval of a fold subsamples alike.
torch cannot reproduce JAX's random streams: a model initialised here
(without `pretrained_path`) draws its weights from
`torch.Generator().manual_seed(seed)`.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.learning.kde import KdeMixture
from stratanet2_tpu_torch.learning.losses import (
    EPS,
    STRATA_IDX,
    entropy_terms,
    nll_terms,
    total_loss,
)
from stratanet2_tpu_torch.models.pointnet2 import (
    PointNet2,
    check_opt_ins,
    count_params,
    init_pointnet2,
)
from stratanet2_tpu_torch.ops.projection import plotwise_coverages
from stratanet2_tpu_torch.parallel import multihost
from stratanet2_tpu_torch.parallel.collectives import mean_parts, reduce_gradients
from stratanet2_tpu_torch.parallel.mesh import Mesh, replicate, shard_points
from stratanet2_tpu_torch.utils import checkpoint as ckpt
from stratanet2_tpu_torch.utils.convert import load_jax_params, to_jax_params

logger = logging.getLogger("stratanet2_tpu_torch")

TRAIN_LOSS_KEYS = ("total_loss", "MAE_loss", "log_loss", "entropy_loss")


class TrainState(NamedTuple):
    model: PointNet2
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int  # optimizer steps taken


def make_optimizer(
    cfg: Config, model: PointNet2, steps_per_epoch: int
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam over the model's parameters with coupled weight decay, and its
    staircase schedule. Call `scheduler.step()` after each
    `optimizer.step()` (the train step does)."""
    tc = cfg.train
    optimizer = torch.optim.Adam(model.parameters(), lr=tc.lr, weight_decay=tc.wd)
    period = max(steps_per_epoch * tc.step_size, 1)
    # LambdaLR evaluates the factor at 0 on construction and at u after its
    # u-th step(), so the u-th update (from 0) runs at lr_decay ** (u // period)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda u: tc.lr_decay ** (u // period)
    )
    return optimizer, scheduler


def init_train_state(
    cfg: Config,
    steps_per_epoch: int,
    seed: int = 0,
    pretrained_path: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> TrainState:
    """A model (from `pretrained_path`, a checkpoint of either package, or
    initialised from `seed`) on `device` (default CUDA), its optimizer and
    schedule, at step 0. In a process group every rank calls it, and rank 0
    alone reads the checkpoint."""
    dev = resolve_device(device)
    model = init_pointnet2(torch.Generator().manual_seed(seed), cfg.model, device=dev)
    if pretrained_path:
        payload = multihost.from_writer(lambda: ckpt.load_checkpoint(pretrained_path))
        load_jax_params(model, payload["params"], payload["model_state"])
        logger.info("Loaded pretrained weights from %s", pretrained_path)
    logger.info("Total number of parameters: %d", count_params(model))
    optimizer, scheduler = make_optimizer(cfg, model, steps_per_epoch)
    return TrainState(model, optimizer, scheduler, 0)


def _check_model_device(model: PointNet2, dev: torch.device) -> None:
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, the step runs on {dev}")


def make_train_step(
    cfg: Config,
    kde: KdeMixture,
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Mesh] = None,
):
    """Return step(model, optimizer, scheduler, cloud, xyz, gt, generator=None)
    -> the loss components {total_loss, MAE_loss, log_loss, entropy_loss}
    (detached scalars).

    `cloud` (B, N, 10) with the rescaled x, y in its first two columns and
    z / z_max in the third, `xyz` (B, N, 3) centred positions in metres, `gt`
    (B, 4) plot coverages (arrays or tensors, any float type; computed in
    float32 on `device`, default CUDA). The step puts `model` in train mode,
    leaves the parameter gradients in `.grad`, updates the BN running state,
    the parameters and the schedule. `model` and the optimizer (from
    `make_optimizer`) must already be on that device; `generator` (on that
    device) feeds the head's dropout when `cfg.model.drop` > 0.

    With a data-parallel `mesh` (batch x 1) the inputs are this rank's
    rows of the global batch (`mesh.shard_batch`): every BatchNorm and the
    fused SA route use the global batch's statistics, each rank's loss is
    its share of the global loss, the gradients are summed over the ranks
    before Adam and the returned parts are the global batch's. That is the
    single-process step on the global batch, as JAX's data-parallel step
    is, up to the order of the sums."""
    mcfg, tcfg = cfg.model, cfg.train
    dev = resolve_device(device)
    if mesh is not None and (mesh.points != 1 or tcfg.batch_size % mesh.batch):
        raise ValueError(f"a data-parallel step needs a (B x 1) mesh whose rows divide "
                         f"batch_size {tcfg.batch_size}: {mesh}")
    group = None if mesh is None else mesh.group
    kde_grid = torch.as_tensor(kde.grid, dtype=torch.float32, device=dev)
    kde_pdfs = torch.as_tensor(kde.pdfs, dtype=torch.float32, device=dev)

    def step(
        model: PointNet2, optimizer, scheduler, cloud, xyz, gt,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        _check_model_device(model, dev)
        check_opt_ins(model, mcfg)
        cloud = torch.as_tensor(cloud, device=dev).float()
        xyz = torch.as_tensor(xyz, device=dev).float()
        gt = torch.as_tensor(gt, device=dev).float()
        model.train()
        cov, proba = model(cloud[..., 2:], xyz, generator=generator, group=group)
        pred_pl = plotwise_coverages(cov, cloud[..., :2], mcfg.diam_pix)
        z_m = cloud[..., 2] * mcfg.z_max
        loss, (comps, _aux) = total_loss(
            pred_pl, gt, proba, z_m, kde_grid, kde_pdfs, tcfg.m, tcfg.e
        )
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss.backward()
        else:
            (loss / mesh.size).backward()
            reduce_gradients(model, group)
        optimizer.step()
        scheduler.step()
        return mean_parts({name: value.detach() for name, value in comps.items()}, group)

    return step


def _eval_per_item(cfg: Config, kde_grid: torch.Tensor, kde_pdfs: torch.Tensor):
    """Per-plot eval losses of a batch, each plot's as JAX's `per_item`
    computes it (train.py:137-152): (B,) loss parts and (p_all, pdf_all)."""

    def per_item(pred_pl, gt, proba, z_m):
        d = torch.stack([pred_pl[:, i] - gt[:, i] for i in STRATA_IDX], dim=1)
        l_abs_strata = torch.sqrt(d * d + EPS)  # (B, 3): a mean over one plot
        l_abs = torch.mean(l_abs_strata, dim=1)
        log_likelihood, (p_all, pdf) = nll_terms(proba, z_m, kde_grid, kde_pdfs)
        l_nll = -torch.mean(log_likelihood, dim=1)
        l_e = -torch.mean(entropy_terms(proba), dim=(1, 2))
        l_total = l_abs + cfg.train.m * l_nll + cfg.train.e * l_e
        return {
            "total_loss": l_total,
            "MAE_loss": l_abs,
            "log_loss": l_nll,
            "MAE_veg_b": l_abs_strata[:, 0],
            "MAE_veg_moy": l_abs_strata[:, 1],
            "MAE_veg_h": l_abs_strata[:, 2],
        }, (p_all, pdf)

    return per_item


def make_eval_step(
    cfg: Config, kde: KdeMixture, device: Optional[Union[str, torch.device]] = None
):
    """Return step(model, cloud, xyz, gt) -> (pred_pl (B, 4), cov (B, N, 4),
    proba (B, N, 4), loss parts {name: (B,)}, (p_all, pdf_all) (B, N, 3),
    the SA3 global feature g (B, 64)), per plot so that the caller can
    aggregate over the valid (non-padding) plots of a batch, as the
    reference's batch_size=1 eval does (learning/test.py:38-43).

    Inputs as `make_train_step`'s, on `device` (default CUDA). The model
    runs in eval mode, as JAX's `train=False` does, under
    `torch.inference_mode`, and is left in the mode the caller had it in."""
    mcfg = cfg.model
    dev = resolve_device(device)
    kde_grid = torch.as_tensor(kde.grid, dtype=torch.float32, device=dev)
    kde_pdfs = torch.as_tensor(kde.pdfs, dtype=torch.float32, device=dev)
    per_item = _eval_per_item(cfg, kde_grid, kde_pdfs)

    @torch.inference_mode()
    def step(model: PointNet2, cloud, xyz, gt):
        _check_model_device(model, dev)
        check_opt_ins(model, mcfg)
        cloud = torch.as_tensor(cloud, device=dev).float()
        xyz = torch.as_tensor(xyz, device=dev).float()
        gt = torch.as_tensor(gt, device=dev).float()
        was_training = model.training
        model.eval()
        try:
            cov, proba, g = model(cloud[..., 2:], xyz, return_embeddings=True)
        finally:
            model.train(was_training)
        pred_pl = plotwise_coverages(cov, cloud[..., :2], mcfg.diam_pix)
        z_m = cloud[..., 2] * mcfg.z_max
        comps, aux = per_item(pred_pl, gt, proba, z_m)
        return pred_pl, cov, proba, comps, aux, g

    return step


def make_eval_core(
    cfg: Config, kde: KdeMixture, device: Optional[Union[str, torch.device]] = None
):
    """Return core(model, cloud, xyz, gt) -> (pred_pl (B, 4), {loss part:
    (B,)}): `make_eval_step`'s per-plot outputs alone, for the
    device-resident eval (`data/device_dataset.make_device_eval`)."""
    step = make_eval_step(cfg, kde, device)

    def core(model: PointNet2, cloud, xyz, gt):
        pred_pl, _cov, _proba, comps, _aux, _g = step(model, cloud, xyz, gt)
        return pred_pl, comps

    return core


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The dropout generator of `epoch`, seeded from (seed + 1, epoch) alone."""
    state = np.random.SeedSequence([seed + 1, epoch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def rank_generator(seed: int, epoch: int, mesh: Optional[Mesh],
                   device: torch.device) -> torch.Generator:
    """The dropout generator of this rank in `epoch`: seeded from (seed + 1,
    epoch, its batch index, its point index) on a mesh, else
    `epoch_generator`'s."""
    if mesh is None:
        return epoch_generator(seed, epoch, device)
    state = np.random.SeedSequence(
        [seed + 1, epoch, mesh.batch_index, mesh.point_index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def shard_for(mesh: Optional[Mesh], x):
    """This rank's point shard of an array of its rows, on a mesh with more
    than one point rank."""
    if mesh is None or mesh.points == 1 or np.ndim(x) <= 2:
        return x
    return shard_points(mesh, x)


def train_one_epoch(
    train_step,
    ts: TrainState,
    loader,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch over shuffled, drop_last batches (learning/train.py:29-79).
    With a `mesh`, the loader yields this rank's rows of every batch
    (`PlotLoader(rows=...)`, the `host_batch_slice` of its batch row) and
    the step takes them and its point shard (`shard_for`), as JAX places a
    batch with batch (and point) sharding.

    The loss parts are summed on the device and read once, at the end: a
    read a batch would make the host wait for every step."""
    acc = None
    n = 0
    n_points = 0
    t0 = time.time()
    ranks = 1 if mesh is None else mesh.batch
    for batch in loader:
        comps = train_step(
            ts.model, ts.optimizer, ts.scheduler, shard_for(mesh, batch["cloud"]),
            shard_for(mesh, batch["xyz"]), shard_for(mesh, batch["coverages"]), generator,
        )
        acc = comps if acc is None else {k: acc[k] + v for k, v in comps.items()}
        n += 1
        n_points += batch["cloud"].shape[0] * batch["cloud"].shape[1] * ranks
    return _epoch_means(ts, acc, n, n_points, t0)


def _epoch_means(ts: TrainState, acc, n: int, n_points: int, t0: float):
    """The state after an epoch of n steps begun at t0, and the epoch's
    mean loss parts from their sums on the card `acc` (one read), its step
    and points/s. An empty epoch (fewer train plots than batch_size) gives
    the train schema with zeroed parts, so that logging and the fold
    statistics see the keys of a real epoch (not eval's LOSS_KEYS)."""
    if acc is None:
        sums = dict.fromkeys(TRAIN_LOSS_KEYS, 0.0)
    else:
        names = list(acc)
        sums = dict(zip(names, torch.stack([acc[k] for k in names]).tolist()))
    means = {k: float(v) / max(n, 1) for k, v in sums.items()}
    ts = ts._replace(step=ts.step + n)
    means["step"] = ts.step
    means["points_per_sec"] = round(n_points / max(time.time() - t0, 1e-9), 1)
    return ts, means


def train_one_epoch_device_resident(
    epoch_fn,
    ts: TrainState,
    dd,
    cfg: Config,
    seed: int,
    epoch: int,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch over the fold on the card, `dd`
    (`data/device_dataset.make_device_epoch`'s `epoch_fn`): the shuffled
    index table of `epoch` goes up, the draws and dropout come from
    `epoch_generator(seed, epoch)` (on a `mesh`, every rank draws the
    epoch's samples alike and its dropout from `rank_generator`), and the
    loss sums are read once."""
    from stratanet2_tpu_torch.data.device_dataset import epoch_index_table, generator_draws

    dev = dd.feats.device
    idx = epoch_index_table(len(dd.plot_ids), cfg.train.batch_size, seed, epoch)
    t0 = time.time()
    gen = epoch_generator(seed, epoch, dev)
    if mesh is None:  # one generator feeds the draws and the dropout
        sums = epoch_fn(ts.model, ts.optimizer, ts.scheduler, dd,
                        torch.from_numpy(idx).to(dev), gen)
    else:
        sums = epoch_fn(ts.model, ts.optimizer, ts.scheduler, dd,
                        torch.from_numpy(idx).to(dev), rank_generator(seed, epoch, mesh, dev),
                        generator_draws(gen))
    return _epoch_means(ts, sums, idx.shape[0], idx.size * cfg.model.subsample_size, t0)


def print_epoch_losses(epoch: int, loss_dict: Dict[str, float], train: bool):
    task = "train" if train else "test"
    logger.info(
        "Epoch %3d -> %s Loss: %1.2f %s Loss Abs (MAE): %1.2f %s Loss Log: %1.2f",
        epoch, task, loss_dict["total_loss"], task, loss_dict["MAE_loss"],
        task, loss_dict["log_loss"],
    )


class EarlyStopper:
    """Best-metric tracking + patience (model/point_net2.py:165-184)."""

    def __init__(self, cfg: Config):
        self.best_metric_value = 1e6
        self.best_metric_epoch = 1
        self.patience = cfg.train.patience_in_epochs
        self.start_epoch = cfg.train.epoch_to_start_early_stop
        self.stopped_early = False

    def should_stop(self, val_metric: float, epoch: int) -> Tuple[bool, bool]:
        """Returns (stop, improved)."""
        if val_metric < self.best_metric_value:
            self.best_metric_value = val_metric
            self.best_metric_epoch = epoch
            return False, True
        if epoch < self.start_epoch:
            return False, False
        if epoch >= self.best_metric_epoch + self.patience:
            self.stopped_early = True
            return True, False
        return False, False

    def state_dict(self) -> Dict[str, float]:
        return {
            "best_metric_value": self.best_metric_value,
            "best_metric_epoch": self.best_metric_epoch,
            # persisted so resume=True on a fold that already early-stopped
            # does not retrain past the stop point (duplicate evals/metrics)
            "stopped_early": self.stopped_early,
        }

    def load_state_dict(self, state: Dict[str, float]) -> None:
        self.best_metric_value = float(
            state.get("best_metric_value", self.best_metric_value)
        )
        self.best_metric_epoch = int(
            state.get("best_metric_epoch", self.best_metric_epoch)
        )
        self.stopped_early = bool(state.get("stopped_early", self.stopped_early))


def save_train_state(path: str, ts: TrainState, metadata: Dict) -> None:
    """`ts` as a checkpoint both packages read (`utils/checkpoint.py`)."""
    params, model_state = to_jax_params(ts.model)
    opt_state = ckpt.adam_state(ts.model, ts.optimizer, ts.scheduler)
    ckpt.save_checkpoint(path, params, model_state, opt_state, metadata=metadata)


def device_resident_bytes(dataset: Dict, train_ids, val_ids, cfg: Config) -> int:
    """JAX's estimate of a fold's footprint on the device (train.py:465-492):
    the train and val plots, each of the largest plot's rows plus its fake
    ground points (pi/4 * diam_meters^2 + 16), at least the subsample, 16
    channels of 4 bytes."""
    fake_max = int(math.pi / 4 * cfg.model.diam_meters**2) + 16
    all_ids = list(train_ids) + list(val_ids)
    m_est = max(
        cfg.model.subsample_size,
        max(
            (int(dataset[i].get("N_points_in_cloud", dataset[i]["cloud"].shape[1]))
             for i in all_ids),
            default=0,
        ) + fake_max,
    )
    return len(all_ids) * m_est * 16 * 4


def use_device_resident(dataset: Dict, train_ids, val_ids, cfg: Config) -> bool:
    """Whether `train_full` takes the device-resident path: `DataConfig.
    device_resident` "true" or "false", or for "auto" whether the estimate
    is under `device_resident_max_bytes`, as JAX's choice."""
    dr = cfg.data.device_resident
    if dr == "auto":
        return (device_resident_bytes(dataset, train_ids, val_ids, cfg)
                < cfg.data.device_resident_max_bytes)
    return dr == "true"


def point_sharded_eligible(cfg: Config) -> Tuple[bool, str]:
    """Whether point-sharded training can run in this process group:
    (ok, the reason why not). The step shards N, k1 and C1 over all ranks
    (`parallel/point_sharded.py`), so each must divide (train.py:393-411,
    which counts `jax.devices()`)."""
    n = multihost.world_size()
    if n <= 1:
        return False, "needs more than one device"
    mcfg = cfg.model
    if mcfg.subsample_size % n or mcfg.k1 % n or mcfg.n_centroids1 % n:
        return False, (
            f"needs subsample_size={mcfg.subsample_size}, k1={mcfg.k1}, "
            f"n_centroids1={mcfg.n_centroids1} all divisible by {n} devices"
        )
    return True, ""


def train_full(
    dataset: Dict,
    train_ids,
    val_ids,
    cfg: Config,
    kde: KdeMixture,
    stats_path: str,
    sink,
    fold_id: int,
    pretrained_path: Optional[str] = None,
    seed: int = 0,
    resume: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Mesh] = None,
    point_sharded: bool = False,
):
    """Full training loop for one fold (reference learning/train.py:82-177)
    on `device` (default CUDA): the train and val plots uploaded to the card
    once and each epoch's batches drawn there, where `use_device_resident`
    says so, else fed by `PlotLoader`. Figures need the per-point outputs,
    so the last eval takes `PlotLoader`'s batches on either path.

    Extends the reference with crash recovery: a `resume` checkpoint
    (params + BN state + optimizer state + epoch cursor + early-stopping
    state) is written after every eval; `resume=True` continues a killed run
    from it, and does not retrain a fold that had already stopped early.

    In a process group, every rank calls this with the same arguments:
    `mesh` (a data-parallel mesh) splits each batch's rows over the ranks;
    `point_sharded` splits each cloud's points over all ranks instead, and
    falls back to the standard path with a warning when
    `point_sharded_eligible` says no, as JAX's does. Only rank 0 evaluates
    and writes; it broadcasts the resume, each eval's losses and the early
    stop, so every rank returns the same lists.

    Returns (train_state, train_loss_dicts, test_loss_dicts, cloud_info_list).
    """
    from stratanet2_tpu_torch.data import device_dataset as D
    from stratanet2_tpu_torch.data.loader import PlotLoader
    from stratanet2_tpu_torch.learning.evaluate import evaluate
    from stratanet2_tpu_torch.utils.experiment import NullSink

    dev = resolve_device(device)
    writer = multihost.is_writer()
    if not writer:
        sink = NullSink()
    if point_sharded:
        ok, why = point_sharded_eligible(cfg)
        if not ok:
            logger.warning(
                "point-sharded training unavailable (%s); using the standard path%s", why,
                f" (data-parallel over {mesh.size} devices)" if mesh is not None else "",
            )
            point_sharded = False
    device_data = (use_device_resident(dataset, train_ids, val_ids, cfg) and not point_sharded
                   and (mesh is None or cfg.train.batch_size % mesh.size == 0))
    if point_sharded:
        from stratanet2_tpu_torch.parallel.mesh import make_mesh_2d
        from stratanet2_tpu_torch.parallel.point_sharded import make_point_sharded_train_step

        # the point-sharded step owns its (1, D) mesh; a data-parallel mesh
        # the caller passed places nothing
        mesh = make_mesh_2d(1, multihost.world_size())
        train_step = make_point_sharded_train_step(cfg, kde, mesh, dev)
        logger.info("Point-sharded training over %d devices", mesh.size)
    else:
        train_step = make_train_step(cfg, kde, device=dev, mesh=mesh)
    # on the host path each rank loads its rows of every batch alone
    train_loader = PlotLoader(
        dataset, cfg, plot_ids=train_ids, train=True, seed=seed,
        rows=None if mesh is None else multihost.host_batch_slice(
            cfg.train.batch_size, mesh.batch_index, mesh.batch))
    steps_per_epoch = max(len(train_loader), 1)
    eval_step = make_eval_step(cfg, kde, device=dev)
    ts = init_train_state(cfg, steps_per_epoch, seed=seed, pretrained_path=pretrained_path,
                          device=dev)
    device_eval = None
    if device_data:
        dd = D.build_device_dataset(dataset, list(train_ids), cfg.model, dev)
        if mesh is not None:
            dd = D.replicate_device_dataset(mesh, dd)
        epoch_fn = D.make_device_epoch(cfg, train_step, mesh=mesh)
        logger.info(
            "Device-resident dataset: %d plots x %d rows (%.1f MB)%s",
            dd.feats.shape[0], dd.feats.shape[1],
            (dd.feats.numel() + dd.xyz.numel()) * 4 / 1e6,
            f", data-parallel over {mesh.size} devices" if mesh is not None else "",
        )
        if len(val_ids) and writer:
            dd_val = D.build_device_dataset(dataset, list(val_ids), cfg.model, dev)
            device_eval = (D.make_device_eval(cfg, make_eval_core(cfg, kde, dev)), dd_val)

    stopper = EarlyStopper(cfg)
    ckpt_path = os.path.join(stats_path, ckpt.checkpoint_name(fold_id))
    resume_path = ckpt_path + ".resume"

    start_epoch = 1
    # rank 0 decides, reads the file and sends its payload to every rank
    if multihost.broadcast_object(resume and os.path.exists(resume_path)):
        payload = multihost.from_writer(lambda: ckpt.load_checkpoint(resume_path))
        load_jax_params(ts.model, payload["params"], payload["model_state"])
        ckpt.load_adam_state(ts.model, ts.optimizer, ts.scheduler, payload["opt_state"])
        ts = ts._replace(step=int(payload["metadata"].get("step", 0)))
        start_epoch = payload["metadata"].get("epoch", 0) + 1
        train_loader.epoch = start_epoch - 1  # keep the shuffle schedule aligned
        # without the early-stopping state a resumed run would reset the
        # best value to 1e6 and overwrite a better best checkpoint
        stopper.load_state_dict(payload["metadata"].get("stopper", {}))
        if cfg.train.use_early_stopping and stopper.stopped_early:
            logger.info(
                "Fold %d already early-stopped at epoch %d; skipping training",
                fold_id, start_epoch - 1,
            )
            start_epoch = cfg.train.n_epoch + 1
        logger.info("Resuming fold %d from epoch %d", fold_id, start_epoch)
    if mesh is not None:
        replicate(mesh, ts.model)
        if not point_sharded:
            logger.info("Data-parallel training over %d devices", mesh.size)

    all_train_losses: List[Dict] = []
    all_test_losses: List[Dict] = []
    current_epoch = start_epoch - 1
    for current_epoch in range(start_epoch, cfg.train.n_epoch + 1):
        sink.set_epoch(current_epoch)
        t0 = time.time()
        with sink.context(f"fold_{fold_id}_train"):
            if device_data:
                ts, train_losses = train_one_epoch_device_resident(
                    epoch_fn, ts, dd, cfg, seed, current_epoch, mesh
                )
            else:
                ts, train_losses = train_one_epoch(
                    train_step, ts, train_loader,
                    rank_generator(seed, current_epoch, mesh, dev), mesh,
                )
            train_losses["epoch"] = current_epoch
            train_losses["epoch_seconds"] = time.time() - t0
            print_epoch_losses(current_epoch, train_losses, train=True)
            sink.log_metrics(train_losses, epoch=current_epoch, step=train_losses["step"])
            all_train_losses.append(train_losses)

        if (current_epoch % cfg.train.n_epoch_test == 0) or (
            current_epoch > cfg.train.epoch_to_start_early_stop
        ):
            stop, test_losses = False, None
            if writer:
                with sink.context(f"fold_{fold_id}_val"):
                    test_losses, stop = _eval_and_save(
                        ts, dataset, val_ids, cfg, kde, eval_step, stats_path, sink, fold_id,
                        current_epoch, device_eval, dev, stopper, ckpt_path, resume_path,
                    )
            stop, test_losses = multihost.broadcast_object((stop, test_losses))
            all_test_losses.append(test_losses)
            if stop:
                logger.info("Early stopping at epoch %d", current_epoch)
                break

    # final eval with the best or the last weights (learning/train.py:154-176)
    if multihost.broadcast_object(cfg.train.use_early_stopping and os.path.exists(ckpt_path)):
        payload = multihost.from_writer(lambda: ckpt.load_checkpoint(ckpt_path))
        load_jax_params(ts.model, payload["params"], payload["model_state"])
        logger.info(
            "Loaded best model of epoch %d for final inference",
            payload["metadata"].get("best_metric_epoch", -1),
        )
    elif writer:
        save_train_state(ckpt_path, ts, {"fold_id": fold_id, "epoch": current_epoch})

    test_losses = cloud_info_list = None
    if writer:
        with sink.context(f"fold_{fold_id}_val"):
            test_losses, cloud_info_list = evaluate(
                ts.model, dataset, val_ids, cfg, kde, eval_step, stats_path, sink,
                fold_id=fold_id, epoch=current_epoch, last_epoch=True, device=dev,
            )
            test_losses["epoch"] = current_epoch
            test_losses["step"] = ts.step
            print_epoch_losses(current_epoch, test_losses, train=False)
    test_losses, cloud_info_list = multihost.broadcast_object((test_losses, cloud_info_list))
    all_test_losses.append(dict(test_losses))

    return ts, all_train_losses, all_test_losses, cloud_info_list


def _eval_and_save(ts, dataset, val_ids, cfg, kde, eval_step, stats_path, sink, fold_id,
                   epoch, device_eval, dev, stopper, ckpt_path, resume_path):
    """An eval of `train_full`'s loop, its early-stopping decision and its
    checkpoints: (test losses, stop)."""
    from stratanet2_tpu_torch.learning.evaluate import evaluate

    test_losses, _ = evaluate(
        ts.model, dataset, val_ids, cfg, kde, eval_step, stats_path, sink,
        fold_id=fold_id, epoch=epoch, device_eval=device_eval, device=dev,
    )
    test_losses["epoch"] = epoch
    test_losses["step"] = ts.step
    print_epoch_losses(epoch, test_losses, train=False)
    sink.log_metrics(test_losses, epoch=epoch, step=test_losses["step"])

    stop = False
    if cfg.train.use_early_stopping:
        stop, improved = stopper.should_stop(test_losses["total_loss"], epoch)
        if improved:
            save_train_state(ckpt_path, ts, {
                "best_metric_epoch": stopper.best_metric_epoch,
                "best_metric_value": stopper.best_metric_value,
                "fold_id": fold_id,
            })
    # after this epoch's eval and should_stop, so the saved early-stopping
    # state is never one eval stale
    save_train_state(resume_path, ts, {
        "epoch": epoch,
        "step": ts.step,
        "fold_id": fold_id,
        "stopper": stopper.state_dict(),
    })
    return test_losses, stop
