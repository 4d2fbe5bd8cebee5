"""Device-resident training dataset (counterpart of
`stratanet2_tpu/data/device_dataset.py`): a fold's plots live on the card and
each batch's augmentation and subsample are drawn there, so that an epoch
sends one (nb, B) index table to the card and reads its summed loss parts
once, and an eval reads its per-plot results once.

Semantics of the JAX module (its docstring, :1-38):

  build (host, once a fold): center in float64 -> fake ground points -> xyz
    snapshot -> feature rescale, each plot cycle-padded to the common M rows
    (row n + j repeats row j mod n). The rescale comes before augmentation:
    x and y share the /10 scale, so the rotation and the flips commute with
    it, and the clipped xy feature noise of the host loader (sigma 0.1 m,
    clip 0.3 m) is sigma 0.01, clip 0.03 in scaled units.

  sample (card, each batch): a rotation by a whole degree and x/y flips
    shared by features and positions, clipped Gaussian xy noise on the
    features only, then the subsample: one uniform key a row, originals
    keyed in [-1, 0) and cycled copies in [0, 1), the N smallest kept.
    * n >= N: N distinct originals, a uniform N-subset.
    * n < N: every original plus N - n distinct copies (repeats drawn
      without replacement; the host loader draws them with replacement).

The TPU layout is not copied: JAX sorts every channel by the keys because
TPU gathers serialize. Here the keys are sorted (`torch.sort(stable=True)`,
so tied keys go to the lower row) and the N rows are gathered by index, and
the rotation, flips and noise are applied to those N rows only (each is
elementwise in the row, so the values are the same).

A sample is a pure function of its draws (`Draws`): each plot's whole-degree
angle, two flips, (M, 2) noise and (M,) keys. `generator_draws` makes them
from a `torch.Generator` on the card; the tests pass draws that JAX made, so
that both packages sample the same rows.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stratanet2_tpu_torch.config import Config, ModelConfig
from stratanet2_tpu_torch.data.transforms import (
    add_fake_empty_ground_points,
    center_cloud,
    rescale_cloud,
)
from stratanet2_tpu_torch.device import resolve_device

__all__ = [
    "DeviceDataset",
    "Draws",
    "build_device_dataset",
    "generator_draws",
    "select_rows",
    "augment_subsample",
    "make_device_sampler",
    "make_device_epoch",
    "replicate_device_dataset",
    "make_device_eval",
    "eval_index_table",
    "epoch_index_table",
]

NOISE_STD, NOISE_CLIP = 0.01, 0.03  # scaled units: 0.1 m and 0.3 m over the /10 of x, y


class DeviceDataset(NamedTuple):
    """A fold's plots on the card (P * M * 13 * 4 bytes)."""

    feats: torch.Tensor  # (P, M, F) rescaled features, cycle-padded
    xyz: torch.Tensor  # (P, M, 3) centered positions in metres, cycle-padded
    n: torch.Tensor  # (P,) int32 point counts before the padding
    coverages: torch.Tensor  # (P, 4) GT, or (P, 0) when absent (SSL)
    plot_ids: Tuple[str, ...]  # axis 0's plots


class Draws(NamedTuple):
    """The random inputs of one batch's sample. The augmentation fields are
    None for an eval batch."""

    angle: Optional[torch.Tensor]  # (B,) whole degrees in [0, 360)
    flip_x: Optional[torch.Tensor]  # (B,) bool
    flip_y: Optional[torch.Tensor]  # (B,) bool
    noise: Optional[torch.Tensor]  # (B, M, 2) standard normal
    u: torch.Tensor  # (B, M) uniform in [0, 1)


# (batch index, B, M, train) -> that batch's draws
DrawSource = Callable[[int, int, int, bool], Draws]


def _cycle_pad(arr: np.ndarray, m: int) -> np.ndarray:
    """Pad (n, C) to (m, C) with rows j mod n: every padding row is a real
    point."""
    n = arr.shape[0]
    if n >= m:
        return arr[:m]
    reps = np.arange(m - n) % n
    return np.concatenate([arr, arr[reps]], axis=0)


def build_device_dataset(
    dataset: Dict[str, Dict],
    plot_ids: Sequence[str],
    mcfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> DeviceDataset:
    """Once a fold, on the host: each plot's deterministic prefix of the
    loader's pipeline (center -> fake points -> rescale), cycle-padded to
    the common M, then one upload to `device` (default CUDA)."""
    dev = resolve_device(device)
    feats_l, xyz_l, n_l, cov_l = [], [], [], []
    m = mcfg.subsample_size
    prepared = []
    for pid in plot_ids:
        data = dataset[pid]
        # center in float64 like the host loader (absolute coordinates lose
        # ~0.25 m in float32), then float32 for the card's table
        cloud = np.asarray(data["cloud"], np.float64)
        cloud = center_cloud(cloud, data["plot_center"]).astype(np.float32)
        cloud = add_fake_empty_ground_points(cloud, mcfg.diam_meters, mcfg.n_input_feats)
        xyz = cloud[:3].copy()
        cloud = rescale_cloud(cloud, mcfg.z_max)
        cov = np.asarray(data.get("coverages", np.empty(0)), np.float32)
        prepared.append((cloud.T, xyz.T, cov))
        m = max(m, cloud.shape[1])
    for cloud_t, xyz_t, cov in prepared:
        n_l.append(cloud_t.shape[0])
        feats_l.append(_cycle_pad(cloud_t, m))
        xyz_l.append(_cycle_pad(xyz_t, m))
        cov_l.append(cov)
    # 4 values = supervised GT, none = SSL; anything else is malformed and
    # would otherwise turn the whole table into (P, 0) without a word
    bad = [pid for pid, c in zip(plot_ids, cov_l) if c.size not in (0, 4)]
    n_with_gt = sum(c.size == 4 for c in cov_l)
    if bad or 0 < n_with_gt < len(cov_l):
        bad = bad or [pid for pid, c in zip(plot_ids, cov_l) if c.size != 4]
        raise ValueError(
            f"{len(bad)} of {len(plot_ids)} plots have malformed or missing "
            f"coverages (expected 4 values, or none for SSL): {bad[:5]}"
        )
    covs = (
        np.stack(cov_l)
        if cov_l and n_with_gt == len(cov_l)
        else np.zeros((len(plot_ids), 0), np.float32)
    )
    return DeviceDataset(
        feats=torch.from_numpy(np.stack(feats_l)).to(dev),
        xyz=torch.from_numpy(np.stack(xyz_l)).to(dev),
        n=torch.from_numpy(np.asarray(n_l, np.int32)).to(dev),
        coverages=torch.from_numpy(covs).to(dev),
        plot_ids=tuple(plot_ids),
    )


def generator_draws(generator: torch.Generator) -> DrawSource:
    """The port's draws, from `generator` on the dataset's device; an eval
    batch draws only its keys."""

    def draws(i: int, b: int, m: int, train: bool) -> Draws:
        dev = generator.device
        if not train:
            return Draws(None, None, None, None,
                         torch.rand(b, m, generator=generator, device=dev))
        angle = torch.randint(0, 360, (b,), generator=generator, device=dev)
        flips = torch.rand(2, b, generator=generator, device=dev) > 0.5
        noise = torch.randn(b, m, 2, generator=generator, device=dev)
        u = torch.rand(b, m, generator=generator, device=dev)
        return Draws(angle, flips[0], flips[1], noise, u)

    return draws


def select_rows(n: torch.Tensor, u: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, n_out) rows of each plot: the n_out smallest keys, originals
    (row < n) keyed u - 1, cycled copies u."""
    pos = torch.arange(u.shape[1], device=u.device)
    order = torch.where(pos < n[:, None], u - 1.0, u)
    return torch.sort(order, dim=1, stable=True).indices[:, :n_out]


def augment_subsample(
    feats: torch.Tensor,
    xyz: torch.Tensor,
    n: torch.Tensor,
    plot_idx: torch.Tensor,
    draws: Draws,
    n_out: int,
    train: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plots `plot_idx` (B,) of a table of (P, M, F) features, (P, M, 3)
    positions and (P,) counts, each subsampled to n_out rows and, in
    training, rotated, flipped and its features' xy noised (JAX's
    `_augment_subsample_one` of each plot): (B, n_out, F) and (B, n_out, 3)."""
    idx = select_rows(n[plot_idx], draws.u, n_out)
    feats, xyz = feats[plot_idx[:, None], idx], xyz[plot_idx[:, None], idx]
    if train:
        # np.radians(rng.choice(360)): a whole-degree rotation
        angle = draws.angle.to(torch.float32) * (math.pi / 180)
        c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
        sx = torch.where(draws.flip_x, -1.0, 1.0)[:, None]
        sy = torch.where(draws.flip_y, -1.0, 1.0)[:, None]

        def rot(xy):
            # transforms.rotate_around_z: [x, y] @ [[c, -s], [s, c]]
            x, y = xy[..., 0], xy[..., 1]
            return torch.stack([(x * c + y * s) * sx, (-x * s + y * c) * sy], -1)

        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        noise = torch.clamp(NOISE_STD * draws.noise[rows, idx], -NOISE_CLIP, NOISE_CLIP)
        feats = torch.cat([rot(feats[..., :2]) + noise, feats[..., 2:]], -1)
        xyz = torch.cat([rot(xyz[..., :2]), xyz[..., 2:]], -1)
    return feats, xyz


def make_device_sampler(mcfg: ModelConfig, train: bool):
    """sample(dd, plot_idx (B,) on the card, draws) -> a batch with the
    PlotLoader schema's cloud, xyz and coverages, on the card."""

    def sample(dd: DeviceDataset, plot_idx: torch.Tensor, draws: Draws) -> Dict[str, torch.Tensor]:
        cloud, xyz = augment_subsample(dd.feats, dd.xyz, dd.n, plot_idx, draws,
                                       mcfg.subsample_size, train)
        return {"cloud": cloud, "xyz": xyz, "coverages": dd.coverages[plot_idx]}

    return sample


def replicate_device_dataset(mesh, dd: DeviceDataset) -> DeviceDataset:
    """The tables of rank 0 on every rank of `mesh` (device_dataset.py:191):
    each rank builds its own from the same plots, and the broadcast makes
    them equal bit for bit. `plot_ids` is host metadata and passes."""
    from stratanet2_tpu_torch.parallel.mesh import replicate

    replicate(mesh, [dd.feats, dd.xyz, dd.n, dd.coverages])
    return dd


def _rows(draws: Draws, lo: int, hi: int) -> Draws:
    return Draws(*(None if f is None else f[lo:hi] for f in draws))


def make_device_epoch(cfg: Config, train_step, mesh=None):
    """epoch(model, optimizer, scheduler, dd, idx_table, generator,
    draws=None) -> the loss parts summed over the epoch, on the card (None
    for an empty table).

    One training epoch over the (nb, B) plot-index table on the card: each
    batch is sampled there (`draws`, by default `generator_draws(generator)`)
    and taken by `train_step` (`learning/train.make_train_step`), whose
    dropout draws from `generator`. Nothing is read back inside the epoch.

    With a data-parallel `mesh` (device_dataset.py:241-300) every rank holds
    the tables, is given the same index table and the same draws as one
    process, and samples and steps on its column slice of each batch;
    `train_step` is the mesh's data-parallel step."""
    sample = make_device_sampler(cfg.model, train=True)
    if mesh is not None and cfg.train.batch_size % mesh.size:
        raise ValueError(f"batch_size {cfg.train.batch_size} must divide over "
                         f"{mesh.size} devices")

    def epoch(model, optimizer, scheduler, dd: DeviceDataset, idx_table: torch.Tensor,
              generator: torch.Generator, draws: Optional[DrawSource] = None):
        draws = draws or generator_draws(generator)
        b, m = idx_table.shape[1], dd.feats.shape[1]
        lo, hi = 0, b
        if mesh is not None:
            lo, hi = mesh.batch_index * b // mesh.batch, (mesh.batch_index + 1) * b // mesh.batch
        sums = None
        for i in range(idx_table.shape[0]):
            batch = sample(dd, idx_table[i, lo:hi], _rows(draws(i, b, m, True), lo, hi))
            comps = train_step(model, optimizer, scheduler, batch["cloud"], batch["xyz"],
                               batch["coverages"], generator)
            sums = comps if sums is None else {k: sums[k] + v for k, v in comps.items()}
        return sums

    return epoch


def make_device_eval(cfg: Config, eval_core):
    """run(model, dd, idx_table, generator, draws=None) -> (pred_pl (nb, B,
    4), {loss part: (nb, B)}), on the card.

    The validation pass over the (nb, B) table (`eval_index_table`): each
    batch subsampled without augmentation from `draws` (by default
    `generator_draws(generator)`; the caller fixes the generator a fold, so
    every eval of the fold sees the same subsample) and taken by
    `eval_core` (`learning/train.make_eval_core`)."""
    sample = make_device_sampler(cfg.model, train=False)

    def run(model, dd: DeviceDataset, idx_table: torch.Tensor, generator: torch.Generator,
            draws: Optional[DrawSource] = None):
        draws = draws or generator_draws(generator)
        b, m = idx_table.shape[1], dd.feats.shape[1]
        preds, comps = [], []
        for i in range(idx_table.shape[0]):
            batch = sample(dd, idx_table[i], draws(i, b, m, False))
            pred_pl, parts = eval_core(model, batch["cloud"], batch["xyz"], batch["coverages"])
            preds.append(pred_pl)
            comps.append(parts)
        return torch.stack(preds), {k: torch.stack([c[k] for c in comps]) for k in comps[0]}

    return run


def eval_index_table(n_plots: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential val table padded to a batch multiple: ((nb, B) int32 plot
    indices, (nb*B,) bool valid mask). Padding repeats plot 0; the mask
    drops the duplicates when the host aggregates."""
    nb = -(-n_plots // batch_size)
    idx = np.zeros(nb * batch_size, np.int32)
    idx[:n_plots] = np.arange(n_plots, dtype=np.int32)
    valid = np.zeros(nb * batch_size, bool)
    valid[:n_plots] = True
    return idx.reshape(nb, batch_size), valid


def epoch_index_table(n_plots: int, batch_size: int, seed: int, epoch: int) -> np.ndarray:
    """Shuffled drop_last batch table, with the schedule of PlotLoader's
    epochs (a generator seeded from seed + epoch)."""
    ids = np.arange(n_plots)
    rng = np.random.default_rng(seed + epoch)
    rng.shuffle(ids)
    nb = n_plots // batch_size
    return ids[: nb * batch_size].reshape(nb, batch_size).astype(np.int32)
