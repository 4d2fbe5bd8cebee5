"""Train step (counterpart of `stratanet2_tpu/learning/train.py::
make_optimizer` and `make_train_step`, train.py:49-130): forward in train
mode, in-graph plot projection, the 3-term loss, backward, one Adam update
and one step of the learning-rate schedule. The epoch loop around it comes
with a later slice.

Optimizer parity: optax `add_decayed_weights(wd)` -> `scale_by_adam` adds
wd * param to the gradient before the moments (coupled L2), which is
`torch.optim.Adam(weight_decay=wd)`; the staircase `exponential_decay` is
lr * lr_decay ** (u // (steps_per_epoch * step_size)) at the u-th update,
counted from 0 before the update, as optax counts.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.learning.kde import KdeMixture
from stratanet2_tpu_torch.learning.losses import total_loss
from stratanet2_tpu_torch.models.pointnet2 import PointNet2
from stratanet2_tpu_torch.ops.projection import plotwise_coverages


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


def make_train_step(
    cfg: Config, kde: KdeMixture, device: Optional[Union[str, torch.device]] = None
):
    """Return step(model, optimizer, scheduler, cloud, xyz, gt) -> the loss
    components {total_loss, MAE_loss, log_loss, entropy_loss} (detached
    scalars).

    `cloud` (B, N, 10) with the rescaled x, y in its first two columns and
    z / z_max in the third, `xyz` (B, N, 3) centred positions in metres, `gt`
    (B, 4) plot coverages (arrays or tensors, any float type; computed in
    float32 on `device`, default CUDA). The step puts `model` in train mode,
    leaves the parameter gradients in `.grad`, updates the BN running state,
    the parameters and the schedule. `model` and the optimizer (from
    `make_optimizer`) must already be on that device."""
    mcfg, tcfg = cfg.model, cfg.train
    dev = resolve_device(device)
    kde_grid = torch.as_tensor(kde.grid, dtype=torch.float32, device=dev)
    kde_pdfs = torch.as_tensor(kde.pdfs, dtype=torch.float32, device=dev)

    def step(model: PointNet2, optimizer, scheduler, cloud, xyz, gt) -> Dict[str, torch.Tensor]:
        param = next(model.parameters())
        if param.device.type != dev.type:
            raise ValueError(f"model is on {param.device}, the step runs on {dev}")
        cloud = torch.as_tensor(cloud, device=dev).float()
        xyz = torch.as_tensor(xyz, device=dev).float()
        gt = torch.as_tensor(gt, device=dev).float()
        model.train()
        cov, proba = model(cloud[..., 2:], xyz)
        pred_pl = plotwise_coverages(cov, cloud[..., :2], mcfg.diam_pix)
        z_m = cloud[..., 2] * mcfg.z_max
        loss, (comps, _aux) = total_loss(
            pred_pl, gt, proba, z_m, kde_grid, kde_pdfs, tcfg.m, tcfg.e
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {name: value.detach() for name, value in comps.items()}

    return step
