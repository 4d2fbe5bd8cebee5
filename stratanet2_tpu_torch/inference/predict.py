"""Serve step (counterpart of `stratanet2_tpu/inference/predict.py::
make_predict_step`): forward, raster projection and plotwise coverages of a
batch of plot clouds. The parcel loop around it (`predict_parcel`) comes
with a later slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.device import resolve_device
from stratanet2_tpu_torch.models.pointnet2 import PointNet2
from stratanet2_tpu_torch.ops.projection import (
    batched_raster_projection,
    plotwise_coverages,
)


def make_predict_step(cfg: Config, device: Optional[Union[str, torch.device]] = None):
    """Return step(model, cloud, xyz) -> (rasters (B, 3, P, P), pred_pl (B, 4)).

    `cloud` is (B, N, 10) with the rescaled x, y in its first two columns,
    `xyz` (B, N, 3) centred positions in metres (arrays or tensors, any
    float type; computed in float32 on `device`, default CUDA). `model` must
    already be on that device. The model runs in eval mode, as JAX's
    `train=False` does (running BN statistics, the fused SA eval kernel),
    and is left in the mode the caller had it in."""
    mcfg = cfg.model
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(model: PointNet2, cloud, xyz):
        param = next(model.parameters())
        if param.device.type != dev.type:
            raise ValueError(f"model is on {param.device}, the step runs on {dev}")
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

    return step
