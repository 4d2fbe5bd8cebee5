"""Synthetic serve inputs and random models for `chip_smoke.py`: made on
the device from a seed, with no data files."""

from __future__ import annotations

from typing import Tuple

import torch

from stratanet2_tpu_torch.config import ModelConfig
from stratanet2_tpu_torch.models.nn import BatchNorm
from stratanet2_tpu_torch.models.pointnet2 import PointNet2, init_pointnet2


def serve_batch(
    b: int, n: int, generator: torch.Generator, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 10) clouds and (B, N, 3) positions as the data layer hands them
    to the serve step: xyz centred metres over a 20 m plot (z up to 3 m),
    cloud = [x/10, y/10, z/z_max, 7 features in [0, 1]]. `generator` lives on
    `device`."""
    xy = torch.rand((b, n, 2), generator=generator, device=device) * 20 - 10
    z = torch.rand((b, n, 1), generator=generator, device=device) * 3
    feats = torch.rand((b, n, 7), generator=generator, device=device)
    return torch.cat([xy / 10, z / ModelConfig.z_max, feats], -1), torch.cat([xy, z], -1)


@torch.no_grad()
def random_model(cfg: ModelConfig, seed: int, device: torch.device) -> PointNet2:
    """`init_pointnet2` weights from `seed`, with BN scale/bias and running
    statistics drawn as well, so that the eval BN fold does real work."""
    gen = torch.Generator().manual_seed(seed)
    model = init_pointnet2(gen, cfg, device="cpu")
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            c = mod.mean.shape[0]
            mod.scale.copy_(torch.rand(c, generator=gen) + 0.5)
            mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
            mod.mean.copy_(torch.randn(c, generator=gen) * 0.1)
            mod.var.copy_(torch.rand(c, generator=gen) + 0.5)
    return model.to(device).eval()
