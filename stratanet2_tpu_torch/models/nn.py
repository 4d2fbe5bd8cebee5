"""Building blocks of the port's PointNet2 (counterpart of
`stratanet2_tpu/models/nn.py`): Linear, eval-mode BatchNorm and the
Linear -> ReLU -> BatchNorm MLP of the reference (model/point_net2.py:45-53).

Layout follows the JAX package: a Linear holds `w` as (in, out), so the
converter maps leaves one to one and the fused SA route can split W1 by
rows. BatchNorm keeps `scale`/`bias` as parameters and `mean`/`var` as
buffers (eps 1e-5); eval normalises as (x - mean) * (rsqrt(var + eps) *
scale) + bias, the JAX order. The masked batch statistics of training come
with the train slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

BN_EPS = 1e-5


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_in, n_out))
        self.b = nn.Parameter(torch.empty(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch.nn.Linear's default init: W, b ~ U(+-1/sqrt(fan_in))."""
        bound = 1.0 / float(self.w.shape[0]) ** 0.5
        for t in (self.w, self.b):
            t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)


class BatchNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval BN as a per-channel affine x*a + c: a = scale*rsqrt(var+eps),
        c = bias - mean*a (stratanet2_tpu/models/pointnet2.py:273-277)."""
        a = self.scale * torch.rsqrt(self.var + BN_EPS)
        return a, self.bias - self.mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * (torch.rsqrt(self.var + BN_EPS) * self.scale) + self.bias


class Layer(nn.Module):
    """Linear -> ReLU -> BatchNorm."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.linear = Linear(n_in, n_out)
        self.bn = BatchNorm(n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(torch.relu(self.linear(x)))


class MLP(nn.Module):
    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(channels[i - 1], channels[i]) for i in range(1, len(channels))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
