"""Building blocks of the port's PointNet2 (counterpart of
`stratanet2_tpu/models/nn.py`): Linear, BatchNorm and the
Linear -> ReLU -> BatchNorm MLP of the reference (model/point_net2.py:45-53).

Layout follows the JAX package: a Linear holds `w` as (in, out), so the
converter maps leaves one to one and the fused SA route can split W1 by
rows. BatchNorm keeps `scale`/`bias` as parameters and `mean`/`var` as
buffers (eps 1e-5); eval normalises as (x - mean) * (rsqrt(var + eps) *
scale) + bias, the JAX order.

In train mode BatchNorm normalises with masked batch statistics over all
leading axes, as `nn.batchnorm(train=True)` does (nn.py:49-115): shifted
one-pass sums with the shift equal to the running mean before the update,
the biased variance to normalise, the unbiased one (n / max(n - 1, 1)) into
the running state, momentum 0.1. A mask broadcastable to x.shape[:-1] is
broadcast before counting. The new running statistics are computed from
the same forward and bound to the buffers as new tensors, so nothing that
autograd saved is modified in place.

A Linear computes in float32 or, given `dtype="bfloat16"` (the model's
`compute_dtype`), as JAX's `nn.linear` does (nn.py:37-40): both operands
rounded to bfloat16 and their product summed in float32, then the float32
bias. Its gradients round as JAX's VJP of that dot does: dx = bf16(g @
f32(w_bf16)^T) and dw = bf16(f32(x_bf16)^T @ g), each widened to float32,
with the cotangent g itself left in float32; db is the float32 sum of g.
Every tensor it returns is float32, and it uses no autocast. The products of
two bfloat16 values are exact in float32, so the float32 matmul of the
widened operands is that bfloat16 product, as long as float32 matmuls do
not run in TF32 (PyTorch's default, `torch.backends.cuda.matmul.
allow_tf32`). cuBLAS's bfloat16 GEMM with a float32 output computes the
same sums in another order, faster on the card (PERF.md); the
widened form is kept because the CPU has no kernel for it.

Given a process group, train-mode BatchNorm sums n and the two sums over
its ranks before normalising (`parallel/collectives.sum_across`), as JAX's
`nn.batchnorm(axis_names=...)` psums them (nn.py:96-99): every rank then
normalises with the global batch statistics. Summing data that is
replicated on some ranks scales the sums and the count alike.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from stratanet2_tpu_torch.parallel.collectives import sum_across

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class _LinearBF16(torch.autograd.Function):
    """x @ w + b with bfloat16 operands and float32 sums, and JAX's VJP."""

    @staticmethod
    def forward(ctx, x, w, b):
        xb, wb = x.bfloat16(), w.bfloat16()
        ctx.save_for_backward(xb, wb)
        return xb.float() @ wb.float() + b

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (g @ wb.float().t()).bfloat16().float()
        if ctx.needs_input_grad[1]:
            dw = (xb.reshape(-1, xb.shape[-1]).float().t()
                  @ g.reshape(-1, g.shape[-1])).bfloat16().float()
        if ctx.needs_input_grad[2]:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return dx, dw, db


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_in, n_out))
        self.b = nn.Parameter(torch.empty(n_out))

    def forward(self, x: torch.Tensor, dtype: str = "float32") -> torch.Tensor:
        """x @ w + b, with the matmul's operands in `dtype` ("float32" or
        "bfloat16"); the result is float32 either way."""
        if dtype == "bfloat16":
            return _LinearBF16.apply(x, self.w, self.b)
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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        if not self.training:
            return (x - self.mean) * (torch.rsqrt(self.var + BN_EPS) * self.scale) + self.bias
        shift = self.mean
        xc = x - shift
        dims = tuple(range(x.dim() - 1))
        if mask is None:
            n = x.new_full((), float(x.numel() // x.shape[-1]))
            dsum, sqsum = xc.sum(dims), (xc * xc).sum(dims)
        else:
            m = mask.to(x.dtype)[..., None].expand(x.shape[:-1] + (1,))
            n = m.sum()
            dsum, sqsum = (xc * m).sum(dims), (xc * xc * m).sum(dims)
        if group is not None:
            c = dsum.shape[0]
            sums = sum_across(torch.cat([n.reshape(1), dsum, sqsum]), group)
            n, dsum, sqsum = sums[0], sums[1:c + 1], sums[c + 1:]
        n = n.clamp_min(1.0)  # a count: no gradient flows through it
        dmean = dsum / n
        mean = dmean + shift
        # torch.maximum, not clamp_min: half the gradient at 0, as jnp.maximum
        var = torch.maximum(sqsum / n - dmean * dmean, x.new_zeros(()))
        self.update_running_stats(mean, var, n)
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor, n: torch.Tensor):
        """Momentum update from a batch's mean and biased var over n rows;
        the unbiased var var * n / max(n - 1, 1) is stored."""
        unbiased = var * n / (n - 1.0).clamp_min(1.0)
        self.mean = (1 - BN_MOMENTUM) * self.mean + BN_MOMENTUM * mean
        self.var = (1 - BN_MOMENTUM) * self.var + BN_MOMENTUM * unbiased


class Layer(nn.Module):
    """Linear -> ReLU -> BatchNorm."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.linear = Linear(n_in, n_out)
        self.bn = BatchNorm(n_out)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None, dtype: str = "float32") -> torch.Tensor:
        return self.bn(torch.relu(self.linear(x, dtype)), mask, group)


class MLP(nn.Module):
    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(channels[i - 1], channels[i]) for i in range(1, len(channels))
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None, dtype: str = "float32") -> torch.Tensor:
        """`mask` (broadcastable to x.shape[:-1]) selects the rows that
        enter the batch statistics in train mode, summed over `group`'s
        ranks where one is given; `dtype` is each Linear's."""
        for layer in self.layers:
            x = layer(x, mask, group, dtype)
        return x
