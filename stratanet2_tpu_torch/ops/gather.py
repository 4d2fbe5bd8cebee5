"""Batched row gather with the scatter kernel as its backward (counterpart
of `stratanet2_tpu/ops/pallas_kernels.py::gather_rows`, :589-641).

The forward is a plain indexed gather, as the JAX forward is an XLA take;
the backward is `cuda_kernels.knn_scatter` with k=1 and no weights, the
counterpart of `scatter_add_pallas`. Only `x` gets a gradient.
"""

from __future__ import annotations

import torch

from stratanet2_tpu_torch.ops import cuda_kernels


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        b, n, f = x.shape
        ctx.save_for_backward(idx)
        ctx.n = n
        rows = torch.arange(b, device=x.device).reshape((b,) + (1,) * (idx.dim() - 1))
        return x[rows, idx.long()]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        b, f = g.shape[0], g.shape[-1]
        dx = cuda_kernels.knn_scatter(
            idx.reshape(b, 1, -1).int().contiguous(), None,
            g.reshape(b, -1, f).float().contiguous(), ctx.n,
        )
        return dx, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, F), integer idx (B, ...) in [0, N) -> (B, ..., F) rows
    x[b, idx[b, ...]]."""
    return _GatherRows.apply(x, idx)
