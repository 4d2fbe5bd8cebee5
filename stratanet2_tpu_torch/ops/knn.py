"""k-NN inverse-distance-squared feature interpolation (counterpart of
`stratanet2_tpu/ops/knn.py`), torch_geometric semantics with k=3: the three
nearest sources (ties to the lowest index) weighted by 1/max(d^2, 1e-16)
and normalised by the weight sum.

The selection and gather are `cuda_kernels.knn_interpolate`: the CUDA kernel
on the card, its plain version on the CPU. The gradient in the source
features is `cuda_kernels.knn_scatter` on the forward's (B, 3, T) indices
and normalised weights, as the custom VJP of `pallas_kernels.py:644-683`
does; positions get no gradient (raw input coordinates in this model).
"""

from __future__ import annotations

import torch

from stratanet2_tpu_torch.ops import cuda_kernels


class _KnnInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_src, pos_src, pos_tgt):
        out, idx, w = cuda_kernels.knn_interpolate(x_src, pos_src, pos_tgt)
        ctx.save_for_backward(idx, w)
        ctx.s = x_src.shape[1]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        dx = cuda_kernels.knn_scatter(idx, w, g.float().contiguous(), ctx.s)
        return dx, None, None


def knn_interpolate(
    x_src: torch.Tensor, pos_src: torch.Tensor, pos_tgt: torch.Tensor
) -> torch.Tensor:
    """(B, S, F) features at (B, S, 3) sources -> (B, T, F) at (B, T, 3)
    targets; differentiable in `x_src`."""
    return _KnnInterpolate.apply(
        x_src.float().contiguous(),
        pos_src.float().contiguous(),
        pos_tgt.float().contiguous(),
    )
