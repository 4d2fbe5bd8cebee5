"""k-NN inverse-distance-squared feature interpolation (counterpart of
`stratanet2_tpu/ops/knn.py`), torch_geometric semantics with k=3: the three
nearest sources (ties to the lowest index) weighted by 1/max(d^2, 1e-16)
and normalised by the weight sum.

The selection and gather are `cuda_kernels.knn_interpolate`: the CUDA kernel
on the card, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from stratanet2_tpu_torch.ops import cuda_kernels


def knn_interpolate(
    x_src: torch.Tensor, pos_src: torch.Tensor, pos_tgt: torch.Tensor
) -> torch.Tensor:
    """(B, S, F) features at (B, S, 3) sources -> (B, T, F) at (B, T, 3)
    targets."""
    out, _idx, _w = cuda_kernels.knn_interpolate(
        x_src.float().contiguous(),
        pos_src.float().contiguous(),
        pos_tgt.float().contiguous(),
    )
    return out
