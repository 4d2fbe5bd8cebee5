"""Farthest point sampling (counterpart of `stratanet2_tpu/ops/fps.py`).

Exact FPS per cloud, or the partitioned approximation: when p | N, p | S and
S/p >= min_part_samples, each cloud is cut into p consecutive parts that run
FPS independently as extra rows. All parts start at the same local residue
start % (N/p) (the data layer shuffles point order, so it is still a random
point per part); part q's indices are offset by q*N/p, and the start is
swapped into slot 0 (an identity for the model's start 0).

The per-row selection is `cuda_kernels.fps`: the CUDA kernel on the card,
the plain mirror of `_fps_lax` on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

from stratanet2_tpu_torch.ops import cuda_kernels


def farthest_point_sampling(
    xyz: torch.Tensor,
    n_samples: int,
    start_idx: Union[int, torch.Tensor] = 0,
    parts: int = 1,
    min_part_samples: int = 256,
) -> torch.Tensor:
    """(B, N, 3) positions -> (B, n_samples) int32 indices into N, with
    out[:, 0] == start_idx (scalar or per-cloud (B,))."""
    b, n, _ = xyz.shape
    xyz = xyz.float().contiguous()
    if isinstance(start_idx, torch.Tensor):
        start = start_idx.to(device=xyz.device, dtype=torch.int32)
    else:  # made on the device: a host-to-device copy would drain the stream
        start = torch.full((b,), int(start_idx), dtype=torch.int32, device=xyz.device)
    start = torch.broadcast_to(start, (b,)).contiguous()
    p = int(parts)
    if not (p > 1 and n % p == 0 and n_samples % p == 0
            and n_samples // p >= min_part_samples):
        return cuda_kernels.fps(xyz, n_samples, start)
    npart, m = n // p, n_samples // p
    sp = (start.repeat_interleave(p) % npart).int()
    idx = cuda_kernels.fps(xyz.reshape(b * p, npart, 3), m, sp)
    offset = (torch.arange(b * p, device=xyz.device, dtype=torch.int32) % p) * npart
    out = (idx + offset[:, None]).reshape(b, n_samples)
    pos = ((start // npart) * m).long()
    rows = torch.arange(b, device=xyz.device)
    first = out[rows, 0].clone()
    out[rows, 0] = out[rows, pos]
    out[rows, pos] = first
    return out
