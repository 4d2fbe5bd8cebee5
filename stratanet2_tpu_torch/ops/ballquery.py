"""Grouped fixed-K ball query (counterpart of
`stratanet2_tpu/ops/ballquery.py::_ball_query_grouped`).

The N points are cut into K groups of g = ceil(N/K) consecutive points (the
last group padded, possibly wholly). Each centroid takes, in each group, the
nearest point within the radius, ties to the lowest index; a group with no
such point gives idx 0 and mask False. The data layer shuffles point order,
so groups are random subsets and the K picks span the whole ball.

This is the plain PyTorch version. On the card the selection runs in the
standalone kernel (`cuda_kernels.ball_query`, `ops/csrc/ball_query.cu`, the
train path) and inside the fused SA eval kernel (`ops/csrc/
sa_fused_eval.cu`, the serve path); both compute the same distances in the
same order.
"""

from __future__ import annotations

import numpy as np
import torch

from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3

_BIG = 1e30
_CHUNK = 256  # centroids per (B, chunk, N) distance tile


def radius_sq(radius: float) -> float:
    """float32(radius)^2 rounded to float32, as `jnp.float32(radius) ** 2`."""
    r = np.float32(radius)
    return float(r * r)


def ball_query_grouped(
    centroids: torch.Tensor,
    points: torch.Tensor,
    radius: float,
    k: int,
):
    """(B, C, 3) centroids, (B, N, 3) points -> idx (B, C, k) int64 and
    mask (B, C, k) bool."""
    points = points.float()
    b, n, _ = points.shape
    g = -(-n // k)
    r2 = radius_sq(radius)
    pts_sq = sq_norm3(points)
    base = torch.arange(k, device=points.device) * g
    idxs, masks = [], []
    for c0 in range(0, centroids.shape[1], _CHUNK):
        c = centroids[:, c0 : c0 + _CHUNK].float()
        d2 = expanded_d2(c, sq_norm3(c), points, pts_sq)
        score = torch.where(d2 <= r2, d2, torch.full_like(d2, _BIG))
        if k * g != n:
            score = torch.nn.functional.pad(score, (0, k * g - n), value=_BIG)
        sg = score.reshape(b, c.shape[1], k, g)
        smin = torch.amin(sg, dim=-1)
        within = torch.argmin(sg, dim=-1)  # first minimum, as jnp.argmin
        mask = smin < _BIG * 0.5
        idxs.append(torch.where(mask, base + within, torch.zeros_like(within)))
        masks.append(mask)
    return torch.cat(idxs, dim=1), torch.cat(masks, dim=1)
