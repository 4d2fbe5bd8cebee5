"""Fixed-K ball queries (counterpart of `stratanet2_tpu/ops/ballquery.py`):
the grouped selection (`_ball_query_grouped`, the default) and the k
nearest in-radius points (`_ball_query_single`, `method="nearest"`).

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

The nearest selection takes, per centroid, the k in-radius points of least
expanded d2, in ascending order of (d2, index); slots past the in-radius
count give idx 0 and mask False. JAX scores the same d2 and takes
`jax.lax.approx_min_k` of it, which on the CPU is exact with ties to the
lowest index (on a TPU it rounds the scores to bf16 first; the port keeps
float32, as JAX's CPU path does). Here that is a stable sort of each
centroid's scores; on the card it is `cuda_kernels.ball_query_nearest`
(`ops/csrc/ball_query_nearest.cu`).
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


def ball_query_nearest(
    centroids: torch.Tensor,
    points: torch.Tensor,
    radius: float,
    k: int,
):
    """(B, C, 3) centroids, (B, N, 3) points -> idx (B, C, k) int64 and
    mask (B, C, k) bool: the k nearest points within the radius, ascending
    by (d2, index). A stable sort, not `torch.topk`, whose order among
    equal scores is not defined."""
    points = points.float()
    n = points.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"the nearest selection needs 1 <= k <= N, got k={k}, N={n}")
    r2 = radius_sq(radius)
    pts_sq = sq_norm3(points)
    idxs, masks = [], []
    for c0 in range(0, centroids.shape[1], _CHUNK):
        c = centroids[:, c0 : c0 + _CHUNK].float()
        d2 = expanded_d2(c, sq_norm3(c), points, pts_sq)
        score = torch.where(d2 <= r2, d2, torch.full_like(d2, _BIG))
        val, order = torch.sort(score, dim=-1, stable=True)
        mask = val[..., :k] < _BIG * 0.5
        idxs.append(torch.where(mask, order[..., :k], torch.zeros_like(order[..., :k])))
        masks.append(mask)
    return torch.cat(idxs, dim=1), torch.cat(masks, dim=1)
