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
(`ops/csrc/ball_query_nearest.cu`), which scores only the 3 x 3 cells of
an xy grid around each centroid. `nearest_cells` is that grid in the
kernel's operations, a model of its culling for the CPU tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3, tile_rows

_BIG = 1e30
_CHUNK = 256  # centroids per (B, chunk, N) distance tile on the card


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
    chunk = tile_rows(points.device, b, n, _CHUNK)
    idxs, masks = [], []
    for c0 in range(0, centroids.shape[1], chunk):
        c = centroids[:, c0 : c0 + chunk].float()
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


NEAREST_GRID_MAX = 64  # csrc/ball_query_nearest.cu: cells a side at most (kGridMax)
NEAREST_MARGIN_ULPS = 16  # the culling radius's margin, in units of 2^-24 (M + r^2)


def nearest_grid_side(n: int) -> int:
    """gmax, the most cells a side of an N-point cloud's grid: min(64,
    isqrt(N)), so that a grid never has many more cells than points."""
    return max(1, min(NEAREST_GRID_MAX, math.isqrt(n)))


class NearestCells(NamedTuple):
    """The nearest kernel's cell grid of each cloud (ops/csrc/
    ball_query_nearest.cu, nearest_grid_kernel)."""

    xmin: torch.Tensor  # (B,) float32, and ymin: the extent's low corner
    ymin: torch.Tensor
    inv_h: torch.Tensor  # (B,) float32: 1 / the cell side
    rc2: torch.Tensor  # (B,) float32: the culling radius squared
    gx: torch.Tensor  # (B,) int64 cells a row, and gy rows
    gy: torch.Tensor
    point_cx: torch.Tensor  # (B, N) int64 cell column, and point_cy its row
    point_cy: torch.Tensor
    cent_cx: torch.Tensor  # (B, C) int64, likewise
    cent_cy: torch.Tensor
    starts: torch.Tensor  # (B, gmax^2 + 1) int64: first sorted point of each cell
    order: torch.Tensor  # (B, N) int64: point indices by cell (ascending in a cell)
    cent_order: torch.Tensor  # (B, C) int64: centroid indices by cell
    scored: torch.Tensor  # (B, C) int64: points in each centroid's 3 x 3 cells

    def candidates(self) -> torch.Tensor:
        """(B, C, N) bool: the points in each centroid's 3 x 3 cells."""
        dx = self.point_cx[:, None, :] - self.cent_cx[:, :, None]
        dy = self.point_cy[:, None, :] - self.cent_cy[:, :, None]
        return (dx.abs() <= 1) & (dy.abs() <= 1)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _cell_coord(d: torch.Tensor, inv_h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The kernel's `cell_coord`: q = fl(d * inv_h), then floor(min(q, g - 1))
    where q > 0, else 0 (a NaN too)."""
    q = d * inv_h
    return torch.where(q > 0, torch.minimum(q, (g - 1).float()).floor(), _f32(0.0)).long()


def nearest_cells(
    centroids: torch.Tensor,
    points: torch.Tensor,
    radius: float,
    margin_ulps: int = NEAREST_MARGIN_ULPS,
) -> NearestCells:
    """The grid the nearest kernel builds, in its float32 operations (its
    header derives them): per cloud the xy extent, mp = max |p|^2 and mc =
    max |c|^2, rc2 = r2 + (mc + mp + r2) * margin_ulps * 2^-24, the cell side
    h >= max(sqrt(rc2) (1 + 2^-10), extent / (gmax - 0.5)), and every point's
    and centroid's cell. `margin_ulps=0` drops the rounding margin (the
    tests show that loses picks). Finite coordinates (the kernel's NaN-free
    reductions and torch's agree only there)."""
    points, centroids = points.float(), centroids.float()
    b, n, _ = points.shape
    gmax = nearest_grid_side(n)
    r2 = _f32(radius_sq(radius))
    x, y = points[..., 0], points[..., 1]
    xmin, ymin = x.amin(1), y.amin(1)
    ex, ey = x.amax(1) - xmin, y.amax(1) - ymin
    mp, mc = sq_norm3(points).amax(1), sq_norm3(centroids).amax(1)
    rc2 = r2 + ((mc + mp) + r2) * _f32(margin_ulps * 2.0 ** -24)
    # sqrt_rn: the double's square root rounded to float32 is the correctly
    # rounded one (torch's float32 sqrt on the CPU is not, for ~1% of inputs)
    rc = torch.sqrt(rc2.double()).float()
    inv_h = torch.minimum(_f32(1.0) / (rc * _f32(1.0 + 2.0 ** -10)),
                          _f32(gmax - 0.5) / torch.maximum(ex, ey))
    g = torch.full_like(ex, gmax, dtype=torch.int64)
    gx = _cell_coord(ex, inv_h, g) + 1
    gy = _cell_coord(ey, inv_h, g) + 1

    def cells(px, py):
        return (_cell_coord(px - xmin[:, None], inv_h[:, None], gx[:, None]),
                _cell_coord(py - ymin[:, None], inv_h[:, None], gy[:, None]))

    pcx, pcy = cells(x, y)
    ccx, ccy = cells(centroids[..., 0], centroids[..., 1])
    pcell = pcy * gx[:, None] + pcx
    counts = torch.zeros((b, gmax * gmax), dtype=torch.int64, device=points.device)
    counts.scatter_add_(1, pcell, torch.ones_like(pcell))
    starts = torch.nn.functional.pad(counts.cumsum(1), (1, 0))
    order = torch.sort(pcell, dim=1, stable=True).indices
    cent_order = torch.sort(ccy * gx[:, None] + ccx, dim=1, stable=True).indices
    scored = torch.zeros_like(ccx)
    for dy in (-1, 0, 1):
        row = ccy + dy
        live = (row >= 0) & (row < gy[:, None])
        base = torch.minimum(row.clamp(min=0), gy[:, None] - 1) * gx[:, None]
        lo = starts.gather(1, base + (ccx - 1).clamp(min=0))
        hi = starts.gather(1, base + torch.minimum(ccx + 1, gx[:, None] - 1) + 1)
        scored += torch.where(live, hi - lo, 0)
    return NearestCells(xmin, ymin, inv_h, rc2, gx, gy, pcx, pcy, ccx, ccy, starts, order,
                        cent_order, scored)
