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
same order. Groups longer than a kernel's staging slice (the dense plots)
take the nearest selection's cell grid (`nearest_cells` below) there:
each centroid scores only its 3 x 3 cells and folds each admitted point's
(d2, index) key into its group's least, which is the same pick.

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


# csrc/knn_interpolate.cu's stop rule on the cell grid: the rounding margin
# of a distance in units of M = fl(max |t|^2 + max |s|^2) (kKnnMargin, 16u),
# and the slack of a cell coordinate q a unit of |q| (kKnnSlack, 4u)
KNN_MARGIN = 2.0 ** -20
KNN_SLACK = 2.0 ** -22
KNN_WARP = 32  # targets a warp of knn_cull_kernel


class KnnCells(NamedTuple):
    """The kNN kernel's cell grid of each cloud (ops/csrc/knn_interpolate.cu,
    knn_grid_kernel: cell_grid.cuh with the cells from the sources' extent):
    the sources are its points and the targets its centroids."""

    xmin: torch.Tensor  # (B,) float32, and ymin: the sources' low corner
    ymin: torch.Tensor
    inv_h: torch.Tensor  # (B,) float32: 1 / the cell side
    m: torch.Tensor  # (B,) float32: fl(max |t|^2 + max |s|^2), the margin's scale
    gx: torch.Tensor  # (B,) int64 cells a row, and gy rows
    gy: torch.Tensor
    src_cx: torch.Tensor  # (B, S) int64 cell column, and src_cy its row
    src_cy: torch.Tensor
    qx: torch.Tensor  # (B, T) float32: a target's unclamped cell coordinates
    qy: torch.Tensor
    tgt_cx: torch.Tensor  # (B, T) int64 cell column, and tgt_cy its row
    tgt_cy: torch.Tensor
    starts: torch.Tensor  # (B, gmax^2 + 1) int64: first sorted source of each cell
    order: torch.Tensor  # (B, S) int64: source indices by cell
    cent_order: torch.Tensor  # (B, T) int64: target indices by cell


def knn_cells(pos_src: torch.Tensor, pos_tgt: torch.Tensor) -> KnnCells:
    """The grid knn_grid_kernel builds, in its float32 operations: per cloud
    the sources' xy extent, inv_h = min(fl((gmax - 0.5) / max(ex, ey)),
    FLT_MAX), gmax = `nearest_grid_side(S)`, M = fl(mc + mp) (mc, mp: max
    |t|^2, max |s|^2 as sq3_rn), and every source's and target's cell."""
    src, tgt = pos_src.float(), pos_tgt.float()
    b, n, _ = src.shape
    gmax = nearest_grid_side(n)
    x, y = src[..., 0], src[..., 1]
    xmin, ymin = x.amin(1), y.amin(1)
    ex, ey = x.amax(1) - xmin, y.amax(1) - ymin
    m = sq_norm3(tgt).amax(1) + sq_norm3(src).amax(1)
    inv_h = torch.minimum(_f32(gmax - 0.5) / torch.maximum(ex, ey),
                          _f32(torch.finfo(torch.float32).max))
    g = torch.full_like(ex, gmax, dtype=torch.int64)
    gx = _cell_coord(ex, inv_h, g) + 1
    gy = _cell_coord(ey, inv_h, g) + 1
    scx = _cell_coord(x - xmin[:, None], inv_h[:, None], gx[:, None])
    scy = _cell_coord(y - ymin[:, None], inv_h[:, None], gy[:, None])
    qx = (tgt[..., 0] - xmin[:, None]) * inv_h[:, None]
    qy = (tgt[..., 1] - ymin[:, None]) * inv_h[:, None]
    tcx = torch.where(qx > 0, torch.minimum(qx, (gx[:, None] - 1).float()).floor(), _f32(0.0))
    tcy = torch.where(qy > 0, torch.minimum(qy, (gy[:, None] - 1).float()).floor(), _f32(0.0))
    tcx, tcy = tcx.long(), tcy.long()
    scell = scy * gx[:, None] + scx
    counts = torch.zeros((b, gmax * gmax), dtype=torch.int64, device=src.device)
    counts.scatter_add_(1, scell, torch.ones_like(scell))
    starts = torch.nn.functional.pad(counts.cumsum(1), (1, 0))
    order = torch.sort(scell, dim=1, stable=True).indices
    cent_order = torch.sort(tcy * gx[:, None] + tcx, dim=1, stable=True).indices
    return KnnCells(xmin, ymin, inv_h, m, gx, gy, scx, scy, qx, qy, tcx, tcy, starts, order,
                    cent_order)


def knn_grid_picks(pos_src: torch.Tensor, pos_tgt: torch.Tensor, margin: float = KNN_MARGIN,
                   slack: float = KNN_SLACK):
    """knn_cull_kernel's culled scan on the CPU: warps of KNN_WARP targets
    in `knn_cells` order (the last padded with its last target), each
    scanning a box of source cells ring by ring until every lane's third
    least d2 (the expanded, clamped d2 of the plain version) is strictly
    below the stop rule's bound, LB = L^2 (1 - margin) - M margin with L =
    (gap - sl) / inv_h in float64, gap the target's cells to the box's inner
    sides and sl = slack (max(|qx|, |qy|) + 65), or the box covers the grid.
    Returns idx (B, 3, T) int64 and d2 (B, 3, T) float32, the (d2,
    index)-least three of the sources its warp scanned, and scored (B, T),
    the sources its warp scanned. `margin=0, slack=0` drops the rounding
    margin (the tests show that loses picks far from the origin)."""
    src, tgt = pos_src.float(), pos_tgt.float()
    b, n, _ = src.shape
    t = tgt.shape[1]
    cells = knn_cells(src, tgt)
    warps = -(-t // KNN_WARP)
    lanes = torch.arange(warps * KNN_WARP, device=src.device).clamp(max=t - 1)
    idxs, vals, scored = [], [], []
    for i in range(b):
        ti = cells.cent_order[i, lanes].view(warps, KNN_WARP)  # each lane's target
        d2 = expanded_d2(tgt[i : i + 1, ti.reshape(-1)], sq_norm3(tgt[i : i + 1, ti.reshape(-1)]),
                         src[i : i + 1], sq_norm3(src[i : i + 1]))[0].view(warps, KNN_WARP, n)
        cx, cy = cells.tgt_cx[i, ti], cells.tgt_cy[i, ti]
        c0, c1, r0, r1 = cx.amin(1), cx.amax(1), cy.amin(1), cy.amax(1)
        gx, gy = int(cells.gx[i]), int(cells.gy[i])
        scx, scy = cells.src_cx[i], cells.src_cy[i]
        qx, qy = cells.qx[i, ti].double(), cells.qy[i, ti].double()
        h = 1.0 / cells.inv_h[i].double()
        lift = float(cells.m[i]) * margin
        sl = (torch.maximum(qx.abs(), qy.abs()) + 65.0) * slack
        running = torch.ones(warps, dtype=torch.bool, device=src.device)
        while True:
            inside = ((scx >= c0[:, None]) & (scx <= c1[:, None])
                      & (scy >= r0[:, None]) & (scy <= r1[:, None]))  # (W, S)
            covers = (c0 == 0) & (r0 == 0) & (c1 == gx - 1) & (r1 == gy - 1)
            running &= ~covers
            if not bool(running.any()):
                break
            masked = torch.where(inside[:, None, :], d2, torch.full_like(d2, float("inf")))
            d3 = torch.topk(masked, 3, dim=-1, largest=False).values[..., 2].double()
            gap = torch.full_like(qx, float("inf"))
            for side, g in ((c0 > 0, qx - c0[:, None]), (c1 < gx - 1, (c1 + 1)[:, None] - qx),
                            (r0 > 0, qy - r0[:, None]), (r1 < gy - 1, (r1 + 1)[:, None] - qy)):
                gap = torch.where(side[:, None], torch.minimum(gap, g), gap)
            lb = (gap - sl) * h
            done = (gap > sl) & (d3 < lb * lb * (1.0 - margin) - lift)
            running &= ~done.all(1)
            grow = running.long()
            c0, r0 = (c0 - grow).clamp(min=0), (r0 - grow).clamp(min=0)
            c1 = torch.minimum(c1 + grow, c1.new_tensor(gx - 1))
            r1 = torch.minimum(r1 + grow, r1.new_tensor(gy - 1))
        masked = torch.where(inside[:, None, :], d2, torch.full_like(d2, float("inf")))
        ids, ds = [], []
        for _ in range(3):  # first minimum: ties to the lowest index
            j = torch.argmin(masked, dim=-1, keepdim=True)
            ds.append(torch.gather(masked, -1, j))
            ids.append(j)
            masked = masked.scatter(-1, j, float("inf"))
        pick_i = torch.full((3, t), -1, dtype=torch.int64, device=src.device)
        pick_d = torch.empty((3, t), dtype=torch.float32, device=src.device)
        cnt = torch.empty(t, dtype=torch.int64, device=src.device)
        flat = ti.reshape(-1)
        pick_i[:, flat] = torch.cat(ids, -1).reshape(-1, 3).t()
        pick_d[:, flat] = torch.cat(ds, -1).reshape(-1, 3).t()
        cnt[flat] = inside.sum(1).repeat_interleave(KNN_WARP)
        idxs.append(pick_i)
        vals.append(pick_d)
        scored.append(cnt)
    return torch.stack(idxs), torch.stack(vals), torch.stack(scored)
