"""The nearest selection's spatial culling on the CPU (`ops/ballquery.
nearest_cells`, the grid of `ops/csrc/ball_query_nearest.cu` in its
operations): among each centroid's 3 x 3 cells, the (d2, index)-least k
within the radius are exactly the plain version's picks and masks, on
clouds that test the culling radius's margin and the grid's edges. With the
margin dropped (delta = 0), a cloud far from the origin loses picks: the
margin is what keeps the culling exact there.

Every cloud is made from a numpy seed; the comparison is exact (idx and
mask equal), as chip_smoke.py holds the kernel to the plain version."""

import numpy as np
import pytest
import torch

from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.ops.ballquery import (
    NEAREST_GRID_MAX,
    ball_query_nearest,
    nearest_cells,
    nearest_grid_side,
    radius_sq,
)
from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3

torch.set_num_threads(1)

B, N, C = 2, 2048, 512  # DEV-sized clouds: the shapes of SA1's inputs, cut


def _uniform(rng, b, n, shift=(0.0, 0.0, 0.0)):
    """PROD-like plots: xy uniform over the 20 m plot, z in [0, 3] m."""
    xy = rng.uniform(-10, 10, (b, n, 2))
    z = rng.uniform(0, 3, (b, n, 1))
    return (np.concatenate([xy, z], -1) + np.asarray(shift)).astype(np.float32)


def _from_points(rng, pts, c):
    return np.ascontiguousarray(pts[:, rng.permutation(pts.shape[1])[:c]])


def _cloud(kind, seed):
    """(centroids, points, radius, k) of one test cloud."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pts = _uniform(rng, B, N)
        return _from_points(rng, pts, C), pts, 2 ** 0.5, 32
    if kind == "grid":  # integer coordinates, an eighth duplicated: ties at the k-th d2
        pts = rng.integers(0, 8, (B, N, 3)).astype(np.float32)
        pts[:, N // 2 : N // 2 + N // 8] = pts[:, : N // 8]
        return _from_points(rng, pts, C), pts, 2.0, 32
    if kind == "shifted":  # a plot 1.4 km from the origin: |p|^2 ~ 2e6, ulp 0.125
        pts = _uniform(rng, B, N, (1000.0, 1000.0, 0.0))
        return _from_points(rng, pts, C), pts, 2 ** 0.5, 32
    if kind == "on_radius":
        # among uniform points 1 km out, rings around each centroid whose d2
        # is within an ulp of the expanded form's terms (~2e6 there, ulp
        # 0.125-0.25) of r^2 = 4, in every direction
        pts = _uniform(rng, B, N - 4 * 96, (1000.0, 1000.0, 0.0))
        cent = _from_points(rng, pts, 96)
        ang = rng.uniform(0, 2 * np.pi, (B, 96, 4))
        rad = np.sqrt(4.0 + rng.uniform(-0.25, 0.25, (B, 96, 4)))
        ring = np.stack([np.cos(ang) * rad, np.sin(ang) * rad, np.zeros_like(ang)], -1)
        ring = (cent[:, :, None, :] + ring).astype(np.float32).reshape(B, -1, 3)
        return cent, np.ascontiguousarray(np.concatenate([pts, ring], 1)), 2.0, 48
    if kind == "clustered":  # 90% of the points in 5% of the plot
        pts = _uniform(rng, B, N)
        side = 20 * 0.05 ** 0.5
        crowd = rng.random((B, N)) < 0.9
        pts[..., :2] = np.where(crowd[..., None], rng.uniform(-side / 2, side / 2, (B, N, 2)),
                                pts[..., :2]).astype(np.float32)
        return _from_points(rng, pts, C), pts, 2 ** 0.5, 32
    if kind == "one_cell":  # every point within the radius: one cell, brute force
        pts = _uniform(rng, B, N)
        return _from_points(rng, pts, C), pts, 1e3, 128
    if kind == "sparse":  # about one point a ball, fewer than k: most slots masked
        pts = rng.uniform(-10, 10, (B, N, 3)).astype(np.float32)
        return _from_points(rng, pts, C), pts, 1.0, 64
    raise ValueError(kind)


CLOUDS = ("uniform", "grid", "shifted", "on_radius", "clustered", "one_cell", "sparse")


def _culled(cent, pts, radius, k, margin_ulps=None):
    """The (d2, index)-least k in-radius points among each centroid's
    candidate cells, as idx and mask like the plain version's."""
    kw = {} if margin_ulps is None else {"margin_ulps": margin_ulps}
    grid = nearest_cells(cent, pts, radius, **kw)
    d2 = expanded_d2(cent, sq_norm3(cent), pts, sq_norm3(pts))
    score = torch.where(grid.candidates() & (d2 <= radius_sq(radius)), d2, float("inf"))
    val, order = torch.sort(score, dim=-1, stable=True)
    mask = val[..., :k] < float("inf")
    return torch.where(mask, order[..., :k], 0), mask, grid


@pytest.mark.parametrize("kind", CLOUDS)
def test_culled_picks_equal_the_plain_picks(kind):
    cent, pts, radius, k = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _cloud(kind, seed=CLOUDS.index(kind)))
    idx, mask, grid = _culled(cent, pts, radius, k)
    want_idx, want_mask = ball_query_nearest(cent, pts, radius, k)
    assert torch.equal(mask, want_mask)
    assert torch.equal(idx, want_idx)
    # the invariant itself: every pair the plain version admits is a candidate
    d2 = expanded_d2(cent, sq_norm3(cent), pts, sq_norm3(pts))
    admitted = d2 <= radius_sq(radius)
    assert not bool((admitted & ~grid.candidates()).any())
    if kind == "one_cell":
        assert grid.gx.tolist() == [1] * B and grid.gy.tolist() == [1] * B
    if kind == "uniform":  # the culling pays: about 5% of all pairs scored at SA1's radius
        assert float(grid.scored.sum()) < 0.1 * cent.shape[1] * pts.shape[1] * B
    if kind == "grid":  # ties at the k-th distance, broken by index
        kth = torch.sort(torch.where(admitted, d2, float("inf")), -1)[0][..., k - 1]
        assert float(((d2 == kth[..., None]).sum(-1) > 1).float().mean()) > 0.5
    if kind == "on_radius":  # points within an ulp of the terms of r^2, on both sides
        near = (d2 - 4.0).abs() <= 0.25
        assert int((near & admitted).sum()) > 50 and int((near & ~admitted).sum()) > 50
    if kind == "sparse":
        assert float((admitted.sum(-1) < k).float().mean()) == 1.0


def test_without_the_margin_a_far_cloud_loses_picks():
    """delta = 0: the plain version admits points whose true distance is
    above r by the rounding of |c|^2 - 2 c.p + |p|^2 (~0.1-0.3 m^2 at 1 km
    from the origin), some of which fall two cells from their centroid's;
    k above every centroid's in-radius count, so each admitted point is a
    pick. With the kernel's margin none is lost."""
    rng = np.random.default_rng(11)
    pts = _uniform(rng, B, 2 * N, (1000.0, 1000.0, 0.0))
    cent, pts = torch.from_numpy(_from_points(rng, pts, 2 * C)), torch.from_numpy(pts)
    radius, k = 2 ** 0.5, 128
    want_idx, want_mask = ball_query_nearest(cent, pts, radius, k)
    assert int(want_mask.sum(-1).max()) < k
    idx, mask, _ = _culled(cent, pts, radius, k, margin_ulps=0)
    assert int((mask != want_mask).sum()) > 0
    idx, mask, _ = _culled(cent, pts, radius, k)
    assert torch.equal(mask, want_mask) and torch.equal(idx, want_idx)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "grid"])
def test_grid_starts_order_and_scored_counts(kind):
    """The cell starts are the exclusive sums of the cells' counts (cells
    past gx * gy start at N); `order` lists the points cell by cell; each
    centroid's scored count (the kernel's three row ranges) is the size of
    its candidate set; the grid has at most gmax cells a side."""
    cent, pts, radius, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _cloud(kind, seed=3))
    g = nearest_cells(cent, pts, radius)
    gmax = nearest_grid_side(pts.shape[1])
    assert gmax == min(NEAREST_GRID_MAX, int(pts.shape[1] ** 0.5))
    assert bool((g.gx <= gmax).all() and (g.gy <= gmax).all())
    assert g.starts.shape == (B, gmax * gmax + 1)
    cell = g.point_cy * g.gx[:, None] + g.point_cx
    for i in range(B):
        counts = torch.bincount(cell[i], minlength=gmax * gmax)
        assert torch.equal(g.starts[i, 1:], counts.cumsum(0))
        assert int(g.starts[i, g.gx[i] * g.gy[i]]) == pts.shape[1]
        sorted_cells = cell[i, g.order[i]]
        assert bool((sorted_cells[1:] >= sorted_cells[:-1]).all())
    assert torch.equal(g.scored, g.candidates().sum(-1))
    assert bool((g.point_cx < g.gx[:, None]).all() and (g.point_cy < g.gy[:, None]).all())


def test_culling_radius_and_cell_side():
    """rc2 exceeds r^2 by 16 units of 2^-24 (M + r^2), the cell side is at
    least r_c (1 + 2^-10) and at least the extent over gmax - 0.5; a cloud
    of one point (N = 1) gets one cell."""
    cent, pts, radius, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _cloud("shifted", seed=5))
    g = nearest_cells(cent, pts, radius)
    m = (sq_norm3(pts).amax(1) + sq_norm3(cent).amax(1)).double()
    r2 = radius_sq(radius)
    assert torch.allclose(g.rc2.double() - r2, 16 * 2.0 ** -24 * (m + r2), rtol=1e-3)
    h = 1.0 / g.inv_h.double()  # inv_h rounds once more: within an ulp of the side
    assert bool((h >= g.rc2.double().sqrt() * (1 + 2.0 ** -10) * (1 - 2.0 ** -23)).all())
    one = nearest_cells(pts[:, :1], pts[:, :1], radius)
    assert one.gx.tolist() == [1] * B and one.starts.shape == (B, 2)


def test_wrapper_grid_on_the_cpu_is_the_model():
    """`cuda_kernels.ball_query_nearest_grid` on CPU tensors gives the plain
    picks and `nearest_cells` in the kernel's layout (sorted float4 points
    [x, y, z, |p|^2], indices, cell starts, the centroids' order), and
    counts no launch."""
    cent, pts, radius, k = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in _cloud("uniform", seed=7))
    ck.reset_launches()
    idx, mask, got = ck.ball_query_nearest_grid(cent, pts, radius, k)
    m = nearest_cells(cent, pts, radius)
    assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)
    want_idx, want_mask = ck.ball_query_nearest_plain(cent, pts, radius, k)
    assert torch.equal(idx, want_idx) and torch.equal(mask, want_mask)
    assert torch.equal(got["starts"], m.starts) and torch.equal(got["sorted_idx"], m.order)
    assert torch.equal(got["cent_order"], m.cent_order)
    want = torch.cat([pts, sq_norm3(pts)[..., None]], -1)
    assert torch.equal(got["sorted_pts"], torch.stack([want[i, m.order[i]] for i in range(B)]))
