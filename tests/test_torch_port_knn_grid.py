"""kNN interpolation's spatial culling on the CPU (`ops/ballquery.knn_cells`
and `knn_grid_picks`, the grid and the culled scan of
`ops/csrc/knn_interpolate.cu`'s cell-grid path in their operations): each
warp of 32 targets in cell order scans rings of source cells until every
lane's third least d2 lies strictly below the stop rule's bound, and the
(d2, index)-least three of what it scanned are exactly the plain version's
picks and JAX's `_knn_single`'s, on clouds that test ties, the rounding
margin far from the origin, crowded cells, an index order unlike the cell
order and targets off every source. With the margin and the slack
dropped, a plot 1 km from the origin loses picks: the margin is what keeps
the culling exact there. The kernel stages each ring's sources in tiles of
32 (its row segments flattened by a prefix sum): a model of that
flattening scans each source of the box once, the same sources and the
same picks as the row-by-row mirror. Then the path rule by shape, the
constants against the CUDA source, and the wrappers on the CPU at grid
shapes.

Every cloud is made from a numpy seed; picks are compared exactly, as
chip_smoke.py holds the kernel to the plain version."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.ops import knn_interpolate as jax_knn
from stratanet2_tpu.ops.knn import _iterative_min_k
from stratanet2_tpu_torch.ops import _build, cuda_kernels as ck
from stratanet2_tpu_torch.ops import knn as port_knn
from stratanet2_tpu_torch.ops.ballquery import (
    KNN_MARGIN,
    KNN_SLACK,
    KNN_WARP,
    NEAREST_GRID_MAX,
    knn_cells,
    knn_grid_picks,
    nearest_grid_side,
)
from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3

torch.set_num_threads(1)

B, S, T = 2, 1024, 4096  # DEV-sized: FP1's shape at N = 4,096, cut


def T_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plots(rng, b, n, shift=(0.0, 0.0, 0.0)):
    """PROD-like plots: xy uniform over the 20 m plot, z in [0, 3] m."""
    xy = rng.uniform(-10, 10, (b, n, 2))
    z = rng.uniform(0, 3, (b, n, 1))
    return (np.concatenate([xy, z], -1) + np.asarray(shift)).astype(np.float32)


def _subset(rng, tgt, s):
    """Sources drawn from the targets, as SA centroids are points of the cloud."""
    return np.ascontiguousarray(tgt[:, rng.permutation(tgt.shape[1])[:s]])


def _cloud(kind, seed):
    """(sources (B, S, 3), targets (B, T, 3)) of one test cloud."""
    rng = np.random.default_rng(seed)
    if kind == "grid":  # integer lattice, an eighth duplicated, targets on sources: ties
        src = rng.integers(0, 8, (B, S, 3)).astype(np.float32)
        src[:, S // 2 : S // 2 + S // 8] = src[:, : S // 8]
        tgt = rng.integers(0, 8, (B, T, 3)).astype(np.float32)
        tgt[:, : T // 8] = src[:, rng.integers(0, S, T // 8)]
        return src, tgt
    if kind == "shifted":  # 1.4 km from the origin: |p|^2 ~ 2e6, ulp 0.125
        tgt = _plots(rng, B, T, (1000.0, 1000.0, 0.0))
        return _subset(rng, tgt, S), tgt
    if kind == "clustered":  # 90% of the points in 5% of the plot
        tgt = _plots(rng, B, T)
        side = 20 * 0.05 ** 0.5
        crowd = rng.random((B, T)) < 0.9
        tgt[..., :2] = np.where(crowd[..., None], rng.uniform(-side / 2, side / 2, (B, T, 2)),
                                tgt[..., :2]).astype(np.float32)
        return _subset(rng, tgt, S), tgt
    if kind == "sorted":  # sources in x order: index order far from cell order
        tgt = _plots(rng, B, T)
        src = _subset(rng, tgt, S)
        return np.ascontiguousarray(np.take_along_axis(src, src[..., :1].argsort(1), 1)), tgt
    if kind == "far":  # every target 40 m off the sources along x
        tgt = _plots(rng, B, T)
        src = _subset(rng, tgt, S)
        return src, tgt + np.float32([40.0, 0.0, 0.0])
    if kind == "ragged":  # T a multiple of no warp, S of no cell count
        tgt = _plots(rng, B, 1001)
        return _subset(rng, tgt, 337), tgt
    raise ValueError(kind)


def _jax_idx(src, tgt):
    """The three indices `_knn_single` (stratanet2_tpu/ops/knn.py:71-96)
    selects, (B, 3, T)."""

    def one(ps1, pt1):
        tp = jax.lax.dot_general(pt1, ps1.T, (((1,), (0,)), ((), ())),
                                 precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.sum(pt1 * pt1, -1, keepdims=True) - 2.0 * tp + jnp.sum(ps1 * ps1, -1)[None]
        return _iterative_min_k(jnp.maximum(d2, 0.0), 3)[1]

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(src), jnp.asarray(tgt))).transpose(0, 2, 1)


KINDS = ["grid", "shifted", "clustered", "sorted", "far", "ragged"]


@pytest.mark.parametrize("kind", KINDS)
def test_culled_picks_match_the_plain_version_and_jax(kind):
    """The culled scan's picks equal the plain version's and JAX's, index
    for index, and its three d2 are the plain version's (its weights bit
    for bit); the JAX output within the kNN tests' 1e-5 (the 3-term sum may
    round in another order there)."""
    src, tgt = _cloud(kind, KINDS.index(kind))
    x = np.random.default_rng(7).normal(size=(B, src.shape[1], 8)).astype(np.float32)
    idx, d2, scored = knn_grid_picks(T_(src), T_(tgt))
    out, want_idx, want_w = ck.knn_interpolate_plain(T_(x), T_(src), T_(tgt))
    np.testing.assert_array_equal(idx.numpy(), want_idx.long().numpy())
    np.testing.assert_array_equal(idx.numpy(), _jax_idx(src, tgt))
    w = 1.0 / torch.clamp_min(d2, 1e-16)
    w = w / ((w[:, 0] + w[:, 1]) + w[:, 2])[:, None]
    assert torch.equal(w, want_w)
    want = jax_knn(jnp.asarray(x), jnp.asarray(src), jnp.asarray(tgt), k=3, use_pallas=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # every target scored at least its three picks, never more than the cloud
    assert bool((scored >= 3).all()) and bool((scored <= src.shape[1]).all())
    if kind == "far":  # the box grows over most of the grid
        assert float(scored.double().mean()) > 0.5 * src.shape[1]
    elif kind in ("grid", "sorted", "ragged"):
        assert float(scored.double().mean()) < 0.5 * src.shape[1]


def test_without_the_margin_a_far_cloud_loses_a_pick():
    """1 km from the origin the expanded d2 rounds by up to ~2 m^2 (|t|^2 ~
    2e6): with the margin and the slack dropped, a warp stops as soon as its
    box's true distance exceeds its third computed d2, and some source
    outside, whose computed d2 rounded lower, is missed. With them the
    picks are the plain version's."""
    rng = np.random.default_rng(1)
    tgt = _plots(rng, 1, 8192, (1000.0, 1000.0, 0.0))
    src = _subset(rng, tgt, 4096)
    _, want_idx, _ = ck.knn_interpolate_plain(torch.zeros((1, 4096, 1)), T_(src), T_(tgt))
    idx, _, scored = knn_grid_picks(T_(src), T_(tgt))
    assert torch.equal(idx, want_idx.long())
    lost, _, bare = knn_grid_picks(T_(src), T_(tgt), margin=0.0, slack=0.0)
    assert int((lost != want_idx.long()).sum()) > 0
    assert float(bare.double().sum()) < float(scored.double().sum())


def test_knn_cells_sort_sources_and_targets_by_cell():
    """The grid: at most gmax x gmax cells, each source in its cell's range
    of the sorted order, the targets in cell order, M = fl(mc + mp); one
    xy for every source gives one cell (inv_h capped at FLT_MAX)."""
    src, tgt = _cloud("clustered", 11)
    cells = knn_cells(T_(src), T_(tgt))
    gmax = nearest_grid_side(S)
    assert gmax == 32  # min(NEAREST_GRID_MAX, isqrt(S))
    assert bool((cells.gx <= gmax).all()) and bool((cells.gy <= gmax).all())
    for i in range(B):
        cell = (cells.src_cy[i] * cells.gx[i] + cells.src_cx[i])[cells.order[i]]
        assert bool((cell[1:] >= cell[:-1]).all())
        counts = torch.bincount(cell, minlength=gmax * gmax)
        assert torch.equal(cells.starts[i, 1:] - cells.starts[i, :-1], counts)
        tcell = (cells.tgt_cy[i] * cells.gx[i] + cells.tgt_cx[i])[cells.cent_order[i]]
        assert bool((tcell[1:] >= tcell[:-1]).all())
    sq = lambda p: (p.astype(np.float64) ** 2).sum(-1)  # noqa: E731
    m = (sq(tgt).max(1) + sq(src).max(1)).astype(np.float32)
    np.testing.assert_allclose(cells.m.numpy(), m, rtol=1e-6)
    one = np.repeat(src[:, :1], S, 1)
    one[..., 2] = np.linspace(0, 3, S)
    flat = knn_cells(T_(one), T_(tgt))
    assert bool((flat.gx == 1).all() and (flat.gy == 1).all())
    assert bool((flat.inv_h == torch.finfo(torch.float32).max).all())
    idx, _, scored = knn_grid_picks(T_(one), T_(tgt[:, :300]))
    _, want_idx, _ = ck.knn_interpolate_plain(torch.zeros((B, S, 1)), T_(one), T_(tgt[:, :300]))
    assert torch.equal(idx, want_idx.long()) and bool((scored == S).all())


def _ring_segments(st, gx, new, old):
    """knn_scan_added's segments of the sorted sources that the box `new` =
    (n0, n1, m0, m1) (columns, rows) adds to `old` = (c0, c1, r0, r1) (no
    box: r0 > r1), as (lo, len): row m0 + k gives segments 2 k and 2 k + 1,
    a row outside the old box whole and nothing, a row inside it its new
    left cells and its new right cells."""
    n0, n1, m0, m1 = new
    c0, c1, r0, r1 = old
    segs = []
    for sg in range(2 * (m1 - m0 + 1)):
        row = m0 + sg // 2
        a, z = n0, n1
        if r0 <= row <= r1:
            a, z = (c1 + 1, n1) if sg & 1 else (n0, c0 - 1)
        elif sg & 1:
            z = a - 1
        lo = int(st[row * gx + a]) if a <= z else 0
        segs.append((lo, int(st[row * gx + z + 1]) - lo if a <= z else 0))
    return segs


def _tiles(segs):
    """Each group of 32 segments flattened by a prefix sum of their lengths
    and cut into tiles of 32 (a list of tiles a group): flat source f lies
    in the last segment whose first flat source is at most f (the kernel's
    binary search over the lanes), at sorted position lo + f - that
    first."""
    groups = []
    for g0 in range(0, len(segs), 32):
        lo, ln = (torch.tensor(v) for v in zip(*segs[g0 : g0 + 32]))
        excl = ln.cumsum(0) - ln
        f = torch.arange(int(ln.sum()))
        k = torch.searchsorted(excl, f, right=True) - 1
        groups.append(list((lo[k] + f - excl[k]).split(KNN_WARP)) if len(f) else [])
    return groups


def _tile_scan(src, tgt):
    """knn_cull_kernel's scan with its sources staged in tiles: per warp of
    KNN_WARP targets in cell order, the box, then ring after ring, each
    ring's added sources in `_tiles`, until knn_grid_picks' stop rule holds
    or the box covers the grid. Returns per cloud a list, a warp each, of
    (its targets, the sorted positions it scored in scan order, its tiles'
    lengths, a list a group, its final box)."""
    cells = knn_cells(src, tgt)
    b, t = tgt.shape[:2]
    out = []
    for i in range(b):
        st, gx, gy = cells.starts[i], int(cells.gx[i]), int(cells.gy[i])
        h = 1.0 / cells.inv_h[i].double()
        lift = float(cells.m[i]) * KNN_MARGIN
        d2_all = expanded_d2(tgt[i : i + 1], sq_norm3(tgt[i : i + 1]), src[i : i + 1],
                             sq_norm3(src[i : i + 1]))[0]
        warps = []
        for w0 in range(0, t, KNN_WARP):
            ti = cells.cent_order[i, torch.arange(w0, w0 + KNN_WARP).clamp(max=t - 1)]
            cx, cy = cells.tgt_cx[i, ti], cells.tgt_cy[i, ti]
            qx, qy = cells.qx[i, ti].double(), cells.qy[i, ti].double()
            sl = (torch.maximum(qx.abs(), qy.abs()) + 65.0) * KNN_SLACK
            box = (int(cx.min()), int(cx.max()), int(cy.min()), int(cy.max()))
            rings = [_tiles(_ring_segments(st, gx, box, (0, -1, 1, 0)))]
            while box != (0, gx - 1, 0, gy - 1):
                c0, c1, r0, r1 = box
                pos = torch.cat([x for ring in rings for group in ring for x in group]
                                or [torch.zeros(0, dtype=torch.long)])
                d3 = torch.sort(d2_all[ti][:, cells.order[i, pos]], -1).values
                d3 = d3[:, 2].double() if d3.shape[1] >= 3 else torch.full_like(qx, float("inf"))
                gap = torch.full_like(qx, float("inf"))
                for side, g in ((c0 > 0, qx - c0), (c1 < gx - 1, c1 + 1 - qx),
                                (r0 > 0, qy - r0), (r1 < gy - 1, r1 + 1 - qy)):
                    if side:
                        gap = torch.minimum(gap, g)
                lb = (gap - sl) * h
                if bool(((gap > sl) & (d3 < lb * lb * (1.0 - KNN_MARGIN) - lift)).all()):
                    break
                new = (max(c0 - 1, 0), min(c1 + 1, gx - 1), max(r0 - 1, 0), min(r1 + 1, gy - 1))
                rings.append(_tiles(_ring_segments(st, gx, new, box)))
                box = new
            warps.append((ti, torch.cat([x for ring in rings for group in ring for x in group]),
                          [[len(x) for x in group] for ring in rings for group in ring], box))
        out.append((cells, warps))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_ring_tiles_scan_each_source_of_the_box_once(kind):
    """The kernel's staging: each ring's row segments flattened into tiles
    of 32 (full but a group's last) scan every source of the final box once
    and no other, so each target's scored count is knn_grid_picks' (the
    row-by-row mirror's) and the (d2, index)-least three of what the tiles
    held are its picks, the plain version's."""
    src, tgt = (T_(a) for a in _cloud(kind, KINDS.index(kind) + 20))
    src, tgt = src[:1], tgt[:1, :512]  # one cloud, 16 warps
    want_idx, _, want_scored = knn_grid_picks(src, tgt)
    d2 = expanded_d2(tgt, sq_norm3(tgt), src, sq_norm3(src))[0]
    for cells, warps in _tile_scan(src, tgt):
        for ti, pos, lens, (c0, c1, r0, r1) in warps:
            st, gx = cells.starts[0], int(cells.gx[0])
            box = torch.cat([torch.arange(int(st[r * gx + c0]), int(st[r * gx + c1 + 1]))
                             for r in range(r0, r1 + 1)])
            assert torch.equal(pos.sort().values, box)  # each source of the box once
            assert bool((want_scored[0, ti] == len(pos)).all())
            for group in lens:  # tiles full but a group's last
                assert all(n == KNN_WARP for n in group[:-1]) and all(n > 0 for n in group)
            ids = cells.order[0, pos]
            for target in ti.tolist():
                order = sorted(range(ids.numel()), key=lambda j: (float(d2[target, ids[j]]),
                                                                  int(ids[j])))
                assert [int(ids[j]) for j in order[:3]] == want_idx[0, :, target].tolist()


@pytest.mark.parametrize("s,t,path", [
    (2500, 10000, "whole"),  # PROD FP1
    (625, 2500, "whole"),  # PROD FP2
    (ck.KNN_GRID_MIN_S - 1, 4 * ck.KNN_GRID_MIN_S, "whole"),
    (ck.KNN_GRID_MIN_S, 4 * ck.KNN_GRID_MIN_S, "grid"),
    (16384, 65536, "grid"),  # the dense plots' FP1
    (20000, 80000, "grid"),  # FP1 of the train step at N = 80,000
])
def test_knn_path_by_shape(s, t, path):
    """knn_path chooses by the number of sources: PROD on knn_kernel, the
    dense plots' FP1 on the cell grid."""
    assert ck.knn_path(s, t) == path
    assert ck.knn_path(s, 1) == path and ck.knn_path(s, 10 * t) == path


def test_constants_mirror_the_cuda_source():
    """The margin, the slack, the warp's targets and the grid's side in
    ops/csrc/ are the CPU mirror's and the wrapper's."""
    knn = (_build.CSRC / "knn_interpolate.cu").read_text()
    grid = (_build.CSRC / "cell_grid.cuh").read_text()

    def hexfloat(name):
        return float.fromhex(re.search(rf"constexpr double {name} = ([0-9a-fx.p+-]+);", knn)[1])

    assert hexfloat("kKnnMargin") == KNN_MARGIN == 2.0 ** -20
    assert hexfloat("kKnnSlack") == KNN_SLACK == 2.0 ** -22
    assert int(re.search(r"constexpr int kWarps = (\d+);", knn)[1]) == ck.KNN_WARPS
    assert re.search(r"const int first = \(blockIdx\.x \* kWarps \+ warp\) \* (\d+);", knn)[1] \
        == str(KNN_WARP)
    assert int(re.search(r"constexpr int kGridMax = (\d+);", grid)[1]) == NEAREST_GRID_MAX
    cap = re.search(r"inv_h = fminf\(__fdiv_rn\(static_cast<float>\(gmax\) - 0\.5f, "
                    r"fmaxf\(ex, ey\)\), ([0-9.e]+)f\);", grid)[1]
    assert np.float32(cap) == np.finfo(np.float32).max
    assert "EXTENT_GRID_KERNEL(knn_grid_kernel)" in knn


def test_wrappers_run_the_plain_versions_on_the_cpu_at_grid_shapes(monkeypatch):
    """Past the threshold (cut to 256 sources here) the wrapper on CPU
    tensors runs the plain version and launches nothing; the grid wrapper
    returns the same and the mirror's scanned sources; the autograd op
    runs through it."""
    monkeypatch.setattr(ck, "KNN_GRID_MIN_S", 256)
    src, tgt = _cloud("ragged", 5)
    x = np.random.default_rng(3).normal(size=(B, src.shape[1], 6)).astype(np.float32)
    assert ck.knn_path(src.shape[1], tgt.shape[1]) == "grid"
    ck.reset_launches()
    got = ck.knn_interpolate(T_(x), T_(src), T_(tgt))
    want = ck.knn_interpolate_plain(T_(x), T_(src), T_(tgt))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    *grid_out, scored = ck.knn_interpolate_grid(T_(x), T_(src), T_(tgt))
    for g, w in zip(grid_out, want):
        assert torch.equal(g, w)
    assert scored.dtype == torch.int32
    assert torch.equal(scored.long(), knn_grid_picks(T_(src), T_(tgt))[2])
    xs = T_(x).requires_grad_(True)
    port_knn.knn_interpolate(xs, T_(src), T_(tgt)).sum().backward()
    assert xs.grad is not None and bool(torch.isfinite(xs.grad).all())
    assert not any(ck.launch_counts().values()) and not any(ck.path_launch_counts().values())
