"""Dense plots: the shapes past the PROD kernels' reach, on the CPU against
the JAX package, and the wrappers' choice of path by shape.

Users reach these shapes through `--subsample_size` and `--diam_pix`: FPS
rows over 16,384 points (`cuda_kernels.fps_path`: a block cluster a row on
the card), grouped-selection groups longer than a warp's staging slice
(`cuda_kernels.sel_path`: the cell grid), kNN from many sources
(`cuda_kernels.knn_path`: the cell grid, tests/test_torch_port_knn_grid.py)
and pixel tables past a block's shared memory (`cuda_kernels.
pixel_max_range`: pixel ranges sized for two blocks an SM). On the
CPU each wrapper runs its plain version, which must match JAX at those
shapes: FPS and selection picks exactly, projections and the dense forward
within the model tests' atol 2e-5 (values in [0, 1] that differ by rounding
only). The kernels' paths are held to the plain versions on the card by
chip_smoke.py's dense phase and reference sites.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.config import ModelConfig as JaxModelConfig, default_config as jax_config
from stratanet2_tpu.inference.predict import make_predict_step as jax_predict_step
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init, pointnet2_forward
from stratanet2_tpu.ops import ball_query, farthest_point_sampling as jax_fps
from stratanet2_tpu.ops import projection as jproj
from stratanet2_tpu.ops.fps import _fps_lax
from stratanet2_tpu_torch.config import ModelConfig, default_config
from stratanet2_tpu_torch.inference.predict import make_predict_step
from stratanet2_tpu_torch.ops import (
    ball_query_grouped,
    batched_raster_projection,
    cuda_kernels as ck,
    farthest_point_sampling,
    plotwise_coverages,
)
from stratanet2_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

ATOL = 2e-5  # tests/test_torch_port_model.py's: values in [0, 1], rounding only


def T(a):
    return torch.from_numpy(np.array(a))


def _grid(rng, b, n, side=16):
    """Integer coordinates in [0, side): every distance an exact integer,
    most FPS picks and selections decided by the first-index rule."""
    return rng.integers(0, side, (b, n, 3)).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(16)


# ---------------------------------------------------------------------------
# the paths, by shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,rows,want", [
    (2500, 20, ("block", 1, 1024)),  # PROD SA2's rows
    (5000, 40, ("block", 1, 1024)),  # PROD SA1's parts (N=10000, fps_parts=2)
    (10000, 20, ("block", 1, 1024)),  # PROD SA1 unpartitioned
    (16384, 20, ("block", 1, 1024)),  # fps_kernel's last row: 16 points a thread
    (16385, 2, ("cluster", 7, 512)),  # 5 points a thread in 7 blocks of 512 (8 take as many)
    (32768, 40, ("cluster", 5, 512)),  # the dense serve step's SA1 parts: 47 clusters of 5
    (32768, 20, ("cluster", 8, 512)),  # 8 points a thread, every size one wave
    (32769, 40, ("cluster", 5, 512)),  # past 2 blocks' slices: 1024s take two waves, 512s one
    (40000, 40, ("cluster", 5, 512)),  # the 80,000-point train step's SA1 parts
    (40001, 4, ("cluster", 8, 512)),
    (65537, 4, ("cluster", 8, 1024)),  # past 8 blocks of 512: 1024s, 9 points a thread
    (131072, 1, ("cluster", 8, 1024)),  # the cluster's reach: 8 slices of 16,384
    (131073, 1, ("global", 8, 1024)),
    (200000, 1, ("global", 8, 1024)),  # FPS_REFERENCE's global site
    (32768, 80, ("cluster", 5, 512)),  # B=40: two waves at best, 13 points a thread
])
def test_fps_path_by_row_length(n, rows, want):
    """fps_kernel up to 16,384 points a row; past it a cluster of cs blocks a
    row (of 1024 threads, one an SM, or 512, two an SM) whose slices fit in
    shared memory, chosen from the rows and the card's resident clusters
    (FPS_RESIDENT, an H100's): the fewest waves of clusters (all rows at
    once where some instance allows it), then 512-thread blocks, then the
    fewest points a thread, then the fewest blocks."""
    assert ck.fps_path(n, rows) == want
    path, cs, threads = want
    res = ck.FPS_RESIDENT

    def pts(c, t):
        return -(-(-(-n // c)) // t)

    def waves(c, t):
        return -(-rows // res[t][c])

    if path == "cluster":
        fit = [(t, c) for t in res for c in range(2, ck.FPS_CLUSTER_MAX + 1)
               if -(-n // c) <= 16 * t]
        assert (threads, cs) in fit and waves(cs, threads) == min(waves(c, t) for t, c in fit)
        same = [(t, c) for t, c in fit if waves(c, t) == waves(cs, threads)]
        assert (threads == ck.FPS_PAIR_THREADS) == any(t == ck.FPS_PAIR_THREADS for t, _ in same)
        assert pts(cs, threads) == min(pts(c, t) for t, c in same if t == threads)
        # every row at once where some instance allows it
        assert (waves(cs, threads) == 1) == (rows <= max(res[t][c] for t, c in fit))
        assert pts(cs, threads) <= 16
    if path == "global":
        assert threads == ck.FPS_THREADS and rows <= res[threads][cs]


def _sa_smem(gc, ch1, ch2, two, k):
    """csrc/sa_fused_eval.cu's shared memory: the staging slices, the
    parameters padded to float4 and the (SEL_TILE, K) pick table."""
    n_prm = 2 * ch1 + (ch1 * ch2 + 3 * ch2 if two else 0)
    return 16 * ck.SEL_WARPS * gc + 4 * (-(-n_prm // 4) * 4) + 4 * ck.SEL_TILE * k


@pytest.mark.parametrize("g,want", [(313, "whole"), (1815, "whole"), (1816, "whole"),
                                    (1817, "grid"), (2048, "grid")])
def test_ball_query_chunk_by_group(g, want):
    """The standalone query stages a whole group up to BQ_MAX_G points (8
    warps' slices fill 227 KB) and takes the cell grid past it; PROD's
    groups (313 at SA1, 40 at SA2) are staged whole."""
    assert ck.sel_path(g, ck.BQ_MAX_G) == want
    assert 16 * ck.SEL_WARPS * ck.BQ_MAX_G <= ck._SMEM_MAX < 16 * ck.SEL_WARPS * (ck.BQ_MAX_G + 1)


@pytest.mark.parametrize("ch1,ch2,two,k,prod_g", [(16, 16, True, 32, 313), (32, 32, False, 64, 40)])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_sa_fused_eval_chunk_by_group(ch1, ch2, two, k, prod_g, delta):
    """The SA eval kernel's slice is what its parameters and pick table
    leave of 227 KB: a group one point longer takes the cell grid, one
    shorter or equal is staged whole, and PROD's group is staged whole."""
    max_g = ck.sa_fused_eval_max_g(ch1, ch2, two, k)
    assert _sa_smem(max_g, ch1, ch2, two, k) <= ck._SMEM_MAX < _sa_smem(max_g + 1, ch1, ch2, two, k)
    g = max_g + delta
    assert ck.sel_path(g, max_g) == ("grid" if delta > 0 else "whole")
    assert ck.sel_path(prod_g, max_g) == "whole"
    assert max_g == {(16, 32): 1741, (32, 64): 1686}[ch1, k]


@pytest.mark.parametrize("n_pix,c,per", [
    (400, 3, 400),  # PROD: diam_pix 20
    (9604, 3, 9604),  # diam_pix 98
    (9685, 3, 9685),  # 232,440 B: the last table that fits
    (9686, 3, 3229),  # 232,464 B: one pixel past; two ranges of 116,232 B leave one block an SM
    (10000, 3, 3334),  # diam_pix 100, the dense phase's: three ranges of 80,016 B
    (90000, 3, 4737),  # diam_pix 300: 19 ranges
    (10000, 1, 10000),  # one channel: 80,000 B, one range
])
def test_pixel_max_path_by_table(n_pix, c, per):
    """A table of 8 n_pix c bytes of 64-bit keys is one pixel range (a
    cluster a cloud) while it fits in 232,448 B, else the fewest pixel
    ranges whose tables leave two blocks on an SM (228 KB of shared memory,
    1 KB reserved a block)."""
    assert ck.pixel_max_range(n_pix, c) == per
    ranges = -(-n_pix // per)
    assert (8 * n_pix * c <= ck._SMEM_MAX) == (ranges == 1)
    if ranges > 1:
        assert 2 * (8 * per * c + 1024) <= 228 * 1024
        assert 2 * (8 * -(-n_pix // (ranges - 1)) * c + 1024) > 228 * 1024


def _pixel_max_ranges_model(pix, vals, n_pix):
    """pixel_max_kernel over the ranges of `pixel_max_range` on the CPU:
    per range and each of the cluster's 8 blocks' contiguous shares of the
    points, the max of the (ord(v) << 32 | ~index) keys of its points in
    the range, then the max over the 8 blocks' tables, decoded."""
    b, n, c = vals.shape
    per = ck.pixel_max_range(n_pix, c)
    share = -(-n // ck.PIXEL_MAX_CLUSTER)
    u = vals.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    order = torch.where(u >= 2 ** 31, (~u) & 0xFFFFFFFF, u | 2 ** 31)  # order_key
    # the unsigned keys less 2^63, which orders them alike in int64
    keys = ((order - 2 ** 31) << 32) | (0xFFFFFFFF - torch.arange(n)[None, :, None])
    empty = torch.iinfo(torch.int64).min
    vmax = torch.full((b, n_pix, c), ck.NEG)
    amax = torch.full((b, n_pix, c), -1, dtype=torch.int32)
    for lo in range(0, n_pix, per):
        cnt = min(per, n_pix - lo)
        merged = torch.full((b, cnt, c), empty, dtype=torch.int64)
        for r in range(ck.PIXEL_MAX_CLUSTER):
            mine = torch.zeros(n, dtype=torch.bool)
            mine[r * share:(r + 1) * share] = True
            inside = (pix >= lo) & (pix < lo + cnt) & mine
            slot = torch.where(inside, pix - lo, cnt).long()[..., None].expand(b, n, c)
            table = torch.full((b, cnt + 1, c), empty, dtype=torch.int64)
            table = table.scatter_reduce(1, slot, keys.expand(b, n, c), "amax")[:, :cnt]
            merged = torch.maximum(merged, table)
        hi = (merged >> 32) + 2 ** 31
        bits = torch.where(hi >= 2 ** 31, hi & 0x7FFFFFFF, (~hi) & 0xFFFFFFFF)  # order_value
        vmax[:, lo:lo + cnt] = torch.where(merged == empty, ck.NEG, bits.int().view(torch.float32))
        amax[:, lo:lo + cnt] = torch.where(
            merged == empty, -1, 0xFFFFFFFF - (merged & 0xFFFFFFFF)).int()
    return vmax, amax


@pytest.mark.parametrize("p,n", [(100, 20011), (300, 30007)])
def test_pixel_max_ranges_plan_matches_plain(rng, p, n):
    """pixel_max_kernel's ranges (three at P = 100, 19 at 300) and its 8
    blocks' shares with their keys give `pixel_max_plain`'s maxima and
    first argmax exactly: quantised values tie across shares and on both
    sides of the ranges' boundaries, some ids fall outside the table and a
    band of pixels stays empty."""
    n_pix = p * p
    pix = rng.integers(-n_pix // 8, n_pix + n_pix // 8, (2, n)).astype(np.int32)
    pix[(pix >= n_pix // 4) & (pix < n_pix // 4 + n_pix // 8)] = -1
    vals = (rng.integers(-2, 3, (2, n, 3)) / 2).astype(np.float32)
    want_v, want_a = ck.pixel_max_plain(T(pix), T(vals), n_pix)
    got_v, got_a = _pixel_max_ranges_model(T(pix), T(vals), n_pix)
    assert ck.pixel_max_range(n_pix, 3) < n_pix
    np.testing.assert_array_equal(got_a.numpy(), want_a.numpy())
    np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())


@pytest.mark.parametrize("b,n,c,k,plan", [
    (20, 10000, 2500, 32, None),  # PROD SA1
    (20, 2500, 625, 64, None),  # PROD SA2
    (20, 65536, 16384, 32, None),  # the dense phase's SA1
    (1, 74375, 18593, 32, None),  # 58,112 ints: the last SA1 shape that fits
    (1, 74376, 18594, 32, (291, 18594)),  # 58,114 ints: one point past
    (1, 80000, 20000, 32, (313, 20000)),  # chip_smoke.DQ_REFERENCE: 8 windows a group
    (20, 80000, 20000, 32, (1250, 17661)),  # the 80,000-point train step's SA1 site
    (1, 400000, 100000, 32, (1563, 14844)),  # lists past shared memory go to device memory
])
def test_sa_train_dq_windows_by_shape(b, n, c, k, plan):
    """sa_train_bwd2's dq pass takes a group whole (the PROD instance) while
    its keys, lists, counts and starts fit in 232,448 B; past that, windows
    of gp points: the most that keep the grid within one wave of two blocks
    on each of 132 SMs, at least one, and enough that counts and starts
    take a quarter of a block at most; two blocks' shared memory within an
    SM's 228 KB, and at most one list entry a centroid held in shared
    memory."""
    g = -(-n // k)
    assert ck.sa_train_dq_plan(b, n, c, k) == plan
    assert (4 * (2 * c + 9 * g + 1) <= ck._SMEM_MAX) == (plan is None)
    if plan is not None:
        gp, lcap = plan
        w = -(-g // gp)
        assert (w - 1) * gp < g <= w * gp
        counts_w = -(-g // ((ck._SMEM_MAX // 16 - 1) // 9))  # the fewest windows counts allow
        assert w == max(1, counts_w, 2 * 132 // (k * b))
        assert w == counts_w or w * k * b <= 2 * 132 < (w + 1) * k * b
        assert 4 * (9 * gp + 1) <= ck._SMEM_MAX // 4 and lcap <= c
        assert 2 * (4 * (9 * gp + 1 + lcap) + 64 + 1024) <= 228 * 1024


def _dq_windows_walk(de, idx, mask, n, gp, lcap):
    """csrc/sa_train.cu's windowed dq pass in plain PyTorch, block by block:
    the keys (slot j of centroid c as an offset in group j, -1 if masked),
    then for window w of group j of cloud b the counting sort of its
    points' picks, stable in c (the eight warps' spans in turn), the group's
    entries before the window, the lists in shared memory while they hold at
    most lcap entries and else at that offset of the device-memory lists,
    and each point's row summed from 0 in list order, one float32 add at a
    time. Returns dq and how many windows used the device-memory lists."""
    b, c, k = idx.shape
    ch = de.shape[2]
    g = -(-n // k)
    keys = torch.where(mask, idx - torch.arange(k) * g, -1)
    keys = torch.where((keys >= 0) & (keys < g), keys, -1).permute(0, 2, 1)  # (B, K, C)
    dq = torch.full((b, n, ch), float("nan"))
    span = -(-c // 8)
    spilled = 0
    for bi in range(b):
        for j in range(k):
            taken = torch.zeros(c, dtype=torch.bool)  # device-memory list slots written
            for lo in range(0, g, gp):
                gs = max(0, min(gp, min(g, n - j * g) - lo))
                if gs == 0:
                    continue
                kb = keys[bi, j]
                before = int(((kb >= 0) & (kb < lo)).sum())
                lists = [[] for _ in range(gs)]
                for w0 in range(0, c, span):  # the warps' spans, each in increasing c
                    for cc in range(w0, min(c, w0 + span)):
                        d = int(kb[cc]) - lo
                        if 0 <= d < gs:
                            lists[d].append(cc)
                total = sum(map(len, lists))
                if total > lcap:  # the window's region of the group's device-memory lists
                    spilled += 1
                    assert before + total <= c and not taken[before:before + total].any()
                    taken[before:before + total] = True
                for p, lst in enumerate(lists):
                    acc = torch.zeros(ch)
                    for cc in lst:
                        acc = acc + de[bi, cc * k + j]  # float32, rounded once an add
                    dq[bi, j * g + lo + p] = acc
    return dq, spilled


@pytest.mark.parametrize("gp,lcap,hot", [(7, 1000, False), (50, 1000, False), (13, 6, True),
                                         (250, 10, True)])
def test_sa_train_dq_windows_walk_equals_ordered_plain(rng, gp, lcap, hot):
    """The windowed dq pass, walked in plain PyTorch on a small shape (B=2,
    N=2,000, C=500, K=8: groups of 250 points) with windows of gp points,
    equals `sa_train_dq_ordered_plain` bit for bit: each point's row is 0
    plus its valid edges in increasing c. With `hot`, 80% of slot j's picks
    fall on the group's first 20 points, so windows outgrow lcap and place
    their lists in device memory, in regions that never overlap."""
    b, n, c, k, ch = 2, 2000, 500, 8, 16
    g = n // k
    off = rng.integers(0, 20 if hot else g, (b, c, k))
    if hot:
        off = np.where(rng.uniform(size=off.shape) < 0.8, off, rng.integers(0, g, off.shape))
    idx = torch.from_numpy((off + np.arange(k) * g).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(size=(b, c, k)) < 0.7)
    # values over many binades, so that another order of adds changes the bits
    de = torch.from_numpy((rng.normal(size=(b, c * k, ch)) *
                           10.0 ** rng.integers(-4, 5, (b, c * k, 1))).astype(np.float32))
    de[~mask.reshape(b, c * k)] = 0.0
    got, spilled = _dq_windows_walk(de, idx, mask, n, gp, lcap)
    want = ck.sa_train_dq_ordered_plain(de, idx, mask, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (spilled > 0) == hot


# ---------------------------------------------------------------------------
# the plain versions against JAX at the dense shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16385, 40001])
def test_fps_long_rows_match_fps_lax(rng, n):
    """Rows past fps_kernel's 16,384 points (the cluster path on the card),
    index for index against `_fps_lax` on tie-heavy grid clouds."""
    assert ck.fps_path(n, 2)[0] == "cluster"
    xyz = _grid(rng, 2, n)
    start = np.array([0, n - 1], np.int32)
    want = jax.vmap(lambda p, st: _fps_lax(p, 512, st))(jnp.asarray(xyz), jnp.asarray(start))
    ck.reset_launches()
    got = ck.fps(T(xyz), 512, T(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ck.path_launch_counts() == dict.fromkeys(ck.PATHS, 0)  # CPU: the plain version


def test_fps_partitioned_long_rows_match_jax(rng):
    """N=32,770 in two parts of 16,385 points (one past fps_kernel's rows),
    S=1024, through `farthest_point_sampling` on both sides."""
    xyz = _grid(rng, 2, 32770)
    start = np.array([3, 20000], np.int32)
    want = jax_fps(jnp.asarray(xyz), 1024, start_idx=jnp.asarray(start), use_pallas=False,
                   parts=2)
    got = farthest_point_sampling(T(xyz), 1024, start_idx=T(start), parts=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [60000, 58113])
def test_grouped_selection_long_groups_matches_jax(rng, n):
    """Groups past BQ_MAX_G and the SA1 eval kernel's slice (g = 1875 at
    N=60,000, K=32; g = 1817 at N=58,113, one past BQ_MAX_G, with a ragged
    last group) on a tie-heavy grid: ~15 points a grid cell, so most picks
    take the first of several points at the least d2. Index for index."""
    k, c = 32, 64
    g = -(-n // k)
    assert ck.sel_path(g, ck.BQ_MAX_G) == "grid"
    assert ck.sel_path(g, ck.sa_fused_eval_max_g(16, 16, True, k)) == "grid"
    pts = _grid(rng, 1, n)
    cent = pts[:, rng.choice(n, c, replace=False)]
    want_idx, want_mask = ball_query(jnp.asarray(cent), jnp.asarray(pts), 2 ** 0.5, k,
                                     method="grouped")
    idx, mask = ball_query_grouped(T(cent), T(pts), 2 ** 0.5, k)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert 0.8 < float(mask.float().mean()) < 1  # ~3 of a group's points within sqrt(2)


def _projection_inputs(rng, n):
    cov = rng.uniform(size=(2, n, 4)).astype(np.float32)
    cov[..., 0] = np.round(cov[..., 0] * 4) / 4  # tied maxima within pixels
    xy = rng.uniform(-1, 1, size=(2, n, 2)).astype(np.float32)
    return cov, xy


def test_plotwise_coverages_diam_pix_100_matches_jax(rng):
    """A 10,000-pixel table (240,000 B of keys at three channels: three
    pixel ranges on the card)."""
    assert ck.pixel_max_range(100 * 100, 3) < 100 * 100
    cov, xy = _projection_inputs(rng, 5000)
    want = jproj.plotwise_coverages(jnp.asarray(cov), jnp.asarray(xy), 100)
    got = plotwise_coverages(T(cov), T(xy), 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_batched_raster_projection_diam_pix_100_matches_jax(rng):
    """Per-pixel maxima of the same values: exact, NaN where no point falls."""
    cov, xy = _projection_inputs(rng, 5000)
    want = np.asarray(jproj.batched_raster_projection(jnp.asarray(xy * 0.9), jnp.asarray(cov),
                                                      100, 20))
    got = batched_raster_projection(T(xy * 0.9), T(cov), 100, 20).numpy()
    assert got.shape == (2, 3, 100, 100) and np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_dense_serve_forward_matches_jax(rng):
    """One serve forward of the whole model at B=1, N=16,400 with
    fps_parts=1 (SA1's FPS row of 16,400 points, past fps_kernel's) and
    diam_pix=100 (three pixel ranges), default channel plan, BN running
    statistics random: coverages, probabilities, rasters and plot coverages
    within the model tests' tolerance."""
    n = 16400
    assert ck.fps_path(n, 1)[0] == "cluster" and ck.pixel_max_range(100 * 100, 3) < 100 * 100
    jcfg = JaxModelConfig(subsample_size=n, fps_parts=1, diam_pix=100, use_pallas=False)
    pcfg = ModelConfig(subsample_size=n, fps_parts=1, diam_pix=100)
    model = jax_init(jax.random.PRNGKey(16), jcfg)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    state = jax.tree_util.tree_map(np.asarray, model.state)
    for name in state:
        for lp, ls in zip(params[name]["layers"], state[name]["layers"]):
            c = ls["mean"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jmodel = PointNet2Params(jax.tree_util.tree_map(jnp.asarray, params),
                             jax.tree_util.tree_map(jnp.asarray, state))
    xy = rng.uniform(-10, 10, (1, n, 2)).astype(np.float32)
    z = rng.uniform(0, 3, (1, n, 1)).astype(np.float32)
    xyz = np.concatenate([xy, z], -1)
    cloud = np.concatenate([xy / 10, z / 24.24, rng.uniform(0, 1, (1, n, 7))], -1)
    cloud = cloud.astype(np.float32)
    cov, proba, _ = pointnet2_forward(jmodel, jnp.asarray(cloud[..., 2:]), jnp.asarray(xyz),
                                      jcfg, train=False)
    rasters, pred_pl = jax_predict_step(replace(jax_config("DEV"), model=jcfg))(
        jmodel, jnp.asarray(cloud), jnp.asarray(xyz))
    port = from_jax_params(params, state, pcfg, device="cpu")
    with torch.no_grad():
        got_cov, got_proba = port(T(cloud[..., 2:]), T(xyz))
    np.testing.assert_allclose(got_cov.numpy(), np.asarray(cov), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_proba.numpy(), np.asarray(proba), rtol=0, atol=ATOL)
    step = make_predict_step(replace(default_config(), model=pcfg), device="cpu")
    got_r, got_p = step(port, cloud, xyz)
    want_r = np.asarray(rasters)
    assert got_r.shape == (1, 3, 100, 100) and np.isnan(want_r).any()
    np.testing.assert_array_equal(np.isnan(got_r.numpy()), np.isnan(want_r))
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(pred_pl), rtol=0, atol=ATOL)
