"""Dense plots: the shapes past the PROD kernels' reach, on the CPU against
the JAX package, and the wrappers' choice of path by shape.

Users reach these shapes through `--subsample_size` and `--diam_pix`: FPS
rows over 16,384 points (`cuda_kernels.fps_path`: a block cluster a row on
the card), grouped-selection groups longer than a warp's staging slice
(`cuda_kernels.sel_chunk`: chunks in index order) and pixel tables past a
block's shared memory (`cuda_kernels.pixel_max_range`: pixel ranges). On the
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


@pytest.mark.parametrize("n,want", [
    (2500, ("block", 1)),  # PROD SA2's row
    (5000, ("block", 1)),  # PROD SA1's part (N=10000, fps_parts=2)
    (10000, ("block", 1)),  # PROD SA1 unpartitioned
    (16384, ("block", 1)),  # fps_kernel's last row: 16 points a thread
    (16385, ("cluster", 2)),
    (32768, ("cluster", 2)),  # SA1's part at subsample_size 65,536
    (32769, ("cluster", 4)),
    (40001, ("cluster", 4)),
    (131072, ("cluster", 8)),  # the cluster's reach: 8 slices of 16,384
    (131073, ("global", 8)),
    (200000, ("global", 8)),
])
def test_fps_path_by_row_length(n, want):
    assert ck.fps_path(n) == want
    path, cs = want
    if path == "cluster":  # each slice fits in shared memory, with the fewest blocks
        assert -(-n // cs) <= ck.FPS_MAX_N and (cs == 2 or -(-n // (cs // 2)) > ck.FPS_MAX_N)


def _sa_smem(gc, ch1, ch2, two, k):
    """csrc/sa_fused_eval.cu's shared memory: the staging slices, the
    parameters padded to float4 and the (SEL_TILE, K) pick table."""
    n_prm = 2 * ch1 + (ch1 * ch2 + 3 * ch2 if two else 0)
    return 16 * ck.SEL_WARPS * gc + 4 * (-(-n_prm // 4) * 4) + 4 * ck.SEL_TILE * k


@pytest.mark.parametrize("g,want", [(313, 313), (1815, 1815), (1816, 1816), (1817, 1816),
                                    (2048, 1816)])
def test_ball_query_chunk_by_group(g, want):
    """The standalone query stages a whole group up to BQ_MAX_G points (8
    warps' slices fill 227 KB) and chunks past it; PROD's groups (313 at
    SA1, 40 at SA2) are staged whole."""
    assert ck.sel_chunk(g, ck.BQ_MAX_G) == want
    assert 16 * ck.SEL_WARPS * ck.BQ_MAX_G <= ck._SMEM_MAX < 16 * ck.SEL_WARPS * (ck.BQ_MAX_G + 1)


@pytest.mark.parametrize("ch1,ch2,two,k,prod_g", [(16, 16, True, 32, 313), (32, 32, False, 64, 40)])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_sa_fused_eval_chunk_by_group(ch1, ch2, two, k, prod_g, delta):
    """The SA eval kernel's slice is what its parameters and pick table
    leave of 227 KB: a group one point longer is chunked, one shorter or
    equal staged whole, and PROD's group is staged whole."""
    max_g = ck.sa_fused_eval_max_g(ch1, ch2, two, k)
    assert _sa_smem(max_g, ch1, ch2, two, k) <= ck._SMEM_MAX < _sa_smem(max_g + 1, ch1, ch2, two, k)
    g = max_g + delta
    assert ck.sel_chunk(g, max_g) == min(g, max_g)
    assert ck.sel_chunk(prod_g, max_g) == prod_g
    assert max_g == {(16, 32): 1741, (32, 64): 1686}[ch1, k]


@pytest.mark.parametrize("n_pix,c,per", [
    (400, 3, 400),  # PROD: diam_pix 20
    (9604, 3, 9604),  # diam_pix 98
    (9685, 3, 9685),  # 232,440 B: the last table that fits
    (9686, 3, 4843),  # 232,464 B: one pixel past
    (10000, 3, 5000),  # diam_pix 100, the dense phase's
    (90000, 3, 9000),  # diam_pix 300
])
def test_pixel_max_path_by_table(n_pix, c, per):
    """A table of 8 n_pix c bytes of 64-bit keys is one pixel range (a
    cluster a cloud) while it fits in 232,448 B, else the fewest pixel
    ranges that fit."""
    assert ck.pixel_max_range(n_pix, c) == per
    ranges = -(-n_pix // per)
    assert (8 * n_pix * c <= ck._SMEM_MAX) == (ranges == 1)
    assert 8 * per * c <= ck._SMEM_MAX
    if ranges > 1:
        assert 8 * -(-n_pix // (ranges - 1)) * c > ck._SMEM_MAX


def _dq_ints(gp, cc):
    """csrc/sa_train.cu's dq pass: a window's keys and lists (cc ints each),
    the eight warps' counts and the lists' starts (9 gp + 1 ints)."""
    return 2 * cc + 9 * gp + 1


@pytest.mark.parametrize("n,c,k,windowed", [
    (10000, 2500, 32, False),  # PROD SA1
    (2500, 625, 64, False),  # PROD SA2
    (65536, 16384, 32, False),  # the dense phase's SA1
    (74375, 18593, 32, False),  # 58,112 ints: the last SA1 shape that fits
    (74376, 18594, 32, True),  # 58,114 ints: one point past
    (80000, 20000, 32, True),  # chip_smoke.DQ_REFERENCE
    (400000, 100000, 32, True),  # a window of points and one of centroids
])
def test_sa_train_dq_windows_by_shape(n, c, k, windowed):
    """sa_train_bwd2's dq pass takes a group and all its centroids in one
    window while the lists and counts fit in 232,448 B, else windows that
    fit, as many points a window as half of it allows."""
    g = -(-n // k)
    gp, cc = ck.sa_train_dq_chunks(n, c, k)
    assert ((gp, cc) != (g, c)) == windowed
    assert (4 * _dq_ints(g, c) <= ck._SMEM_MAX) == (not windowed)
    assert 4 * _dq_ints(gp, cc) <= ck._SMEM_MAX and 1 <= gp <= g and 1 <= cc <= c
    if windowed and gp < g:  # the most points that half of the block holds
        assert 4 * _dq_ints(gp + 1, 0) > ck._SMEM_MAX // 2


# ---------------------------------------------------------------------------
# the plain versions against JAX at the dense shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16385, 40001])
def test_fps_long_rows_match_fps_lax(rng, n):
    """Rows past fps_kernel's 16,384 points (the cluster path on the card),
    index for index against `_fps_lax` on tie-heavy grid clouds."""
    assert ck.fps_path(n)[0] == "cluster"
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
    assert ck.sel_chunk(g, ck.BQ_MAX_G) < g
    assert ck.sel_chunk(g, ck.sa_fused_eval_max_g(16, 16, True, k)) < g
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
    """A 10,000-pixel table (240,000 B of keys at three channels: two pixel
    ranges on the card)."""
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
    diam_pix=100 (two pixel ranges), default channel plan, BN running
    statistics random: coverages, probabilities, rasters and plot coverages
    within the model tests' tolerance."""
    n = 16400
    assert ck.fps_path(n)[0] == "cluster" and ck.pixel_max_range(100 * 100, 3) < 100 * 100
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
