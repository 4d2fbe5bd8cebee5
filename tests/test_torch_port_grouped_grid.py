"""The grouped selection's long-group path on the cell grid, on the CPU.

On the card, groups longer than a kernel's staging slice (`cuda_kernels.
sel_path`: the dense plots' SA1) take `csrc/grouped_cull.cuh`: each
centroid scores only the points of its 3 x 3 cells of the nearest
selection's grid (`ops/ballquery.nearest_cells`) and folds each admitted
point's key (bits(d2) << 32) | index into its group's least. Here that is
modelled in plain PyTorch (`_culled_grouped`, the same keys over the same
candidates) and held to JAX's `ball_query(..., method="grouped")` index for
index on clouds that stress it: a tie-heavy integer grid, plots 1 km from
the origin (the culling radius's margin), 90% of the points in 5% of the
plot, and points sorted by x (each group a strip), all with groups past
1,816 points and a ragged last group. With groups of one point every
admitted point is a pick, so a far cloud loses picks without the margin.
Then the wrappers' choice of path by shape, the constants the kernel
shares with its wrapper, the kernel's division by g, and the SA kernel's
apply phase from a pick table in cell order, bit for bit the fused plain
version. chip_smoke.py holds the kernels to the plain versions on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.ops import ball_query as jax_ball_query
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.ops.ballquery import ball_query_grouped, nearest_cells, radius_sq
from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3

torch.set_num_threads(1)

B, C = 2, 256
K, N = 4, 4 * 1818 - 3  # groups of 1,818 points (past BQ_MAX_G), the last 3 points short
NONE = torch.iinfo(torch.int64).max  # an empty slot


def _uniform(rng, b, n, shift=(0.0, 0.0, 0.0)):
    """PROD-like plots: xy uniform over the 20 m plot, z in [0, 3] m."""
    xy = rng.uniform(-10, 10, (b, n, 2))
    z = rng.uniform(0, 3, (b, n, 1))
    return (np.concatenate([xy, z], -1) + np.asarray(shift)).astype(np.float32)


def _cloud(kind, seed):
    """(centroids, points, radius) of one test cloud; centroids are points."""
    rng = np.random.default_rng(seed)
    if kind == "grid":  # integer coordinates, an eighth duplicated: ties at the least d2
        pts = rng.integers(0, 16, (B, N, 3)).astype(np.float32)
        pts[:, N // 2 : N // 2 + N // 8] = pts[:, : N // 8]
    elif kind == "shifted":  # |p|^2 ~ 2e6, one ulp 0.125 m^2
        pts = _uniform(rng, B, N, (1000.0, 1000.0, 0.0))
    elif kind == "clustered":  # 90% of the points in 5% of the plot
        pts = _uniform(rng, B, N)
        side = 20 * 0.05 ** 0.5
        crowd = rng.random((B, N)) < 0.9
        pts[..., :2] = np.where(crowd[..., None], rng.uniform(-side / 2, side / 2, (B, N, 2)),
                                pts[..., :2]).astype(np.float32)
    elif kind == "sorted":  # each group a strip of the plot
        pts = _uniform(rng, B, N)
        pts = np.take_along_axis(pts, np.argsort(pts[..., 0], axis=1)[..., None], 1)
    else:
        raise ValueError(kind)
    cent = pts[:, rng.permutation(N)[:C]]
    return torch.from_numpy(np.ascontiguousarray(cent)), torch.from_numpy(pts), 2 ** 0.5


def _culled_grouped(cent, pts, radius, k, margin_ulps=None):
    """The grid kernel's picks in plain PyTorch: over each centroid's 3 x 3
    cells, per group the least key (bits(d2) << 32) | index of the points
    within the radius; idx 0 and mask False where a group has none."""
    kw = {} if margin_ulps is None else {"margin_ulps": margin_ulps}
    grid = nearest_cells(cent, pts, radius, **kw)
    b, n, _ = pts.shape
    d2 = expanded_d2(cent, sq_norm3(cent), pts, sq_norm3(pts))
    admitted = grid.candidates() & (d2 <= radius_sq(radius))
    bits = d2.view(torch.int32).long() & 0x7FFFFFFF  # the sign bit cleared, as the kernel
    key = torch.where(admitted, (bits << 32) | torch.arange(n), NONE)
    group = (torch.arange(n) // -(-n // k)).expand_as(key)
    least = torch.full((b, cent.shape[1], k), NONE).scatter_reduce(2, group, key, "amin")
    mask = least != NONE
    return torch.where(mask, least & 0xFFFFFFFF, 0), mask, grid, d2


KINDS = ("grid", "shifted", "clustered", "sorted")


@pytest.mark.parametrize("kind", KINDS)
def test_culled_grouped_picks_equal_jax(kind):
    cent, pts, radius = _cloud(kind, seed=KINDS.index(kind))
    g = -(-N // K)
    assert ck.sel_path(g, ck.BQ_MAX_G) == "grid" and N - (K - 1) * g < g  # ragged last group
    idx, mask, grid, d2 = _culled_grouped(cent, pts, radius, K)
    want_idx, want_mask = jax_ball_query(jnp.asarray(cent.numpy()), jnp.asarray(pts.numpy()),
                                         radius, K, method="grouped")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # the invariant: no pair the plain version admits lies outside the candidates
    admitted = d2 <= radius_sq(radius)
    assert not bool((admitted & ~grid.candidates()).any())
    # most groups hold a point within the radius, but for strips (sorted) the
    # one or two that a centroid's ball meets
    assert (0.2 < float(mask.float().mean()) < 0.5) == (kind == "sorted")
    if kind == "grid":  # in about half the groups the least d2 is shared by several points
        least = torch.where(admitted, d2, float("inf")).reshape(B, C, -1)
        first = least[..., : (K - 1) * g].reshape(B, C, K - 1, g)
        ties = (first == first.amin(-1, keepdim=True)) & torch.isfinite(first)
        assert float((ties.sum(-1) > 1).float().mean()) > 0.4
    if kind == "shifted":  # the margin widens the cells: more candidates, none lost
        assert float(grid.rc2.min()) > 2.0 + 1.0
    if kind == "clustered":  # the crowd's centroids score most of the cloud
        assert float(grid.scored.float().mean()) > 0.4 * N
    if kind == "sorted":  # a centroid's cells hold few groups' points
        assert float(grid.scored.float().mean()) < 0.2 * N


def test_without_the_margin_a_far_cloud_loses_a_grouped_pick():
    """Groups of one point (K = N): every admitted point is a pick, so the
    far cloud of `test_torch_port_nearest_grid.py::
    test_without_the_margin_a_far_cloud_loses_picks` loses a grouped pick
    when the culling radius drops its rounding margin, and none with it."""
    rng = np.random.default_rng(11)
    pts = _uniform(rng, B, 4096, (1000.0, 1000.0, 0.0))
    cent = torch.from_numpy(np.ascontiguousarray(pts[:, rng.permutation(4096)[:1024]]))
    pts = torch.from_numpy(pts)
    radius, k = 2 ** 0.5, 4096
    want_idx, want_mask = ball_query_grouped(cent, pts, radius, k)
    idx, mask, _, _ = _culled_grouped(cent, pts, radius, k, margin_ulps=0)
    assert int((mask != want_mask).sum()) > 0
    idx, mask, _, _ = _culled_grouped(cent, pts, radius, k)
    assert torch.equal(mask, want_mask) and torch.equal(idx, want_idx)


@pytest.mark.parametrize("wrapper,n,k,ch,want", [
    ("ball_query", 10000, 32, None, "whole"),  # PROD SA1 of the train step: g = 313
    ("ball_query", 2500, 64, None, "whole"),  # PROD SA2: g = 40
    ("ball_query", 32 * 1816, 32, None, "whole"),  # the longest group staged whole
    ("ball_query", 32 * 1816 + 1, 32, None, "grid"),  # one point past it
    ("ball_query", 65536, 32, None, "grid"),  # the dense train step's SA1: g = 2048
    ("ball_query", 16384, 64, None, "whole"),  # its SA2: g = 256
    ("ball_query", 80000, 32, None, "grid"),  # the 80,000-point step's SA1: g = 2500
    ("sa_fused_eval", 10000, 32, 16, "whole"),  # PROD SA1 serving
    ("sa_fused_eval", 2500, 64, 32, "whole"),  # PROD SA2
    ("sa_fused_eval", 32 * 1741, 32, 16, "whole"),  # SA1's longest group staged whole
    ("sa_fused_eval", 32 * 1741 + 1, 32, 16, "grid"),
    ("sa_fused_eval", 65536, 32, 16, "grid"),  # the dense serve step's SA1
    ("sa_fused_eval", 64 * 1686 + 1, 64, 32, "grid"),  # past SA2's instance at K = 64
    ("sa_fused_eval", 4000, 1000, 16, "grid"),  # no slice left beside a (64, K) pick table
])
def test_selection_path_by_shape(wrapper, n, k, ch, want):
    """Every PROD shape stays on the whole-group kernels; every group past
    the wrapper's slice takes the cell grid, whatever K (the SA kernel's
    slice is what its parameters and (64, K) pick table leave)."""
    g = -(-n // k)
    max_g = ck.BQ_MAX_G if wrapper == "ball_query" else ck.sa_fused_eval_max_g(
        ch, ch, ch == 16, k)
    assert ck.sel_path(g, max_g) == want


def test_cull_constants_mirror_the_cuda_source():
    """CULL_CENTS and CULL_SLOTS are csrc/grouped_cull.cuh's kCullCents and
    kCullSlots: the slot tables of a block's centroids (kCullCents a warp)
    fit its shared memory, and K past kCullSlots takes windows."""
    src = (Path(ck.__file__).parent / "csrc" / "grouped_cull.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["kCullCents"], const["kCullSlots"]) == (ck.CULL_CENTS, ck.CULL_SLOTS)
    assert const["kCullWarps"] * const["kCullCents"] * ck.CULL_SLOTS * 8 <= ck._SMEM_MAX


@pytest.mark.parametrize("g", [1, 2, 3, 7, 313, 1817, 2048, 2500, 65535, 2 ** 20 + 1,
                               2 ** 31 - 1])
def test_group_division_by_multiply_high(g):
    """csrc/grouped_cull.cuh's i / g: umulhi(2 i, m) >> l with l =
    ceil(log2 g) and m = ceil(2^(31 + l) / g), exact for 0 <= i < 2^31."""
    l = (g - 1).bit_length()
    m = -(-(1 << (31 + l)) // g)
    assert m < 2 ** 32
    rng = np.random.default_rng(g % 1000)
    i = np.concatenate([rng.integers(0, 2 ** 31, 4096),
                        [0, g - 1, g, 2 ** 31 - 1, (2 ** 31 - 1) // g * g,
                         (2 ** 31 - 1) // g * g - 1]]).astype(np.uint64)
    got = (((i << np.uint64(1)) * np.uint64(m)) >> np.uint64(32)) >> np.uint64(l)
    np.testing.assert_array_equal(got, i // np.uint64(g))


@pytest.mark.parametrize("ch,two,k", [(16, True, 32), (32, False, 64)])
def test_apply_from_picks_in_cell_order_equals_the_fused_plain(ch, two, k):
    """The SA kernel's grid path applies its layers to a pick table (-1
    where a group has none), centroids taken in cell order and each row
    written back at its centroid's own index: bit for bit the fused plain
    version, whose picks are the same (`sa_apply_plain` on
    `ball_query_plain`'s picks and `nearest_cells`' order)."""
    rng = np.random.default_rng(ch)
    pts = torch.from_numpy(_uniform(rng, B, 4096))
    cent = pts[:, torch.from_numpy(rng.permutation(4096)[:512])].contiguous()
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q, cterm = t(B, 4096, ch), t(B, 512, ch)
    a1, c1 = t(ch).abs() + 0.5, t(ch) * 0.1
    layer2 = (t(ch, ch) * 0.25, t(ch) * 0.1, t(ch).abs() + 0.5, t(ch) * 0.1) if two else (None,) * 4
    radius = 2 ** 0.5 if two else 8 ** 0.5
    idx, mask = ck.ball_query_plain(cent, pts, radius, k)
    picks = torch.where(mask, idx, -1)
    order = nearest_cells(cent, pts, radius).cent_order
    assert not torch.equal(order, torch.arange(512).expand_as(order))
    got = ck.sa_apply_plain(q, cterm, a1, c1, *layer2, picks, order)
    want = ck.sa_fused_eval_plain(q, pts, cent, cterm, a1, c1, *layer2, radius, k)
    assert torch.equal(got, want)
    assert bool((~mask).any()) and bool(mask.any(-1).all())


def test_wrappers_run_the_plain_versions_on_the_cpu_at_grid_shapes():
    """On CPU tensors the wrappers run the plain versions at a grid-path
    shape and count no launch of any wrapper or path."""
    cent, pts, radius = _cloud("sorted", seed=5)
    ck.reset_launches()
    idx, mask = ck.ball_query(cent, pts, radius, K)
    want_idx, want_mask = ck.ball_query_plain(cent, pts, radius, K)
    assert torch.equal(idx, want_idx) and torch.equal(mask, want_mask)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((B, N, 32)).astype(np.float32))
    cterm = torch.from_numpy(rng.standard_normal((B, C, 32)).astype(np.float32))
    ones, zeros = torch.ones(32), torch.zeros(32)
    out = ck.sa_fused_eval(q, pts, cent, cterm, ones, zeros, None, None, None, None, radius, K)
    want = ck.sa_fused_eval_plain(q, pts, cent, cterm, ones, zeros, None, None, None, None,
                                  radius, K)
    assert torch.equal(out, want)
    assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)
    assert ck.path_launch_counts() == dict.fromkeys(ck.PATHS, 0)
