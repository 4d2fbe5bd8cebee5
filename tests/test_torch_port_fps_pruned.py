"""FPS's exact bucket pruning (csrc/fps.cu) against the JAX package on the
CPU, through its plain PyTorch mirror `cuda_kernels.fps_pruned_mirror`: the
slice sorted by the Hilbert index of its xy cells, 32 warps a slice with
their boxes and cached records, and a pick's skip test D >= M in the
kernel's fma order. The mirror's picks are held index for index to
`jax.vmap(_fps_lax)` (or to JAX's partitioned FPS), and the mirror also
counts, at every pick, the running minima that a skipped warp would have
lowered: 0 when the skip test is exact. The kernel itself is held to
`fps_plain` on the card by chip_smoke.py (FPS_REFERENCE, 0 differing
picks)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from stratanet2_tpu.ops import farthest_point_sampling as jax_fps
from stratanet2_tpu.ops.fps import _fps_lax
from stratanet2_tpu_torch.ops import _build, cuda_kernels as ck, farthest_point_sampling
from stratanet2_tpu_torch.ops.distance import sq_norm3

torch.set_num_threads(1)

LAMBERT93 = (6.5e5, 6.86e6, 200.0)  # a plot's offset in Lambert-93 metres


def _cloud(rng, kind, b, n):
    """(b, n, 3) float32 clouds that stress the sort and the skip test:
    "uniform" 20 m plots (z in [0, 3]); "grid" integer points in [0, 6)^3
    (equal distances everywhere); "dup" n / 8 distinct points each repeated
    eight times (fewer distinct points than picks: ties among zero minima);
    "clustered" 90% of the points in 5% of the plot; "line" points along x
    within 1 mm of a line; "km" a plot 1 km from the origin; "lambert" a
    plot at Lambert-93 scale (x ~ 6.5e5, y ~ 6.86e6 m: coordinates with an
    ulp of 0.06-0.5 m)."""
    if kind == "grid":
        return rng.integers(0, 6, (b, n, 3)).astype(np.float32)
    if kind == "dup":
        base = rng.uniform(-3, 3, (b, -(-n // 8), 3)).astype(np.float32)
        return np.repeat(base, 8, axis=1)[:, :n].copy()
    xyz = np.concatenate([rng.uniform(-10, 10, (b, n, 2)), rng.uniform(0, 3, (b, n, 1))], -1)
    if kind == "clustered":
        k = int(0.9 * n)
        xyz[:, :k, :2] = xyz[:, :k, :2] * 0.05 ** 0.5 + 3.0
        xyz = xyz[:, rng.permutation(n)]
    elif kind == "line":
        xyz[..., 1] *= 1e-4
    elif kind == "km":
        xyz += np.array([1000.0, 1000.0, 0.0])
    elif kind == "lambert":
        xyz += np.array(LAMBERT93)
    return xyz.astype(np.float32)


def _jax_picks(xyz, s, start):
    return np.asarray(jax.vmap(lambda p, st_: _fps_lax(p, s, st_))(jnp.asarray(xyz),
                                                                   jnp.asarray(start)))


@pytest.mark.parametrize("kind,n,s,slices", [
    ("grid", 1100, 1100, 1),      # S = N: every tie, and picks past the distinct positions
    ("dup", 1100, 1100, 1),       # fewer distinct points than picks
    ("uniform", 3000, 750, 1),    # PROD's SA1 part shape, cut (3 points a thread)
    ("clustered", 2048, 512, 1),
    ("line", 2048, 512, 1),
    ("km", 2048, 512, 1),
    ("lambert", 2048, 512, 1),
    ("grid", 3000, 1500, 3),      # a cluster's slices: 3 blocks of 1,000 points
    ("lambert", 2500, 625, 2),
    ("uniform", 1030, 1030, 2),   # slices of 515: most warps of each block hold no point
])
def test_pruned_mirror_matches_fps_lax(rng, kind, n, s, slices):
    """The mirror picks index for index as `_fps_lax`, and no skipped warp
    update would have lowered a running minimum."""
    xyz = _cloud(rng, kind, 2, n)
    start = np.array([0, n - 1], np.int32)
    got = ck.fps_pruned_mirror(torch.from_numpy(xyz), s, torch.from_numpy(start), slices)
    np.testing.assert_array_equal(got.picks.numpy(), _jax_picks(xyz, s, start))
    assert got.moved == 0
    assert 0 < got.skipped < got.possible


@pytest.mark.parametrize("kind", ["grid", "dup", "lambert"])
def test_pruned_mirror_partitioned_matches_jax(rng, kind, monkeypatch):
    """The partitioned path (N=2048, parts=2, S=1024) with the mirror as the
    per-row selection, against JAX's partitioned FPS."""
    xyz = _cloud(rng, kind, 2, 2048)
    start = np.array([5, 1500], np.int32)
    want = jax_fps(jnp.asarray(xyz), 1024, start_idx=jnp.asarray(start), use_pallas=False,
                   parts=2)
    moved = []

    def pruned(x, s, st_):
        got = ck.fps_pruned_mirror(x, s, st_)
        moved.append(got.moved)
        return got.picks

    monkeypatch.setattr(ck, "fps", pruned)
    got = farthest_point_sampling(torch.from_numpy(xyz), 1024, start_idx=torch.from_numpy(start),
                                  parts=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert moved == [0]


def test_pruned_mirror_skips_most_warp_updates(rng):
    """On a uniform DEV plot (2 x 4,096 points, 1,024 picks: 4 points a
    thread, 128 a warp) the mirror skips at least 80% of the warp updates
    (0.90 as measured: a pick late in FPS reaches the one or two warps
    around it)."""
    xyz = _cloud(rng, "uniform", 2, 4096)
    start = np.array([0, 17], np.int32)
    got = ck.fps_pruned_mirror(torch.from_numpy(xyz), 1024, torch.from_numpy(start))
    assert got.possible == 2 * 32 * 1023
    assert got.skipped / got.possible >= 0.8
    np.testing.assert_array_equal(got.picks.numpy(), _jax_picks(xyz, 1024, start))


SCALES = [1.0, 20.0, 1e3, 6.86e6]


@settings(max_examples=200, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), scale=st.sampled_from(SCALES),
       spread=st.sampled_from([1e-6, 1e-3, 1.0, 30.0]), inside=st.booleans())
def test_skip_bound_below_every_member(seed, scale, spread, inside):
    """D (`fps_skip_bound`) is at most every member's rounded d2
    (`sq_norm3` of the float32 differences, as the kernel rounds it) for
    random boxes, at coordinates from 1 m to Lambert-93's 6.86e6 m, with
    the winner inside or outside the box."""
    r = np.random.default_rng(seed)
    centre = r.uniform(-1, 1, 3) * scale
    pts = (centre + r.uniform(-1, 1, (64, 3)) * spread).astype(np.float32)
    if inside:
        win = pts[r.integers(0, 64)]
    else:
        far = r.choice([1.0, 3.0, 1e3])
        win = (centre + r.uniform(-1, 1, 3) * spread * far).astype(np.float32)
    p, l = torch.from_numpy(pts), torch.from_numpy(np.asarray(win, np.float32))
    d_box = ck.fps_skip_bound(p.amin(0), p.amax(0), l)
    d2 = sq_norm3(p - l)
    assert bool((d_box <= d2).all())
    if inside:
        assert float(d_box) == 0.0


def test_hilbert_cells_are_a_curve():
    """`_hilbert_cell` (csrc/fps.cu's `hilbert_cell`) numbers the 64 x 64
    cells 0 .. 4095, and consecutive numbers are neighbouring cells."""
    side = ck.FPS_SORT_SIDE
    y, x = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    d = ck._hilbert_cell(x.reshape(-1), y.reshape(-1))
    assert sorted(d.tolist()) == list(range(side * side))
    order = torch.argsort(d)
    step = (x.reshape(-1)[order].diff().abs() + y.reshape(-1)[order].diff().abs())
    assert bool((step == 1).all())


def test_constants_match_the_kernel_source():
    """The mirror's grid and the wrapper's thread count are csrc/fps.cu's."""
    src = (_build.CSRC / "fps.cu").read_text()
    assert int(re.search(r"constexpr int kSortSide = (\d+);", src)[1]) == ck.FPS_SORT_SIDE
    assert int(re.search(r"constexpr int kThreads = (\d+);", src)[1]) == ck.FPS_THREADS


def test_fps_skips_on_the_cpu(rng):
    """`fps_skips` on CPU tensors: the plain picks and the mirror's counts at
    the card's slices (`fps_path`), no launch counted; the C entries take
    the counter before the ints."""
    xyz = torch.from_numpy(_cloud(rng, "uniform", 2, 1500))
    start = torch.tensor([3, 9], dtype=torch.int32)
    ck.reset_launches()
    picks, skipped, possible = ck.fps_skips(xyz, 300, start)
    assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)
    assert torch.equal(picks, ck.fps_plain(xyz, 300, start))
    mirror = ck.fps_pruned_mirror(xyz, 300, start)
    assert (skipped, possible) == (mirror.skipped, mirror.possible)
    assert ck.fps_path(40000, 40) == ("cluster", 5)
    src = (_build.CSRC / "fps.cu").read_text()
    for entry, n_ptrs in (("fps_launch", 4), ("fps_cluster_launch", 5)):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)[1]
        assert sig.count("*") == n_ptrs + 1 and "unsigned long long* stats" in sig  # + stream
        assert ck._ENTRIES[entry.removesuffix("_launch")][2].count(ck._VP) == n_ptrs + 1
