"""FPS's exact bucket pruning (csrc/fps.cu) against the JAX package on the
CPU, through its plain PyTorch mirror `cuda_kernels.fps_pruned_mirror`: the
slice sorted by the Hilbert index of its xy cells, the block's warps (32
or, in the cluster's 512-thread blocks, 16 a slice) with their boxes and
cached records, and a pick's skip test D >= M in the
kernel's fma order. The mirror's picks are held index for index to
`jax.vmap(_fps_lax)` (or to JAX's partitioned FPS), and the mirror also
counts, at every pick, the running minima that a skipped warp would have
lowered: 0 when the skip test is exact. The kernel itself is held to
`fps_plain` on the card by chip_smoke.py (FPS_REFERENCE, 0 differing
picks)."""

import re
from typing import NamedTuple

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
SUB_PTS = 4  # points a lane of a sub-box (scripts/variants/fps_sub_boxes.cu's kSubPts)


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
    """The mirror's grid and block sizes, and the wrapper's thread counts
    and points a thread, are csrc/fps.cu's; the sub-box size these tests
    take is scripts/variants/fps_sub_boxes.cu's (the package keeps one box
    a warp)."""
    src = (_build.CSRC / "fps.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kSortSide") == ck.FPS_SORT_SIDE
    assert const("kThreads") == ck.FPS_THREADS
    assert const("kPairThreads") == ck.FPS_PAIR_THREADS
    assert const("kMaxPts") == ck.FPS_MAX_PTS and ck.FPS_MAX_N == ck.FPS_MAX_PTS * ck.FPS_THREADS
    assert "kSubPts" not in src
    variant = (_build.CSRC.parents[2] / "scripts" / "variants" / "fps_sub_boxes.cu").read_text()
    assert int(re.search(r"constexpr int kSubPts = (\d+);", variant)[1]) == SUB_PTS
    assert const("kClusterMax") == ck.FPS_CLUSTER_MAX
    # the 512-thread instances the library holds: every slice of a row past
    # FPS_MAX_N points in at most FPS_CLUSTER_MAX blocks
    pair = {int(m) for m in re.findall(r"FPS_CLUSTER_CASE\((\w+), kPairThreads\)", src)
            if m.isdigit()} | ({ck.FPS_MAX_PTS} if "FPS_CLUSTER_CASE(kMaxPts, kPairThreads)" in src
                               else set())
    least = -(-(-(-(ck.FPS_MAX_N + 1) // ck.FPS_CLUSTER_MAX)) // ck.FPS_PAIR_THREADS)
    assert pair == set(range(least, ck.FPS_MAX_PTS + 1))


def test_fps_skips_on_the_cpu(rng):
    """`fps_pruning` on CPU tensors: the plain picks and the mirror's counts
    at the card's slices and blocks (`fps_path`: fps_kernel at 1,500 points,
    a cluster of 512-thread blocks at 16,385), no launch counted; the C
    entries take the counter before the ints."""
    start = torch.tensor([3, 9], dtype=torch.int32)
    for n, s in ((1500, 300), (16385, 64)):
        xyz = torch.from_numpy(_cloud(rng, "uniform", 2, n))
        ck.reset_launches()
        picks, skipped, possible = ck.fps_pruning(xyz, s, start)
        assert ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0)
        assert torch.equal(picks, ck.fps_plain(xyz, s, start))
        path, cs, threads = ck.fps_path(n, 2)
        mirror = ck.fps_pruned_mirror(xyz, s, start, cs, threads)
        assert (skipped, possible) == (mirror.skipped, mirror.possible) and mirror.moved == 0
        assert (path, threads) == (("block", ck.FPS_THREADS) if n == 1500
                                   else ("cluster", ck.FPS_PAIR_THREADS))
    assert ck.fps_path(40000, 40) == ("cluster", 5, ck.FPS_PAIR_THREADS)
    src = (_build.CSRC / "fps.cu").read_text()
    for entry, n_ptrs in (("fps_launch", 4), ("fps_cluster_launch", 5)):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)[1]
        assert sig.count("*") == n_ptrs + 1 and "unsigned long long* stats" in sig  # + stream
        assert ck._ENTRIES[entry.removesuffix("_launch")][2].count(ck._VP) == n_ptrs + 1


# ---------------------------------------------------------------------------
# the cluster's slices and its 512-thread blocks; sub-boxes (a variant)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,s,parts", [
    ("grid", 16385, 1024, 1),       # the cluster's first row: 5 blocks of 512, 7 points a thread
    ("dup", 32768, 512, 1),         # dense SA1's rows: 13 points a thread
    ("lambert", 40001, 384, 1),     # 16 points a thread
    ("clustered", 40000, 384, 1),   # the 80,000-point step's rows: as 40,001
    ("grid", 32770, 1024, 2),       # partitioned: two parts of 16,385 points
])
def test_long_row_mirror_matches_fps_lax(rng, kind, n, s, parts):
    """The mirror at the card's slices and blocks of 40 rows (the dense
    steps' count) past fps_kernel's 16,384 points (`fps_path`: clusters of
    5 blocks of 512 threads, one box a warp) picks index for index as
    `_fps_lax` (partitioned: as JAX's partitioned FPS, each part's rows of
    16,385 on the cluster), and no skipped warp would have lowered a
    running minimum."""
    xyz = _cloud(rng, kind, 2, n)
    start = np.array([0, n // parts - 1], np.int32)
    path, cs, threads = ck.fps_path(n // parts, 40)
    assert (path, cs, threads) == ("cluster", 5, ck.FPS_PAIR_THREADS)
    counts = []

    def pruned(x, s_, st_):
        got = ck.fps_pruned_mirror(x, s_, st_, cs, threads)
        counts.append(got)
        return got.picks

    if parts == 1:
        np.testing.assert_array_equal(pruned(torch.from_numpy(xyz), s, torch.from_numpy(start)),
                                      _jax_picks(xyz, s, start))
    else:
        want = jax_fps(jnp.asarray(xyz), s, start_idx=jnp.asarray(start), use_pallas=False,
                       parts=parts)
        monkey = pytest.MonkeyPatch()
        monkey.setattr(ck, "fps", pruned)
        try:
            got = farthest_point_sampling(torch.from_numpy(xyz), s,
                                          start_idx=torch.from_numpy(start), parts=parts)
        finally:
            monkey.undo()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (got,) = counts
    assert got.moved == 0 and 0 < got.skipped < got.possible
    # at most threads / 32 warps a slice hold points
    picks = got.picks.shape[1] - 1
    assert got.possible % picks == 0
    assert got.possible // picks <= len(got.picks) * cs * threads // 32


class SubBoxPicks(NamedTuple):
    """`_sub_box_mirror`'s result: `cuda_kernels.PrunedPicks`' fields, then
    the sub-box updates skipped and possible (over the sub-boxes that hold
    points)."""
    picks: torch.Tensor
    skipped: int
    possible: int
    moved: int
    sub_skipped: int
    sub_possible: int


def _sub_box_mirror(xyz, n_samples, start, sub):
    """scripts/variants/fps_sub_boxes.cu's pruned FPS (fps_kernel's rows) in
    plain PyTorch: the warps of `cuda_kernels.fps_warp_points`, each cut
    into sub-boxes of 32 `sub` consecutive sorted points (`sub` >= PTS: one
    box a warp, the package's), each sub-box's box and max running minimum,
    and a pick's skip test D >= M a sub-box; a warp's record is the max over
    its sub-boxes and the least index holding it. `moved` counts the minima
    that a skipped sub-box would have lowered."""
    r = xyz.shape[0]
    idx = ck.fps_warp_points(xyz)  # (R, warps, 32 PTS)
    sub = min(sub, idx.shape[2] // 32)
    nsub = -(-idx.shape[2] // (32 * sub))  # sub-boxes a warp (the last may be shorter)
    idx = torch.nn.functional.pad(idx, (0, nsub * 32 * sub - idx.shape[2]), value=-1)
    idx = idx.view(r, idx.shape[1], nsub, 32 * sub)
    have = idx >= 0
    rows = torch.arange(r)
    inf = torch.tensor(float("inf"))
    big = torch.iinfo(torch.int64).max
    p = torch.where(have[..., None], xyz[rows[:, None, None, None], idx.clamp(min=0)], 0.0)
    box_lo = torch.where(have[..., None], p, inf).amin(3)  # (R, warps, sub-boxes, 3)
    box_hi = torch.where(have[..., None], p, -inf).amax(3)
    sreal = have.any(3)
    wreal = sreal.any(2)
    mind = torch.where(have, inf, 0.0)
    smax = torch.where(sreal, inf, 0.0)
    out = torch.zeros((r, n_samples), dtype=torch.int32)
    out[:, 0] = start
    last = start.long()
    skipped = sub_skipped = moved = 0
    for i in range(1, n_samples):
        lp = xyz[rows, last]
        upd = ck.fps_skip_bound(box_lo, box_hi, lp[:, None, None]) < smax  # (R, warps, sub-boxes)
        full = torch.minimum(mind, sq_norm3(p - lp[:, None, None, None]))
        moved += int(((full != mind) & have & ~upd[..., None]).sum())
        skipped += int((~upd.any(2) & wreal).sum())
        sub_skipped += int((~upd & sreal).sum())
        mind = torch.where(upd[..., None], full, mind)
        smax = torch.where(upd, mind.amax(3), smax)
        best = smax.amax((1, 2))
        last = torch.where((mind == best[:, None, None, None]) & have, idx, big).amin((1, 2, 3))
        out[:, i] = last.int()
    return SubBoxPicks(out, skipped, int(wreal.sum()) * (n_samples - 1), moved, sub_skipped,
                       int(sreal.sum()) * (n_samples - 1))


@pytest.mark.parametrize("sub", [1, 2, 4, 8, 9])
def test_sub_box_size_keeps_the_picks(rng, sub):
    """scripts/variants/fps_sub_boxes.cu's sub-boxes, at any size (1 point
    a lane to one box a warp, 9 points a thread), give `_fps_lax`'s picks
    with no minimum a skipped sub-box would have lowered. A sub-box lies in
    its warp's box, so it skips whenever the warp's one box would: the
    shares skipped are at least the package's (`fps_pruned_mirror`), which
    one box a warp equals."""
    xyz = _cloud(rng, "clustered", 2, 9 * ck.FPS_THREADS)  # every sub-box full
    start = np.array([4, 8000], np.int32)
    x, st_ = torch.from_numpy(xyz), torch.from_numpy(start)
    got = _sub_box_mirror(x, 600, st_, sub)
    np.testing.assert_array_equal(got.picks.numpy(), _jax_picks(xyz, 600, start))
    assert got.moved == 0
    subs = -(-9 // min(sub, 9))
    assert got.sub_possible == subs * got.possible  # every sub-box of this row holds points
    one = ck.fps_pruned_mirror(x, 600, st_)
    assert got.skipped >= one.skipped
    assert got.sub_skipped / got.sub_possible >= one.skipped / one.possible
    if sub == 9:
        assert torch.equal(got.picks, one.picks) and got[1:4] == one[1:]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scale", SCALES)
def test_sub_box_bound_below_every_member(seed, scale):
    """A warp of 32 x 12 points cut as the variant cuts it (lane-major:
    point k of lane l at sorted position 32 k + l, sub-box g the points k in
    [4 g, 4 g + 4) of every lane): each sub-box's D (`fps_skip_bound`) is at
    most every member's rounded d2, and no smaller than the warp box's D, at
    coordinates from 1 m to Lambert-93's 6.86e6 m and winners inside and
    outside the warp's box."""
    r = np.random.default_rng(seed)
    pts_a_thread, sub = 12, SUB_PTS
    centre = r.uniform(-1, 1, 3) * scale
    spread = r.choice([1e-3, 1.0, 30.0])
    pts = (centre + r.uniform(-1, 1, (pts_a_thread, 32, 3)) * spread).astype(np.float32)
    p = torch.from_numpy(pts)  # (k, lane, 3)
    boxes = p.view(pts_a_thread // sub, sub * 32, 3)
    for win in (pts[r.integers(0, pts_a_thread), r.integers(0, 32)],
                (centre + r.uniform(-3, 3, 3) * spread).astype(np.float32)):
        l = torch.from_numpy(np.asarray(win, np.float32))
        d_sub = ck.fps_skip_bound(boxes.amin(1), boxes.amax(1), l)  # (sub-boxes,)
        d2 = sq_norm3(boxes - l)  # (sub-boxes, members)
        assert bool((d_sub[:, None] <= d2).all())
        d_warp = ck.fps_skip_bound(p.reshape(-1, 3).amin(0), p.reshape(-1, 3).amax(0), l)
        assert bool((d_warp <= d_sub).all())


@pytest.mark.parametrize("n,rows,want", [
    (40000, 40, ("cluster", 5, 512)),  # the 80,000-point step's SA1 parts: one wave of 512s
    (5000, 40, ("block", 1, 1024)),    # PROD SA1's parts
    (2500, 20, ("block", 1, 1024)),    # PROD SA2
    (32768, 40, ("cluster", 5, 512)),  # dense SA1's parts: one wave either way, 512s faster
    (8192, 40, ("block", 1, 1024)),    # dense SA2's parts
])
def test_fps_path_weighs_the_512_thread_instance(n, rows, want):
    """`fps_path` from a residency table that holds both block sizes: one
    wave for 40 rows of 40,000 points (5 blocks of 512 threads a row;
    every 1024-thread cluster size takes two), the 512-thread clusters at
    dense SA1 too (both sizes take one wave there, and 5 blocks of 512
    measured faster a pick than 2 of 1024), and PROD's and dense SA2's rows
    on fps_kernel as before. Without the 512-thread entries the rule takes
    two waves of 5 blocks of 1024 at 40,000 points, 2 blocks at 32,768."""
    table = ck.FPS_RESIDENT
    assert ck.fps_path(n, rows, table) == want
    only_1024 = {ck.FPS_THREADS: table[ck.FPS_THREADS]}
    if n == 40000:
        assert all(table[ck.FPS_THREADS][cs] < rows for cs in range(3, ck.FPS_CLUSTER_MAX + 1))
        assert table[ck.FPS_PAIR_THREADS][5] >= rows
        assert ck.fps_path(n, rows, only_1024) == ("cluster", 5, ck.FPS_THREADS)
    if n == 32768:
        assert ck.fps_path(n, rows, only_1024) == ("cluster", 2, ck.FPS_THREADS)
