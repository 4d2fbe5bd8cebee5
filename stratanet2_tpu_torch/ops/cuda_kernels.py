"""The CUDA kernels of the serve and train paths, each beside its plain
PyTorch version (counterpart of `stratanet2_tpu/ops/pallas_kernels.py`).

| wrapper          | CUDA source             | replaces (pallas_kernels.py)         |
|------------------|-------------------------|--------------------------------------|
| `fps`            | csrc/fps.cu             | `_fps_kernel` / `fps_pallas_batched` |
| `sa_fused_eval`  | csrc/sa_fused_eval.cu (+ grouped_cull.cuh past PROD's groups) | `_sa_kernel` / `sa_fused_eval` |
| `knn_interpolate`| csrc/knn_interpolate.cu (+ cell_grid.cuh on dense plots) | `_knn_kernel` / `_knn_pallas_raw` |
| `pixel_max`      | csrc/pixel_max.cu       | `_pixel_max_kernel` / `pixel_max_pallas` (forward) |
| `ball_query`     | csrc/ball_query.cu (+ grouped_cull.cuh past PROD's groups) | `_bq_kernel` / `ball_query_grouped_pallas` |
| `knn_scatter`    | csrc/knn_scatter.cu     | `_knn_scatter_kernel` / `_knn_scatter_pallas`, `scatter_add_pallas` |
| `pixel_max_bwd`  | csrc/pixel_max.cu       | `_pixel_max_bwd_kernel` / `_pixel_max_bwd` |
| `sa_train_stats` | csrc/sa_train.cu        | `_sa_stats1_kernel` / `_sa_train_stats` |
| `sa_train_main`  | csrc/sa_train.cu        | `_sa_train_main_kernel` / `_sa_train_main` |
| `sa_train_bwd1`  | csrc/sa_train.cu        | `_sa_train_bwd1_kernel` / `_sa_train_bwd1` |
| `sa_train_bwd2`  | csrc/sa_train.cu        | `_sa_train_bwd2_kernel` / `_sa_train_bwd2` |
| `ball_query_nearest` | csrc/ball_query_nearest.cu (grid pass + query, one count) | no Pallas kernel: the XLA `approx_min_k` of `ballquery.py::_ball_query_single` |

Dispatch: a wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it runs the plain version. There is no fallback between the two
and no switch. `LAUNCHES[name]` counts each wrapper's kernel launches; a
step replayed as a CUDA graph adds the launches its capture recorded at
each replay (`captured_launches`, `replayed`), so the counts are the
kernels the card ran.

Six wrappers take another path for shapes past their PROD kernels' reach
(the dense plots), chosen by shape (`fps_path`, `sel_path`, `knn_path`,
`pixel_max_range`, `sa_train_dq_plan`), and count it in `PATH_LAUNCHES` too:
FPS rows over 16,384 points run a block cluster a row (`fps_cluster`, its
size and its blocks' threads, 1024 or 512, from the rows and the clusters
the card holds at once, and past 131,072 points `fps_global`, its running
minima in device memory); a
selection group longer than a warp's staging slice takes the cell grid of
csrc/cell_grid.cuh, each centroid scoring only its 3 x 3 cells, with the
same picks (`ball_query_grid`, `sa_fused_eval_grid`); kNN with many
sources takes the same grid, each warp of targets scanning rings of cells
until a proven bound stops it, with the same picks
(`knn_interpolate_grid`); a pixel table past a block's shared memory is
cut into pixel ranges, a cluster each, sized for two blocks an SM
(`pixel_max_ranges`); sa_train_bwd2's dq pass splits a group whose
lists outgrow shared memory into windows of points, a block each
(`sa_train_dq_chunked`). Every PROD shape keeps its kernels. The cell
grid's pass (also the nearest selection's) runs a cluster of
`cell_grid_cluster(B, entries a cloud, SMs)` blocks a cloud.

Every selection distance is rounded as the JAX CPU path rounds it (see
`distance.py`): the plain versions and the kernels agree with it, and with
each other, on every distance and so on every selected index. The SA train
passes likewise compute every per-edge value in the same rounding as their
kernels (`sa_train_edges`), so winner slots agree exactly.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from stratanet2_tpu_torch.ops import _build
from stratanet2_tpu_torch.ops import ballquery
from stratanet2_tpu_torch.ops.ballquery import ball_query_grouped, radius_sq
from stratanet2_tpu_torch.ops.distance import expanded_d2, fma_f32, sq_norm3, tile_rows

NEG = -3.4e38  # the empty-pixel / masked-edge value of the Pallas kernels
_KNN_EPS = 1e-16
_KNN_CHUNK = 512  # targets per (B, chunk, S) distance tile of the plain kNN on the card
# csrc/knn_interpolate.cu: 8 warps a block, one target a lane; knn_slices
# wants enough warps to fill the 64 warp slots of each of 132 SMs once
KNN_WARPS, KNN_MIN_WARPS = 8, 64 * 132
# knn_path: clouds of at least KNN_GRID_MIN_S sources take the cell grid
KNN_GRID_MIN_S = 4096
_SMEM_MAX = 227 * 1024  # opt-in dynamic shared memory of one H100 block
# csrc/knn_scatter.cu: pairs a round and contributions a chunk (kW, kL: they
# set the order of its sums), and the widest F whose accumulators fit in
# shared memory
KNN_SCATTER_PAIRS, KNN_SCATTER_CHUNK = 8192, 64
KNN_SCATTER_MAX_F = 128
PIXEL_MAX_CLUSTER = 8  # csrc/pixel_max.cu: blocks of a cloud's cluster (kCS)
PIXEL_MAX_TABLE = _SMEM_MAX // 8  # 64-bit keys (pixel x channel slots) a block's table holds
# ... and a range's table past one block: two blocks of pixel_max_kernel on
# each SM (228 KB of shared memory an SM, 1 KB of it reserved a block)
PIXEL_MAX_PAIR_TABLE = (228 * 1024 // 2 - 1024) // 8
FPS_THREADS = 1024  # csrc/fps.cu: threads a block (kThreads)
FPS_PAIR_THREADS = 512  # ... of the cluster's blocks of two an SM (kPairThreads)
FPS_MAX_PTS = 16  # points a thread at most (kMaxPts)
FPS_MAX_N = FPS_MAX_PTS * FPS_THREADS  # fps_kernel: at most 16 points for each of its threads
FPS_CLUSTER_MAX = 8  # fps_cluster_kernel: blocks a row at most (the portable cluster size)
FPS_SORT_SIDE = 64  # csrc/fps.cu: the side of the xy grid that orders a slice (kSortSide)
# {threads: {cs: clusters}}: clusters of cs blocks of fps_cluster_kernel
# (1024 threads, one block an SM, cs = 2 .. 8; 512, two an SM, cs = 3 .. 8,
# the sizes whose slices rows past 16,384 points fill) that an NVIDIA H100
# 80GB HBM3 holds at once: cudaOccupancyMaxActiveClusters on the card
# (chip_smoke.py's dense phase prints the card's own, which the wrapper
# takes: `fps_cluster_resident`)
FPS_RESIDENT = {FPS_THREADS: {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15},
                FPS_PAIR_THREADS: {3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}}
# csrc/common.cuh's grouped selection: 8 warps a block each stage up to one
# group of g points as float4, for a tile of 64 centroids
SEL_WARPS, SEL_TILE = 8, 64
BQ_MAX_G = _SMEM_MAX // (16 * SEL_WARPS)  # ball_query: the longest group staged whole
# csrc/grouped_cull.cuh: the centroids a warp of the cell-grid query scores
# each loaded point for (kCullCents), and the groups a centroid's slot
# table holds (kCullSlots); past them the query takes windows of groups
CULL_CENTS, CULL_SLOTS = 2, 1792
SA_DQ_INTS = _SMEM_MAX // 4  # csrc/sa_train.cu's dq pass: int32 lists and counts a block holds
# its windowed instance: one wave of two blocks on each of 132 SMs, two
# blocks' shared memory within an SM's 228 KB (1 KB of it reserved a block,
# 16 ints for the block's static shared memory)
SA_DQ_WAVE = 2 * 132
SA_DQ_PAIR_INTS = (228 * 1024 // 2 - 1024) // 4 - 16
NEAREST_MAX_K = 128  # csrc/ball_query_nearest.cu: the longest sorted list a warp keeps (kNearMaxK)
# csrc/cell_grid.cuh's grid pass: a cluster of at most CELL_GRID_CLUSTER_MAX
# blocks a cloud (kGridClusterMax, the portable cluster size), on a card of
# CARD_SMS SMs by default (an H100's; the wrappers ask the card)
CELL_GRID_CLUSTER_MAX = 8
CARD_SMS = 132
# cell_grid_cluster: the fewest entries (points and centroids) a block of
# the grid pass takes, the share of the SMs its clusters fill, and the
# blocks a cloud it keeps however many clouds share the card
GRID_ENTRIES_A_BLOCK = 1000
GRID_SM_SHARE = (2, 3)
GRID_CLUSTER_FLOOR = 4

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {  # entry: (library = csrc/<library>.cu, C entry point, its arguments)
    "fps": ("fps", "fps_launch", [_VP] * 4 + [_I] * 3 + [_VP]),
    "sa_fused_eval": (
        "sa_fused_eval", "sa_fused_eval_launch", [_VP] * 6 + [_I] * 8 + [_F, _VP],
    ),
    "knn_interpolate": (
        "knn_interpolate", "knn_interpolate_launch",
        [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    ),
    "pixel_max": ("pixel_max", "pixel_max_launch", [_VP] * 4 + [_I] * 5 + [_VP]),
    "ball_query": ("ball_query", "ball_query_launch", [_VP] * 4 + [_I] * 5 + [_F, _VP]),
    "knn_scatter": (
        "knn_scatter", "knn_scatter_launch", [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP]
    ),
    "pixel_max_bwd": (
        "pixel_max", "pixel_max_bwd_launch", [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP]
    ),
    "sa_train_stats": (
        "sa_train", "sa_train_stats_launch", [_VP] * 6 + [_I] * 6 + [_VP]
    ),
    "sa_train_main": (
        "sa_train", "sa_train_main_launch", [_VP] * 11 + [_I] * 7 + [_VP]
    ),
    "sa_train_bwd1": (
        "sa_train", "sa_train_bwd1_launch", [_VP] * 9 + [_I] * 6 + [_VP]
    ),
    "sa_train_bwd2": (
        "sa_train", "sa_train_bwd2_launch", [_VP] * 13 + [_I] * 9 + [_VP]
    ),
    "ball_query_nearest": (
        "ball_query_nearest", "ball_query_nearest_launch", [_VP] * 5 + [_I] * 5 + [_F, _I, _VP]
    ),
    # the long-shape paths' own entry points (see the module's docstring)
    "sa_fused_eval_grid": (
        "sa_fused_eval", "sa_fused_eval_grid_launch", [_VP] * 8 + [_I] * 8 + [_F, _I, _VP]
    ),
    "ball_query_grid": (
        "ball_query", "ball_query_grid_launch", [_VP] * 5 + [_I] * 5 + [_F, _I, _VP]
    ),
    "knn_interpolate_grid": (
        "knn_interpolate", "knn_interpolate_grid_launch", [_VP] * 8 + [_I] * 6 + [_VP]
    ),
    "fps_cluster": ("fps", "fps_cluster_launch", [_VP] * 5 + [_I] * 5 + [_VP]),
    "fps_resident": ("fps", "fps_cluster_resident", [_I] * 4),  # no launch: a query
}
WRAPPERS = ("fps", "sa_fused_eval", "knn_interpolate", "pixel_max", "ball_query", "knn_scatter",
            "pixel_max_bwd", "sa_train_stats", "sa_train_main", "sa_train_bwd1", "sa_train_bwd2",
            "ball_query_nearest")
PATHS = ("fps_cluster", "fps_global", "ball_query_grid", "sa_fused_eval_grid",
         "knn_interpolate_grid", "pixel_max_ranges", "sa_train_dq_chunked")
_fns: Dict[str, ctypes._CFuncPtr] = {}
# kernel launches per wrapper, and per long-shape path, counted where the
# launch succeeds; a launch recorded into a CUDA graph is counted at each
# replay instead (`captured_launches`, `replayed`)
LAUNCHES: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)
PATH_LAUNCHES: Dict[str, int] = dict.fromkeys(PATHS, 0)
# graphs captured and replayed by the step programs (learning/programs.py)
GRAPH_COUNTS: Dict[str, int] = {"captures": 0, "replays": 0}


def _bind(entry: str) -> ctypes._CFuncPtr:
    """C entry point `entry`, its library built and loaded at first use."""
    library, symbol, argtypes = _ENTRIES[entry]
    lib = _build.load(library)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _fns[entry] = fn
    return fn


def _launch(name: str, device: torch.device, *args, entry: Optional[str] = None,
            path: Optional[str] = None) -> None:
    """Call wrapper `name`'s C entry point (or `entry`) on `device`'s
    current stream, counting the launch for `name` and for `path`.
    Tensors pass as their data pointers; the entry returns
    cudaGetLastError() after its launches, and a non-zero code raises.
    The stream comes from PyTorch's raw getter (what Triton's launcher
    calls) and the device is switched only when `device` is not current:
    the host cost of a launch is most of a short kernel's time."""
    entry = entry or name
    fn = _fns.get(entry)
    if fn is None:
        fn = _bind(entry)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]  # None: NULL
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*cargs, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*cargs, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        msg = _build.load(_ENTRIES[entry][0]).error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
    LAUNCHES[name] += 1
    if path is not None:
        PATH_LAUNCHES[path] += 1


def _on_card(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors (all contiguous, one device), False for CPU
    tensors; raises on anything else. None entries (absent optional
    inputs) are skipped."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on several devices ({dev}, {t.device})")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return True


def _expect(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def reset_launches() -> None:
    for counts in (LAUNCHES, PATH_LAUNCHES, GRAPH_COUNTS):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def path_launch_counts() -> Dict[str, int]:
    return dict(PATH_LAUNCHES)


def graph_counts() -> Dict[str, int]:
    return dict(GRAPH_COUNTS)


def launch_snapshot() -> Tuple[Dict[str, int], Dict[str, int]]:
    """The launch counts now, for `captured_launches`."""
    return dict(LAUNCHES), dict(PATH_LAUNCHES)


def captured_launches(before: Tuple[Dict[str, int], Dict[str, int]]):
    """The launches counted since `before` (a `launch_snapshot()` taken
    just before a CUDA graph's capture), taken back out of the counts, since
    a capture records kernels and runs none; counts the capture. Returns
    them, by wrapper and by path, for `replayed`."""
    held = tuple({name: counts[name] - was[name] for name in counts if counts[name] != was[name]}
                 for counts, was in zip((LAUNCHES, PATH_LAUNCHES), before))
    LAUNCHES.update(before[0])
    PATH_LAUNCHES.update(before[1])
    GRAPH_COUNTS["captures"] += 1
    return held


def replayed(held) -> None:
    """Count a replay of a graph that holds the launches `held`
    (`captured_launches`): the card ran each of them once more."""
    for counts, launched in zip((LAUNCHES, PATH_LAUNCHES), held):
        for name, n in launched.items():
            counts[name] += n
    GRAPH_COUNTS["replays"] += 1


# ---------------------------------------------------------------------------
# farthest point sampling
# ---------------------------------------------------------------------------


def fps_plain(xyz: torch.Tensor, n_samples: int, start: torch.Tensor) -> torch.Tensor:
    """Mirror of `_fps_lax` (stratanet2_tpu/ops/fps.py:107-131) over rows:
    S-1 sequential picks of the argmax (first maximum) of the running
    min squared distance |p - p_last|^2 (rounded as `distance.sq_norm3`)."""
    r, n, _ = xyz.shape
    rows = torch.arange(r, device=xyz.device)
    out = torch.zeros((r, n_samples), dtype=torch.int32, device=xyz.device)
    out[:, 0] = start
    last = start.long()
    min_d2 = torch.full((r, n), float("inf"), device=xyz.device)
    for i in range(1, n_samples):
        d2 = sq_norm3(xyz - xyz[rows, last][:, None, :])
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=1)
        out[:, i] = last.int()
    return out


class FpsPath(NamedTuple):
    """`fps_path`'s choice for rows of n points: csrc/fps.cu's path, blocks
    a row and threads a block."""
    path: str
    cs: int
    threads: int = FPS_THREADS


def fps_path(n: int, rows: int, resident: Optional[Dict[int, Dict[int, int]]] = None) -> FpsPath:
    """csrc/fps.cu's path for `rows` rows of n points: ("block", 1), fps_kernel,
    up to FPS_MAX_N points; ("cluster", cs, threads), a cluster of cs blocks
    of FPS_THREADS (one an SM) or FPS_PAIR_THREADS (two an SM) a row, each
    block's slice of ceil(n / cs) points in shared memory (at most
    FPS_MAX_PTS a thread), up to FPS_CLUSTER_MAX x FPS_MAX_N points; past
    that ("global", FPS_CLUSTER_MAX), the slices read from device memory
    and the running minima in a device-memory scratch. `resident`
    ({threads: {cs: clusters of cs blocks the card holds at once}};
    FPS_RESIDENT, an H100's, by default) sets the instance: the fewest
    waves of clusters (ceil(rows / resident)), then the 512-thread blocks
    (faster a pick at every long-row site measured, two slices' picks side
    by side on an SM: PERF.md), then the fewest points a thread, then the
    fewest blocks."""
    if n <= FPS_MAX_N:
        return FpsPath("block", 1)
    if n > FPS_CLUSTER_MAX * FPS_MAX_N:
        return FpsPath("global", FPS_CLUSTER_MAX)
    resident = FPS_RESIDENT if resident is None else resident

    def cost(option):
        threads, cs = option
        return (-(-rows // max(resident[threads][cs], 1)), threads != FPS_PAIR_THREADS,
                _slice_pts(n, cs, threads), cs)

    threads, cs = min(((t, cs) for t in resident for cs in _fps_sizes(n, t)), key=cost)
    return FpsPath("cluster", cs, threads)


def _fps_sizes(n: int, threads: int):
    """The cluster sizes whose slices of n points fit blocks of `threads`
    (FPS_MAX_N points a block of FPS_THREADS)."""
    return range(max(2, -(-n * FPS_THREADS // (FPS_MAX_N * threads))), FPS_CLUSTER_MAX + 1)


def _slice_pts(n: int, cs: int, threads: int = FPS_THREADS) -> int:
    """Points a thread of fps_cluster_kernel's slices of ceil(n / cs) points."""
    return -(-(-(-n // cs)) // threads)


_fps_resident: Dict[tuple, int] = {}


def fps_cluster_resident(n: int, device: torch.device) -> Dict[int, Dict[int, int]]:
    """{threads: {cs: clusters of cs blocks of the instance that rows of n
    points take that `device` holds at once}}, for each block size and each
    cs up to FPS_CLUSTER_MAX whose slices of ceil(n / cs) points fit in
    shared memory (past them, the global path's 1024-thread blocks at every
    cs), asked of the card once per instance (cudaOccupancyMaxActiveClusters,
    the library's `fps_cluster_resident`)."""
    fn = _fns.get("fps_resident") or _bind("fps_resident")
    glob = int(n > FPS_CLUSTER_MAX * FPS_MAX_N)
    out: Dict[int, Dict[int, int]] = {}
    for threads in (FPS_THREADS,) if glob else (FPS_THREADS, FPS_PAIR_THREADS):
        sizes = range(2, FPS_CLUSTER_MAX + 1) if glob else _fps_sizes(n, threads)
        for cs in sizes:
            key = (device.index, cs, threads, 0 if glob else _slice_pts(n, cs, threads))
            if key not in _fps_resident:
                with torch.cuda.device(device):
                    got = fn(n, cs, threads, glob)
                if got < 0:
                    msg = _build.load("fps").error_string(-got).decode()
                    raise RuntimeError(
                        f"fps_cluster_resident(n={n}, cs={cs}, threads={threads}): {msg} ({-got})")
                _fps_resident[key] = got
            out.setdefault(threads, {})[cs] = _fps_resident[key]
    return out


def fps(xyz: torch.Tensor, n_samples: int, start: torch.Tensor) -> torch.Tensor:
    """Farthest point sampling per row: (R, N, 3) float32 points, (R,) int32
    start indices -> (R, n_samples) int32 indices, out[:, 0] == start."""
    if not _fps_check(xyz, n_samples, start):
        return fps_plain(xyz, n_samples, start)
    return _fps_launch(xyz, n_samples, start, None)


def fps_pruning(xyz: torch.Tensor, n_samples: int, start: torch.Tensor):
    """`fps`'s picks with its pruning's work: (picks, skipped, possible),
    the warp updates that the launch skipped and the updates its picks
    could have made, over the warps that hold points (csrc/fps.cu's stats;
    0 and 0 on the global path, which does not prune). One counted launch
    on the card; on the CPU the plain picks and `fps_pruned_mirror`'s
    counts at the card's slices and blocks (`fps_path`)."""
    if not _fps_check(xyz, n_samples, start):
        path, cs, threads = fps_path(xyz.shape[1], xyz.shape[0])
        if path == "global":
            return fps_plain(xyz, n_samples, start), 0, 0
        mirror = fps_pruned_mirror(xyz, n_samples, start, cs, threads)
        return fps_plain(xyz, n_samples, start), mirror.skipped, mirror.possible
    stats = torch.zeros(2, dtype=torch.int64, device=xyz.device)
    out = _fps_launch(xyz, n_samples, start, stats)
    skipped, possible = stats.tolist()
    return out, skipped, possible


def _fps_check(xyz: torch.Tensor, n_samples: int, start: torch.Tensor) -> bool:
    """Checks fps's arguments; True for CUDA tensors."""
    name = "fps"
    _expect(xyz.dim() == 3 and xyz.shape[2] == 3, name, "xyz must be (R, N, 3)")
    _expect(xyz.dtype == torch.float32, name, "xyz must be float32")
    _expect(start.shape == (xyz.shape[0],) and start.dtype == torch.int32,
            name, "start must be (R,) int32")
    _expect(1 <= n_samples <= xyz.shape[1], name, "need 1 <= n_samples <= N")
    if not _on_card(name, xyz, start):
        return False
    _expect(xyz.shape[1] < 2 ** 31, name, f"N={xyz.shape[1]}: indices are int32")
    return True


def _fps_launch(xyz, n_samples, start, stats):
    """One counted launch of csrc/fps.cu on the path `fps_path` takes; stats
    None or a (2,) int64 tensor that takes the pruning's counts."""
    name = "fps"
    r, n, _ = xyz.shape
    out = torch.empty((r, n_samples), dtype=torch.int32, device=xyz.device)
    path, cs, threads = fps_path(n, r, None if n <= FPS_MAX_N
                                 else fps_cluster_resident(n, xyz.device))
    if path == "block":
        _launch(name, xyz.device, xyz, start, out, stats, r, n, n_samples)
        return out
    _expect(r * cs < 2 ** 31, name, f"{r} rows of {cs} blocks exceed the grid")
    # the global path's running minima: a device-memory row of N floats a row
    md = torch.empty((r, n), dtype=torch.float32, device=xyz.device) if path == "global" else None
    _launch(name, xyz.device, xyz, start, out, md, stats, r, n, n_samples, cs, threads,
            entry="fps_cluster", path=f"fps_{path}")
    return out


class PrunedPicks(NamedTuple):
    """`fps_pruned_mirror`'s result: the picks (R, S) int32, the warp
    updates skipped and possible (over the warps that hold points), and the
    running minima that a skipped update would have lowered (0 when the
    skip test is exact)."""
    picks: torch.Tensor
    skipped: int
    possible: int
    moved: int


def _hilbert_cell(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """csrc/fps.cu's `hilbert_cell`: the Hilbert index of integer cells (x, y)
    of the FPS_SORT_SIDE^2 grid."""
    d = torch.zeros_like(x)
    s = FPS_SORT_SIDE // 2
    while s > 0:
        rx, ry = (x & s) > 0, (y & s) > 0
        d += s * s * ((3 * rx.long()) ^ ry.long())
        flip = ~ry & rx
        x = torch.where(flip, FPS_SORT_SIDE - 1 - x, x)
        y = torch.where(flip, FPS_SORT_SIDE - 1 - y, y)
        x, y = torch.where(~ry, y, x), torch.where(~ry, x, y)
        s //= 2
    return d


def fps_skip_bound(lo: torch.Tensor, hi: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """csrc/fps.cu's skip test's D for boxes [lo, hi] (..., 3) and winners l
    (..., 3): the per-axis gap g = max(lo - l, l - hi, 0), each difference
    rounded to float32, then sq_norm3(g) in the distance's fma order. No
    point of a box is nearer: D <= its squared distance to l as the
    kernels round it."""
    return sq_norm3(torch.clamp_min(torch.maximum(lo - l, l - hi), 0.0))


def fps_warp_points(xyz: torch.Tensor, slices: int = 1, threads: int = FPS_THREADS):
    """The points of csrc/fps.cu's warps, for rows cut into `slices`
    contiguous slices of ceil(N / slices) points (1: fps_kernel; cs: the
    cluster) and blocks of `threads`: each slice sorted by the Hilbert index
    of FPS_SORT_SIDE^2 xy cells over its own extent (stable here; the
    kernel's order inside a cell follows its atomics), threads / 32 warps a
    slice of 32 PTS consecutive sorted points. (R, slices x threads / 32,
    32 PTS) int64 row indices in sorted order, -1 past a slice's points."""
    r, n, _ = xyz.shape
    dev = xyz.device
    length = -(-n // slices)
    warps = threads // 32
    wpts = 32 * -(-length // threads)  # points a warp
    pos = torch.arange(slices * length, device=dev).view(slices, length)
    real = pos < n
    p = xyz[:, pos.clamp(max=n - 1)]  # (R, slices, length, 3)
    x, y = p[..., 0], p[..., 1]
    inf = torch.tensor(float("inf"), device=dev)
    x0 = torch.where(real, x, inf).amin(-1, keepdim=True)
    x1 = torch.where(real, x, -inf).amax(-1, keepdim=True)
    y0 = torch.where(real, y, inf).amin(-1, keepdim=True)
    y1 = torch.where(real, y, -inf).amax(-1, keepdim=True)
    ext = torch.maximum(x1 - x0, y1 - y0)
    inv = torch.where(ext > 0, FPS_SORT_SIDE / ext, torch.zeros_like(ext))
    cx = ((x - x0) * inv).clamp(0, FPS_SORT_SIDE - 1).long()
    cy = ((y - y0) * inv).clamp(0, FPS_SORT_SIDE - 1).long()
    key = torch.where(real, _hilbert_cell(cx, cy), FPS_SORT_SIDE ** 2)
    order = torch.argsort(key, dim=-1, stable=True)  # (R, slices, length)
    idx = pos.expand_as(order).gather(-1, order)
    idx = F.pad(torch.where(idx < n, idx, -1), (0, warps * wpts - length), value=-1)
    return idx.view(r, slices * warps, wpts)


def fps_pruned_mirror(xyz: torch.Tensor, n_samples: int, start: torch.Tensor,
                      slices: int = 1, threads: int = FPS_THREADS) -> PrunedPicks:
    """csrc/fps.cu's pruned FPS in plain PyTorch, on the warps of
    `fps_warp_points` (`slices` slices a row, blocks of `threads`): each
    warp's box and cached record (max running minimum, least index holding
    it), and a pick's skip test D >= M (`fps_skip_bound`). Every point's
    minimum is computed at every pick as well, to count the minima that a
    skipped warp would have lowered (`moved`)."""
    r = xyz.shape[0]
    dev = xyz.device
    big = torch.iinfo(torch.int64).max
    rows = torch.arange(r, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    idx = fps_warp_points(xyz, slices, threads)
    have = idx >= 0
    p = torch.where(have[..., None], xyz[rows[:, None, None], idx.clamp(min=0)], 0.0)
    box_lo = torch.where(have[..., None], p, inf).amin(2)  # (R, warps, 3)
    box_hi = torch.where(have[..., None], p, -inf).amax(2)
    wreal = have.any(2)
    mind = torch.where(have, inf, 0.0)  # no point: 0, and its index never wins
    ckey = torch.where(have, idx, big).amin(2)
    cmax = torch.where(wreal, inf, 0.0)
    out = torch.zeros((r, n_samples), dtype=torch.int32, device=dev)
    out[:, 0] = start
    last = start.long()
    skipped = moved = 0
    for i in range(1, n_samples):
        lp = xyz[rows, last]  # (R, 3)
        upd = fps_skip_bound(box_lo, box_hi, lp[:, None]) < cmax  # (R, warps)
        full = torch.minimum(mind, sq_norm3(p - lp[:, None, None]))
        moved += int(((full != mind) & have & ~upd[..., None]).sum())
        skipped += int((~upd & wreal).sum())
        mind = torch.where(upd[..., None], full, mind)
        wmax = mind.amax(2)
        wkey = torch.where((mind == wmax[..., None]) & have, idx, big).amin(2)
        cmax = torch.where(upd, wmax, cmax)
        ckey = torch.where(upd, wkey, ckey)
        best = cmax.amax(1, keepdim=True)
        last = torch.where(cmax == best, ckey, big).amin(1)
        out[:, i] = last.int()
    return PrunedPicks(out, skipped, int(wreal.sum()) * (n_samples - 1), moved)


# ---------------------------------------------------------------------------
# fused set-abstraction interior, eval mode
# ---------------------------------------------------------------------------


def sa_fused_eval_plain(q, xyz, centroids, cterm, a1, c1, w2, b2, a2, c2, radius, k):
    """Grouped ball query, gather of q, relu(q_j - cterm_c)*a1 + c1, the
    optional layer relu(h@W2 + b2)*a2 + c2, masked max over the k slots."""
    idx, mask = ball_query_grouped(centroids, xyz, radius, k)  # (B, C, k)
    bidx = torch.arange(q.shape[0], device=q.device)[:, None, None]
    h = torch.relu(q[bidx, idx] - cterm[:, :, None, :]) * a1 + c1  # (B, C, k, C1)
    if w2 is not None:
        h = torch.relu(h @ w2 + b2) * a2 + c2
    h = torch.where(mask[..., None], h, torch.full_like(h, NEG))
    return torch.amax(h, dim=2)


def sa_apply_plain(q, cterm, a1, c1, w2, b2, a2, c2, picks, order):
    """The SA eval kernel's apply phase on the cell-grid path, from its pick
    table: picks (B, C, k) int32, the picked point of each group or -1 where
    none is within the radius; the centroids taken in `order` (B, C) (the
    grid's cell order) and each row written back at its centroid's own
    index. Gather, layers and masked max as `sa_fused_eval_plain`."""
    b, c, _ = picks.shape
    bidx = torch.arange(b, device=q.device)[:, None]
    p = picks[bidx, order].long()  # (B, C, k), in cell order
    ct = cterm[bidx, order]
    h = torch.relu(q[bidx[..., None], p.clamp_min(0)] - ct[:, :, None, :]) * a1 + c1
    if w2 is not None:
        h = torch.relu(h @ w2 + b2) * a2 + c2
    h = torch.where((p >= 0)[..., None], h, torch.full_like(h, NEG))
    out = torch.empty((b, c, h.shape[-1]), dtype=h.dtype, device=h.device)
    out[bidx, order] = torch.amax(h, dim=2)
    return out


def sa_fused_eval_max_g(ch1: int, ch2: int, two: bool, k: int) -> int:
    """The longest group the SA eval kernel stages whole: its block holds
    SEL_WARPS staging slices (16 B a point), the parameters padded to float4
    and a (SEL_TILE, K) int32 table of picks in shared memory."""
    n_prm = 2 * ch1 + (ch1 * ch2 + 3 * ch2 if two else 0)
    return (_SMEM_MAX - 4 * (-(-n_prm // 4) * 4) - 4 * SEL_TILE * k) // (16 * SEL_WARPS)


def sel_path(g: int, max_g: int) -> str:
    """The grouped selection's path for groups of g points, when a warp's
    staging slice of shared memory holds max_g (BQ_MAX_G, or
    sa_fused_eval_max_g of the instance): "whole", csrc/common.cuh's
    select_tile with each group staged whole (every PROD shape), or "grid",
    csrc/grouped_cull.cuh on the cell grid."""
    return "whole" if g <= max_g else "grid"


def sa_fused_eval(
    q: torch.Tensor,
    xyz: torch.Tensor,
    centroids: torch.Tensor,
    cterm: torch.Tensor,
    a1: torch.Tensor,
    c1: torch.Tensor,
    w2: Optional[torch.Tensor],
    b2: Optional[torch.Tensor],
    a2: Optional[torch.Tensor],
    c2: Optional[torch.Tensor],
    radius: float,
    k: int,
) -> torch.Tensor:
    """Eval-mode SA interior. q (B, N, C1) per-point layer-1 projection with
    bias; xyz (B, N, 3); centroids (B, C, 3); cterm (B, C, C1) centroid term;
    (a1, c1) the folded BN of layer 1; (w2 (C1, C2), b2, a2, c2) layer 2 and
    its folded BN, or all None. Returns (B, C, C2) (C2 = C1 without layer 2)."""
    name = "sa_fused_eval"
    b, n, ch1 = q.shape
    c = centroids.shape[1]
    two = w2 is not None
    ch2 = w2.shape[1] if two else ch1
    _expect(xyz.shape == (b, n, 3) and centroids.shape == (b, c, 3)
            and cterm.shape == (b, c, ch1), name, "inconsistent shapes")
    _expect(a1.shape == c1.shape == (ch1,), name, "a1/c1 must be (C1,)")
    if two:
        _expect(w2.shape == (ch1, ch2) and b2.shape == a2.shape == c2.shape == (ch2,),
                name, "layer 2 must be W2 (C1, C2) and (C2,) vectors")
    vecs = [a1, c1] + ([w2, b2, a2, c2] if two else [])
    for t in [q, xyz, centroids, cterm] + vecs:
        _expect(t.dtype == torch.float32, name, "all inputs must be float32")
    if not _on_card(name, q, xyz, centroids, cterm, *vecs):
        return sa_fused_eval_plain(q, xyz, centroids, cterm, a1, c1, w2, b2, a2, c2,
                                   radius, k)
    _expect((ch1, ch2, two) in ((16, 16, True), (32, 32, False)), name,
            f"no kernel instance for C1={ch1}, C2={ch2}, two_layer={two}")
    _expect(q.data_ptr() % 16 == 0 and cterm.data_ptr() % 16 == 0, name,
            "q and cterm must be 16-byte aligned (float4 rows)")
    _expect(b < 65536, name, "the kernel takes at most 65535 clouds")
    _expect(n < 2 ** 31, name, f"N={n}: indices are int32")
    g = -(-n // k)
    prm = torch.cat([v.reshape(-1) for v in vecs])
    out = torch.empty((b, c, ch2), dtype=torch.float32, device=q.device)
    if sel_path(g, sa_fused_eval_max_g(ch1, ch2, two, k)) == "whole":
        _launch(name, q.device, q, xyz, centroids, cterm, prm, out,
                b, n, c, k, g, ch1, ch2, int(two), radius_sq(radius))
        return out
    ws, gmax = _cell_workspace(b, n, c, q.device)
    picks = torch.empty((b, c, k), dtype=torch.int32, device=q.device)
    _launch(name, q.device, q, xyz, centroids, cterm, prm, out, ws, picks,
            b, n, c, k, gmax, ch1, ch2, int(two), radius_sq(radius),
            _grid_cs(b, n + c, q.device),
            entry="sa_fused_eval_grid", path="sa_fused_eval_grid")
    return out


# ---------------------------------------------------------------------------
# exact 3-NN inverse-distance interpolation
# ---------------------------------------------------------------------------


def knn_interpolate_plain(x_src, pos_src, pos_tgt):
    """Mirror of `_knn_single` (stratanet2_tpu/ops/knn.py:71-96) with k=3:
    expanded clamped d2, three first-argmin passes, weights
    1/max(d2, 1e-16), and the weighted sum as XLA rounds it,
    fma(x2, w2, fma(x1, w1, x0*w0)) / ((w0 + w1) + w2)."""
    b, s, f = x_src.shape
    bidx = torch.arange(b, device=x_src.device)[:, None, None]
    src_sq = sq_norm3(pos_src)
    outs, idxs, ws = [], [], []
    chunk = tile_rows(x_src.device, b, s, _KNN_CHUNK)
    for t0 in range(0, pos_tgt.shape[1], chunk):
        t = pos_tgt[:, t0 : t0 + chunk]
        d2 = expanded_d2(t, sq_norm3(t), pos_src, src_sq)  # (B, Tc, S)
        vals, ids = [], []
        for _ in range(3):
            i = torch.argmin(d2, dim=-1, keepdim=True)
            vals.append(torch.gather(d2, -1, i))
            ids.append(i)
            d2 = d2.scatter(-1, i, float("inf"))
        dmin, idx = torch.cat(vals, -1), torch.cat(ids, -1)  # (B, Tc, 3)
        w = 1.0 / torch.clamp_min(dmin, _KNN_EPS)
        wsum = ((w[..., 0] + w[..., 1]) + w[..., 2])[..., None]
        feats, wf = x_src[bidx, idx], w[..., None]  # (B, Tc, 3, F), (B, Tc, 3, 1)
        acc = feats[:, :, 0] * wf[:, :, 0]
        for j in (1, 2):
            acc = fma_f32(feats[:, :, j], wf[:, :, j], acc)
        outs.append(acc / wsum)
        idxs.append(idx.int())
        ws.append(w / wsum)
    return (
        torch.cat(outs, 1),
        torch.cat(idxs, 1).transpose(1, 2).contiguous(),
        torch.cat(ws, 1).transpose(1, 2).contiguous(),
    )


def knn_slices(b: int, t: int) -> int:
    """Warps that split a target group's sources in csrc/knn_interpolate.cu:
    the fewest (1, 2, 4, 8) whose B x ceil(T / 32) x slices warps reach
    KNN_MIN_WARPS; 8 where none does. Fewer slices mean longer scans a warp,
    whose top 3 then changes less often."""
    groups = b * -(-t // 32)
    return next((w for w in (1, 2, 4) if groups * w >= KNN_MIN_WARPS), KNN_WARPS)


def knn_path(s: int, t: int) -> str:
    """csrc/knn_interpolate.cu's path for clouds of s sources and t targets:
    "whole", knn_kernel scoring every pair (PROD's FP1, s = 2,500, and FP2,
    625), or "grid", the cell grid (s >= KNN_GRID_MIN_S: the dense plots'
    FP1 and FP2, s = 16,384 and 4,096), each warp of targets scanning rings
    of source cells until the stop rule holds; the same picks. On an H100
    the grid was faster at every s timed, from 1,024; the threshold keeps
    PROD's shapes on knn_kernel. t does not enter: both paths' work grows
    with it alike."""
    return "grid" if s >= KNN_GRID_MIN_S else "whole"


def _knn_check(x_src, pos_src, pos_tgt) -> bool:
    """Checks knn_interpolate's arguments; True for CUDA tensors."""
    name = "knn_interpolate"
    b, s, _ = x_src.shape
    t = pos_tgt.shape[1]
    _expect(pos_src.shape == (b, s, 3) and pos_tgt.shape == (b, t, 3), name,
            "positions must be (B, S, 3) and (B, T, 3)")
    _expect(s >= 3, name, "need at least 3 source points")
    for x in (x_src, pos_src, pos_tgt):
        _expect(x.dtype == torch.float32, name, "all inputs must be float32")
    if not _on_card(name, x_src, pos_src, pos_tgt):
        return False
    _expect(b < 65536, name, "the kernel takes at most 65535 clouds")
    _expect(s < 2 ** 31, name, f"S={s}: indices are int32")
    return True


def knn_interpolate(x_src: torch.Tensor, pos_src: torch.Tensor, pos_tgt: torch.Tensor):
    """Exact 3-NN inverse-d^2 interpolation: x_src (B, S, F), pos_src
    (B, S, 3), pos_tgt (B, T, 3) -> out (B, T, F), idx (B, 3, T) int32 and
    normalised weights (B, 3, T) (kept for the backward of the train slice).
    Ties go to the lowest source index. On the card `knn_path` chooses the
    kernel by shape."""
    if not _knn_check(x_src, pos_src, pos_tgt):
        return knn_interpolate_plain(x_src, pos_src, pos_tgt)
    b, s, f = x_src.shape
    t = pos_tgt.shape[1]
    if knn_path(s, t) == "grid":
        return _knn_grid_launch(x_src, pos_src, pos_tgt, None)
    out = torch.empty((b, t, f), dtype=torch.float32, device=x_src.device)
    idx = torch.empty((b, 3, t), dtype=torch.int32, device=x_src.device)
    w = torch.empty((b, 3, t), dtype=torch.float32, device=x_src.device)
    _launch("knn_interpolate", x_src.device, x_src, pos_src, pos_tgt, out, idx, w, b, s, t, f,
            knn_slices(b, t))
    return out, idx, w


def knn_interpolate_grid(x_src: torch.Tensor, pos_src: torch.Tensor, pos_tgt: torch.Tensor):
    """`knn_interpolate` on the cell grid at any shape, and the sources each
    target's warp scanned, scored (B, T) int32: one counted launch on the
    card; on the CPU the plain version and `ballquery.knn_grid_picks`'s
    count."""
    if not _knn_check(x_src, pos_src, pos_tgt):
        return (*knn_interpolate_plain(x_src, pos_src, pos_tgt),
                ballquery.knn_grid_picks(pos_src, pos_tgt)[2].int())
    b, t = pos_tgt.shape[:2]
    scored = torch.empty((b, t), dtype=torch.int32, device=x_src.device)
    return (*_knn_grid_launch(x_src, pos_src, pos_tgt, scored), scored)


def _knn_grid_launch(x_src, pos_src, pos_tgt, scored):
    """One counted launch of the kNN cell-grid path (grid pass and query)."""
    b, s, f = x_src.shape
    t = pos_tgt.shape[1]
    out = torch.empty((b, t, f), dtype=torch.float32, device=x_src.device)
    idx = torch.empty((b, 3, t), dtype=torch.int32, device=x_src.device)
    w = torch.empty((b, 3, t), dtype=torch.float32, device=x_src.device)
    ws, gmax = _cell_workspace(b, s, t, x_src.device)
    _launch("knn_interpolate", x_src.device, x_src, pos_src, pos_tgt, out, idx, w, ws, scored,
            b, s, t, f, gmax, _grid_cs(b, s + t, x_src.device), entry="knn_interpolate_grid",
            path="knn_interpolate_grid")
    return out, idx, w


# ---------------------------------------------------------------------------
# per-pixel max and its backward
# ---------------------------------------------------------------------------


def pixel_max_plain(pix: torch.Tensor, vals: torch.Tensor, n_pix: int):
    """Per-pixel max and first argmax by two scatters over the points, O(N)
    at any table (the JAX CPU path's dense (P, N) masked max costs P x N):
    each pixel's max value, then the lowest index among its points that
    reach it. Ids outside [0, n_pix) match no pixel."""
    b, n, c = vals.shape
    inside = (pix >= 0) & (pix < n_pix)
    seg = torch.where(inside, pix, n_pix).long()[..., None].expand(b, n, c)  # row n_pix: outside
    vmax = torch.full((b, n_pix + 1, c), NEG, dtype=vals.dtype, device=vals.device)
    vmax = vmax.scatter_reduce(1, seg, vals, "amax")
    ids = torch.arange(n, device=pix.device)[None, :, None].expand(b, n, c)
    first = torch.where(vals == torch.gather(vmax, 1, seg), ids, n)
    amax = torch.full((b, n_pix + 1, c), n, dtype=torch.long, device=pix.device)
    amax = amax.scatter_reduce(1, seg, first, "amin")[:, :n_pix]
    occ = amax < n
    return (torch.where(occ, vmax[:, :n_pix], NEG),
            torch.where(occ, amax, -1).int())


def pixel_max_range(n_pix: int, c: int) -> int:
    """Pixels of each range of csrc/pixel_max.cu's pixel_max_kernel (a
    cluster a range and cloud) for a table of n_pix pixels x c channels of
    64-bit keys: n_pix, one range, when the whole table fits in a block's
    shared memory (8 n_pix c <= 232,448 B: diam_pix <= 98 at c = 3), else
    the fewest ranges whose tables of at most PIXEL_MAX_PAIR_TABLE keys
    leave two blocks on each SM (three at diam_pix 100 and c = 3; the
    fewest that fit, one block an SM, took 1.4x as long on an H100), cut
    evenly (the last may hold fewer)."""
    if n_pix * c <= PIXEL_MAX_TABLE:
        return n_pix
    ranges = -(-n_pix // (PIXEL_MAX_PAIR_TABLE // c))
    return -(-n_pix // ranges)


def pixel_max(pix: torch.Tensor, vals: torch.Tensor, n_pix: int):
    """Per-pixel max of pointwise values: pix (B, N) int32 pixel ids, vals
    (B, N, C) float32 (> -3e38) -> vmax (B, n_pix, C) float32 (-3.4e38 where
    empty) and amax (B, n_pix, C) int32 winning point (-1 where empty; ties
    to the lowest index). Ids outside [0, n_pix) never match."""
    name = "pixel_max"
    b, n, c = vals.shape
    _expect(pix.shape == (b, n) and pix.dtype == torch.int32, name,
            "pix must be (B, N) int32")
    _expect(vals.dtype == torch.float32, name, "vals must be float32")
    _expect(b >= 1 and n >= 1 and c >= 1 and n_pix >= 1, name, "empty input")
    if not _on_card(name, pix, vals):
        return pixel_max_plain(pix, vals, n_pix)
    _expect(c <= PIXEL_MAX_TABLE, name, f"{c} channels exceed a block's table")
    _expect(b < 65536, name, "the kernel takes at most 65535 clouds")
    vmax = vals.new_empty((b, n_pix, c))  # cheaper on the host than torch.empty(..., device=)
    amax = pix.new_empty((b, n_pix, c))
    per = pixel_max_range(n_pix, c)
    _expect(-(-n_pix // per) < 65536, name, f"{n_pix} pixels exceed the grid")
    _launch(name, vals.device, pix, vals, vmax, amax, b, n, n_pix, c, per,
            path="pixel_max_ranges" if per < n_pix else None)
    return vmax, amax


def pixel_max_bwd_plain(pix: torch.Tensor, amax: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dv (B, N, C): each pixel's cotangent stored at its winning point,
    zero elsewhere (an indexed store; winners are unique per channel). It
    takes only N from pix, so it is an independent check of the kernel's
    gather by pixel id."""
    b, _, c = g.shape
    n = pix.shape[1]
    dv = torch.zeros((b, n, c), dtype=g.dtype, device=g.device)
    hit = (amax >= 0) & (amax < n)
    bi, _, ci = torch.nonzero(hit, as_tuple=True)
    dv[bi, amax[hit].long(), ci] = g[hit]
    return dv


def pixel_max_bwd(pix: torch.Tensor, amax: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward of `pixel_max` in its values: pix (B, N) int32 pixel ids and
    amax (B, P, C) int32 winners (-1 where empty), both of the forward call,
    g (B, P, C) float32 cotangents of vmax -> dv (B, N, C) float32 with
    g[b, p, ch] at point amax[b, p, ch] of channel ch. The kernel gathers:
    dv[b, i, ch] = g[b, p, ch] where p = pix[b, i] is in range and
    amax[b, p, ch] == i, which is the same because a point lies in one pixel."""
    name = "pixel_max_bwd"
    b, p, c = g.shape
    n = pix.shape[1] if pix.dim() == 2 else 0
    _expect(pix.shape == (b, n) and pix.dtype == torch.int32, name,
            "pix must be (B, N) int32")
    _expect(amax.shape == (b, p, c) and amax.dtype == torch.int32, name,
            "amax must be (B, P, C) int32, the shape of g")
    _expect(g.dtype == torch.float32, name, "g must be float32")
    _expect(b >= 1 and p >= 1 and c >= 1 and n >= 1, name, "empty input")
    if not _on_card(name, pix, amax, g):
        return pixel_max_bwd_plain(pix, amax, g)
    _expect(b < 65536 and c <= 256, name, "the kernel takes at most 65535 clouds and 256 channels")
    dv = g.new_empty((b, n, c))  # cheaper on the host than torch.empty(..., device=)
    _launch(name, g.device, pix, amax, g, dv, b, n, p, c)
    return dv


# ---------------------------------------------------------------------------
# standalone grouped ball query
# ---------------------------------------------------------------------------


def ball_query_plain(centroids: torch.Tensor, points: torch.Tensor, radius: float, k: int):
    """`ballquery.ball_query_grouped` with int32 indices."""
    idx, mask = ball_query_grouped(centroids, points, radius, k)
    return idx.int(), mask


def ball_query(centroids: torch.Tensor, points: torch.Tensor, radius: float, k: int):
    """Grouped fixed-K ball query: (B, C, 3) centroids, (B, N, 3) points ->
    idx (B, C, k) int32 and mask (B, C, k) bool. Per centroid and group of
    ceil(N/k) consecutive points, the nearest point within `radius` (ties
    to the lowest index); idx 0 and mask False where a group has none."""
    name = "ball_query"
    b, c, _ = centroids.shape
    n = points.shape[1]
    _expect(centroids.shape == (b, c, 3) and points.shape == (b, n, 3), name,
            "centroids must be (B, C, 3) and points (B, N, 3)")
    for t in (centroids, points):
        _expect(t.dtype == torch.float32, name, "positions must be float32")
    _expect(k >= 1 and n >= 1, name, "need k >= 1 and N >= 1")
    if not _on_card(name, centroids, points):
        return ball_query_plain(centroids, points, radius, k)
    g = -(-n // k)
    _expect(b < 65536, name, "the kernel takes at most 65535 clouds")
    _expect(n < 2 ** 31, name, f"N={n}: indices are int32")
    idx = torch.empty((b, c, k), dtype=torch.int32, device=points.device)
    mask = torch.empty((b, c, k), dtype=torch.bool, device=points.device)
    if sel_path(g, BQ_MAX_G) == "whole":
        _launch(name, points.device, centroids, points, idx, mask, b, n, c, k, g,
                radius_sq(radius))
        return idx, mask
    ws, gmax = _cell_workspace(b, n, c, points.device)
    _launch(name, points.device, centroids, points, idx, mask, ws, b, n, c, k, gmax,
            radius_sq(radius), _grid_cs(b, n + c, points.device), entry="ball_query_grid",
            path="ball_query_grid")
    return idx, mask


# ---------------------------------------------------------------------------
# nearest ball query
# ---------------------------------------------------------------------------


def ball_query_nearest_plain(centroids: torch.Tensor, points: torch.Tensor, radius: float,
                             k: int):
    """`ballquery.ball_query_nearest` with int32 indices."""
    idx, mask = ballquery.ball_query_nearest(centroids, points, radius, k)
    return idx.int(), mask


def ball_query_nearest(centroids: torch.Tensor, points: torch.Tensor, radius: float, k: int):
    """The k nearest points within `radius`: (B, C, 3) centroids, (B, N, 3)
    points -> idx (B, C, k) int32 and mask (B, C, k) bool, ascending by
    (d2, index); idx 0 and mask False past a centroid's in-radius count."""
    if not _nearest_on_card(centroids, points, k):
        return ball_query_nearest_plain(centroids, points, radius, k)
    idx, mask, _ = _nearest_launch(centroids, points, radius, k)
    return idx, mask


def ball_query_nearest_grid(centroids: torch.Tensor, points: torch.Tensor, radius: float,
                            k: int):
    """`ball_query_nearest`'s idx and mask and the cell grid that its kernel
    built for them (one counted launch on the card; on the CPU the plain
    picks and `ballquery.nearest_cells` in the kernel's layout). The grid is
    a dict of xmin, ymin, inv_h, rc2 (B,) float32; gx, gy (B,) int64; starts
    (B, g^2 + 1), sorted_idx (B, N) and cent_order (B, C) int64; sorted_pts
    (B, N, 4) float32 [x, y, z, |p|^2]."""
    if not _nearest_on_card(centroids, points, k):
        b, n, _ = points.shape
        m = ballquery.nearest_cells(centroids, points, radius)
        pts = torch.gather(points, 1, m.order[..., None].expand(b, n, 3))
        grid = dict(xmin=m.xmin, ymin=m.ymin, inv_h=m.inv_h, rc2=m.rc2, gx=m.gx, gy=m.gy,
                    starts=m.starts, sorted_idx=m.order, cent_order=m.cent_order,
                    sorted_pts=torch.cat([pts, sq_norm3(pts)[..., None]], -1))
        return (*ball_query_nearest_plain(centroids, points, radius, k), grid)
    idx, mask, ws = _nearest_launch(centroids, points, radius, k)
    return idx, mask, cell_grid_view(ws, points.shape[0], points.shape[1], centroids.shape[1])


def _nearest_on_card(centroids: torch.Tensor, points: torch.Tensor, k: int) -> bool:
    """Checks the nearest selection's arguments; True for CUDA tensors."""
    name = "ball_query_nearest"
    b, c, _ = centroids.shape
    n = points.shape[1]
    _expect(centroids.shape == (b, c, 3) and points.shape == (b, n, 3), name,
            "centroids must be (B, C, 3) and points (B, N, 3)")
    for t in (centroids, points):
        _expect(t.dtype == torch.float32, name, "positions must be float32")
    _expect(1 <= k <= n, name, "need 1 <= k <= N")
    if not _on_card(name, centroids, points):
        return False
    _expect(k <= NEAREST_MAX_K, name, f"k={k} exceeds the kernel's limit of {NEAREST_MAX_K}")
    _expect(b < 65536 and n < 2 ** 31, name, "the kernel takes at most 65535 clouds")
    return True


def _nearest_launch(centroids: torch.Tensor, points: torch.Tensor, radius: float, k: int):
    """One counted launch of the nearest kernel (grid pass and query): idx,
    mask and the workspace (`_cell_layout`)."""
    b, c, _ = centroids.shape
    n = points.shape[1]
    idx = torch.empty((b, c, k), dtype=torch.int32, device=points.device)
    mask = torch.empty((b, c, k), dtype=torch.bool, device=points.device)
    ws, g = _cell_workspace(b, n, c, points.device)
    _launch("ball_query_nearest", points.device, centroids, points, idx, mask, ws, b, n, c, k,
            g, radius_sq(radius), _grid_cs(b, n + c, points.device))
    return idx, mask, ws


def _cell_layout(b: int, n: int, c: int):
    """g = `ballquery.nearest_grid_side(N)`, from the shapes alone, and the
    int32 parts of the cell grid's workspace (the nearest kernel's, the
    grouped selection's and kNN's grid paths; for kNN N counts the sources
    and C the targets) in the order of csrc/cell_grid.cuh's
    `carve_cells`, by name and shape: spts (B, N, 4) (float4 [x, y, z,
    |p|^2]), sidx (B, N), starts (B, g^2 + 1), corder (B, C) and params
    (B, 6)."""
    g = ballquery.nearest_grid_side(n)
    return g, {"spts": (b, n, 4), "sidx": (b, n), "starts": (b, g * g + 1), "corder": (b, c),
               "params": (b, 6)}


def _cell_workspace(b: int, n: int, c: int, device: torch.device):
    """The cell grid's workspace (`_cell_layout`) as one int32 tensor, and
    g."""
    g, layout = _cell_layout(b, n, c)
    size = sum(math.prod(s) for s in layout.values())
    return torch.empty(size, dtype=torch.int32, device=device), g


def cell_grid_view(ws: torch.Tensor, b: int, n: int, c: int) -> Dict[str, torch.Tensor]:
    """The cell grid that a grid pass wrote into the workspace `ws`
    (`_cell_workspace`) of b clouds of n points (kNN: sources) and c
    centroids (targets), as a dict of xmin, ymin, inv_h, rc2 (kNN: M) (B,)
    float32; gx, gy (B,) int64; starts (B, g^2 + 1), sorted_idx (B, N) and
    cent_order (B, C) int64; sorted_pts (B, N, 4) float32 [x, y, z,
    |p|^2]."""
    _, layout = _cell_layout(b, n, c)
    parts = dict(zip(layout, torch.split(ws, [math.prod(s) for s in layout.values()])))
    views = {key: parts[key].view(shape) for key, shape in layout.items()}
    prm = views["params"]
    fl = prm[:, :4].view(torch.float32)
    return dict(xmin=fl[:, 0], ymin=fl[:, 1], inv_h=fl[:, 2], rc2=fl[:, 3],
                gx=prm[:, 4].long(), gy=prm[:, 5].long(), starts=views["starts"].long(),
                sorted_idx=views["sidx"].long(), cent_order=views["corder"].long(),
                sorted_pts=views["spts"].view(torch.float32))


def cell_grid_cluster(b: int, n: int, sms: int = CARD_SMS) -> int:
    """Blocks a cloud of csrc/cell_grid.cuh's grid pass (a cluster, its
    size a launch attribute) for b clouds of n entries each (points and
    centroids, or kNN's sources and targets: all that the pass sorts) on a
    card of `sms` SMs: the most blocks up to CELL_GRID_CLUSTER_MAX such
    that (1) each block's slice holds GRID_ENTRIES_A_BLOCK entries or more
    (a shorter slice saves less than a block's share of the cluster's
    barriers and histograms costs), and (2) the b clusters take at most
    GRID_SM_SHARE of the SMs, or GRID_CLUSTER_FLOOR blocks a cloud if that
    is more: past that share blocks double up on SMs while each still
    reads cs histograms, and a cloud of a few blocks in two waves beats one
    block a cloud. On an H100 (scripts/kernel_variants.py cell_grid, every
    cs at each site; PERF.md): 4 at the dense steps' B=20 sites and the
    nearest route's PROD SA1, 3 at its SA2 (3,125 entries a cloud), 8 at
    B <= 11 with large clouds, 4 at B=67."""
    spread = max(GRID_CLUSTER_FLOOR, sms * GRID_SM_SHARE[0] // (GRID_SM_SHARE[1] * max(b, 1)))
    return max(1, min(CELL_GRID_CLUSTER_MAX, n // GRID_ENTRIES_A_BLOCK, spread))


_card_sms: Dict[int, int] = {}


def _grid_cs(b: int, n: int, device: torch.device) -> int:
    """`cell_grid_cluster` of b clouds of n entries on `device`'s SMs (asked
    once)."""
    if device.index not in _card_sms:
        _card_sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return cell_grid_cluster(b, n, _card_sms[device.index])


# ---------------------------------------------------------------------------
# weighted scatter-add: kNN backward, gather backward
# ---------------------------------------------------------------------------


def knn_scatter_plain(idx: torch.Tensor, w: Optional[torch.Tensor], g: torch.Tensor, s: int):
    """dx[b, idx[b, j, t]] += w[b, j, t] * g[b, t]: the float32 products,
    accumulated in float64 by `index_add_` over the flattened batch, then
    rounded once to float32."""
    b, k, t = idx.shape
    f = g.shape[2]
    contrib = g[:, None].expand(b, k, t, f)
    if w is not None:
        contrib = w[..., None] * contrib
    flat = (idx.long() + (torch.arange(b, device=g.device) * s)[:, None, None]).reshape(-1)
    out = torch.zeros((b * s, f), dtype=torch.float64, device=g.device)
    out.index_add_(0, flat, contrib.reshape(-1, f).double())
    return out.float().reshape(b, s, f)


def _run_ranks(keys: torch.Tensor):
    """Each element's rank within its run of equal values in sorted `keys`,
    and the runs' starts and lengths."""
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(first).squeeze(1)
    sizes = torch.diff(torch.cat([starts, starts.new_tensor([keys.numel()])]))
    rank = torch.arange(keys.numel(), device=keys.device) - torch.repeat_interleave(starts, sizes)
    return rank, starts, sizes


def knn_scatter_ordered_plain(idx: torch.Tensor, w: Optional[torch.Tensor], g: torch.Tensor,
                              s: int, pairs: int = KNN_SCATTER_PAIRS,
                              chunk: int = KNN_SCATTER_CHUNK):
    """`knn_scatter` in the kernel's order of float32 sums (csrc/knn_scatter.cu).
    Pair p = j * T + t contributes w * g[t] (float32 product; g itself
    without weights) to its row. The pairs are taken in rounds of `pairs`
    consecutive p; a row's pairs of one round, in increasing p, are cut into
    chunks of `chunk`; each chunk is summed in order from 0, and the row is
    0 plus its chunks' sums, rounds in order and chunks in order within a
    round. Every step is an `index_add_` whose indices are distinct, so it
    rounds once per element, as the kernel's `__fadd_rn` does. Ids outside
    [0, S) are skipped."""
    b, k, t = idx.shape
    f = g.shape[2]
    kt = k * t
    contrib = g[:, None].expand(b, k, t, f)
    if w is not None:
        contrib = w[..., None] * contrib
    contrib = contrib.reshape(b * kt, f)
    d = idx.reshape(b, kt).long()
    keep = ((d >= 0) & (d < s)).reshape(-1)
    rounds = -(-kt // pairs)
    row = d + (torch.arange(b, device=g.device) * s)[:, None]
    bucket = (row * rounds + torch.arange(kt, device=g.device) // pairs).reshape(-1)[keep]
    bucket, order = torch.sort(bucket, stable=True)  # stable: increasing p within a bucket
    src = torch.nonzero(keep).squeeze(1)[order]
    rank, starts, sizes = _run_ranks(bucket)
    chunks = -(-sizes // chunk)  # of each bucket
    cid = torch.repeat_interleave(torch.cumsum(chunks, 0) - chunks, sizes) + rank // chunk
    partial = torch.zeros((int(chunks.sum()), f), dtype=g.dtype, device=g.device)
    for pos in range(min(chunk, int(sizes.max()) if sizes.numel() else 0)):
        sel = rank % chunk == pos
        partial.index_add_(0, cid[sel], contrib[src[sel]])
    # a row's chunks are adjacent, rounds in order (the buckets are sorted)
    chunk_row = torch.repeat_interleave(bucket[starts] // rounds, chunks)
    ordinal, _, per_row = _run_ranks(chunk_row)
    out = torch.zeros((b * s, f), dtype=g.dtype, device=g.device)
    for o in range(int(per_row.max()) if per_row.numel() else 0):
        sel = ordinal == o
        out.index_add_(0, chunk_row[sel], partial[sel])
    return out.reshape(b, s, f)


def knn_scatter_rows(b: int, s: int, f: int) -> int:
    """The rows a block of csrc/knn_scatter.cu owns at this shape, as its
    launch chooses them (read from the built library)."""
    return _build.load("knn_scatter").knn_scatter_rows(b, s, f)


def knn_scatter(idx: torch.Tensor, w: Optional[torch.Tensor], g: torch.Tensor, s: int):
    """Weighted scatter-add into S rows: idx (B, k, T) int32 in [0, S),
    w (B, k, T) float32 or None (all ones), g (B, T, F) float32 -> dx
    (B, S, F) with dx[b, idx[b, j, t]] += w[b, j, t] * g[b, t]. The backward
    of `knn_interpolate` (k=3, its normalised weights) and of `gather_rows`
    (k=1, no weights). On the card each row is summed in one fixed order,
    `knn_scatter_ordered_plain`'s, so the result is reproducible bit for bit."""
    name = "knn_scatter"
    b, k, t = idx.shape
    f = g.shape[2]
    _expect(idx.dtype == torch.int32, name, "idx must be int32")
    _expect(g.shape == (b, t, f) and g.dtype == torch.float32, name,
            "g must be (B, T, F) float32")
    _expect(w is None or (w.shape == idx.shape and w.dtype == torch.float32), name,
            "w must be None or float32 of idx's shape")
    _expect(s >= 1, name, "need S >= 1")
    if not _on_card(name, idx, w, g):
        return knn_scatter_plain(idx, w, g, s)
    _expect(b < 65536 and f <= KNN_SCATTER_MAX_F and t * f < 2 ** 31, name,
            f"the kernel takes at most 65535 clouds, {KNN_SCATTER_MAX_F} channels and "
            "T x F < 2^31")
    dx = g.new_empty((b, s, f))
    _launch(name, g.device, idx, w, g, dx, b, k, t, s, f)
    return dx


# ---------------------------------------------------------------------------
# fused set-abstraction interior, train mode: four edge passes
# ---------------------------------------------------------------------------

# Rows of the per-channel table `aff` (len(SA_AFF_ROWS), width) that the SA
# train passes read (enum AffRow in csrc/sa_train.cu): BN1 folded into
# h1*a1 + c1 and the layer-2 bias b2 (two layers); per BN ("2" the second
# layer's, "1" the first's): gos = gamma/sigma, m = batch mean, inv_s =
# 1/sigma, s1n = S1/M and s2n = S2/M, the backward's correction sums over M
# valid edges; shift1 and shift_l, the shifts of the one-pass statistics of
# BN1 (stats pass) and of the last BN (main pass).
SA_AFF_ROWS = ("a1", "c1", "b2", "gos2", "m2", "inv_s2", "s1n2", "s2n2",
               "m1", "inv_s1", "gos1", "s1n1", "s2n1", "shift1", "shift_l")
SA_AFF = {name: row for row, name in enumerate(SA_AFF_ROWS)}
SA_THREADS = 256  # threads a block of csrc/sa_train.cu
SA_MAX_BLOCKS = 8 * 132  # its grid: at most 8 blocks of 256 threads on each of 132 SMs


def sa_train_stats_lanes(ch1: int) -> int:
    """Lanes a centroid of the stats pass at C1 = ch1, as csrc/sa_train.cu
    sets them (read from the built library; main, bwd1 and bwd2 take C1
    lanes a centroid, a lane a channel)."""
    return _build.load("sa_train").sa_train_stats_lanes(ch1)


def sa_grid(b: int, c: int, lanes: int) -> int:
    """Blocks of an SA train launch over b*c centroids, `lanes` lanes a
    centroid: group g of block i walks centroids i*G + g +
    j*grid*G, G = SA_THREADS // lanes, and each block writes one partial row
    of its sums."""
    return max(1, min(-(-b * c // (SA_THREADS // lanes)), SA_MAX_BLOCKS))


def sa_aff(width: int, base: Optional[torch.Tensor] = None, **rows: torch.Tensor) -> torch.Tensor:
    """The (len(SA_AFF_ROWS), width) float32 table: `base`'s rows (zeros
    without one), with each named row replaced, zero-padded to `width`."""
    if base is None:
        ref = next(iter(rows.values()))
        cur = [ref.new_zeros(width)] * len(SA_AFF_ROWS)
    else:
        cur = list(base.unbind(0))
    for name, v in rows.items():
        pad = width - v.shape[0]
        cur[SA_AFF[name]] = F.pad(v.float(), (0, pad)) if pad else v.float()
    return torch.stack(cur)


def _sum64(t: torch.Tensor, dims=(0, 1, 2)) -> torch.Tensor:
    """Sum over `dims` in float64, rounded once to float32."""
    return t.double().sum(dims).float()


def _fma_chain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., I) x (I, O) -> (..., O) as fma(x[I-1], w[I-1], ... fma(x[1], w[1],
    x[0]*w[0])), each step rounded once: the order of the kernels' products."""
    s = x[..., :1] * w[0]
    for i in range(1, x.shape[-1]):
        s = fma_f32(x[..., i : i + 1], w[i], s)
    return s


def sa_train_edges(q, cterm, idx, mask, aff, w2, awin=None, gt=None):
    """Every per-edge value (B, C, K, ch) of the SA train passes, rounded as
    csrc/sa_train.cu rounds it: e0 = q[idx] - cterm and h1 = relu(e0); with
    W2, y1 = h1*a1 + c1 and u = y1 @ W2 + b2 (an fma chain); h, the last
    layer's pre-BN output. Given the winner slots `awin` and cotangents `gt`
    (B, C, C2): dy, the last BN's cotangent (gt at the winner slot); with W2,
    du (BN2's backward through relu(u)) and dy1 = du @ W2^T (an fma chain);
    xhat1 and de0 (BN1's backward through relu(e0)). `m` is the mask
    (B, C, K, 1); backward values are zero on masked slots, which the kernels
    skip."""
    ch1 = q.shape[2]
    m = mask[..., None]

    def row(name, width):
        return aff[SA_AFF[name], :width]

    bidx = torch.arange(q.shape[0], device=q.device)[:, None, None]
    e0 = q[bidx, idx.long()] - cterm[:, :, None, :]
    h1 = torch.relu(e0)
    out = dict(m=m, e0=e0, h1=h1, h=h1)
    if w2 is not None:
        ch2 = w2.shape[1]
        y1 = h1 * row("a1", ch1) + row("c1", ch1)
        u = _fma_chain(y1, w2) + row("b2", ch2)
        out.update(y1=y1, u=u, h=torch.relu(u))
    if awin is None:
        return out

    def bn_relu_bwd(dy, x, pre, n):  # gos * ((dy - s1n) - xhat * s2n), gated by pre > 0
        xhat = (x - row(f"m{n}", x.shape[-1])) * row(f"inv_s{n}", x.shape[-1])
        dx = row(f"gos{n}", x.shape[-1]) * ((dy - row(f"s1n{n}", x.shape[-1]))
                                           - xhat * row(f"s2n{n}", x.shape[-1]))
        return torch.where(m & (pre > 0), dx, torch.zeros_like(dx)), xhat

    slot = torch.arange(idx.shape[2], device=q.device)[None, None, :, None]
    dy = torch.where(m & (awin[:, :, None, :] == slot), gt[:, :, None, :], 0.0)
    out["dy"] = dy
    if w2 is not None:
        du, _ = bn_relu_bwd(dy, out["h"], out["u"], 2)
        dy1 = _fma_chain(du, w2.t())
        out.update(du=du)
    else:
        dy1 = dy
    de0, xhat1 = bn_relu_bwd(dy1, h1, e0, 1)
    out.update(dy1=dy1, xhat1=xhat1, de0=de0)
    return out


def _sa_check(name, q, cterm, idx, mask, aff, w2, awin=None, gt=None):
    b, n, ch1 = q.shape
    c, k = idx.shape[1], idx.shape[2]
    ch2 = w2.shape[1] if w2 is not None else ch1
    _expect(cterm.shape == (b, c, ch1), name, "cterm must be (B, C, C1)")
    _expect(idx.shape == mask.shape == (b, c, k) and idx.dtype == torch.int32
            and mask.dtype == torch.bool, name, "idx/mask must be (B, C, K) int32/bool")
    _expect(aff.dim() == 2 and aff.shape[0] == len(SA_AFF_ROWS)
            and aff.shape[1] >= max(ch1, ch2), name,
            "aff must be (len(SA_AFF_ROWS), width >= max(C1, C2))")
    _expect(w2 is None or w2.shape == (ch1, ch2), name, "w2 must be (C1, C2)")
    if awin is not None:
        _expect(awin.shape == gt.shape == (b, c, ch2) and awin.dtype == torch.int32, name,
                "awin/gt must be (B, C, C2) int32/float32")
    for t in (q, cterm, aff, w2, gt):
        _expect(t is None or t.dtype == torch.float32, name, "values must be float32")
    return b, n, c, k, ch1, ch2


def _sa_grid(name, aff, b, c, ch1, ch2, two, stats_only=False):
    want = ((16, 16, True),) if stats_only else ((16, 16, True), (32, 32, False))
    _expect((ch1, ch2, two) in want, name,
            f"no kernel instance for C1={ch1}, C2={ch2}, two_layer={two}")
    _expect(aff.shape[1] == ch1, name, "the kernel takes aff rows of width C1")
    return sa_grid(b, c, sa_train_stats_lanes(ch1) if stats_only else ch1)


def sa_train_stats_plain(q, cterm, idx, mask, aff):
    e = sa_train_edges(q, cterm, idx, mask, aff, None)
    hc = torch.where(e["m"], e["h1"] - aff[SA_AFF["shift1"], : q.shape[2]], 0.0)
    return _sum64(hc), _sum64(hc.double() * hc)


def sa_train_stats(q, cterm, idx, mask, aff):
    """BN1's batch statistics over the valid edges: (sum(h1 - shift1),
    sum((h1 - shift1)^2)), each (C1,), with h1 = relu(q[idx] - cterm). q
    (B, N, C1), cterm (B, C, C1), idx/mask (B, C, K) int32/bool from
    `ball_query`, aff from `sa_aff` (row shift1). On the card q and cterm
    must be 16-byte aligned (a lane reads 4 channels as one float4); each
    block sums its edges in one fixed order into a partial row, and the rows
    are summed here with torch, so two runs give the same bits."""
    name = "sa_train_stats"
    b, n, c, k, ch1, _ = _sa_check(name, q, cterm, idx, mask, aff, None)
    if not _on_card(name, q, cterm, idx, mask, aff):
        return sa_train_stats_plain(q, cterm, idx, mask, aff)
    _expect(q.data_ptr() % 16 == 0 and cterm.data_ptr() % 16 == 0, name,
            "q and cterm must be 16-byte aligned")
    grid = _sa_grid(name, aff, b, c, ch1, ch1, True, stats_only=True)
    partial = torch.empty((grid, 2, ch1), dtype=torch.float32, device=q.device)
    _launch(name, q.device, q, cterm, idx, mask, aff, partial, grid, b, n, c, k, ch1)
    s = partial.sum(0)
    return s[0], s[1]


def sa_train_main_plain(q, cterm, idx, mask, aff, w2):
    e = sa_train_edges(q, cterm, idx, mask, aff, w2)
    h, m = e["h"], e["m"]
    hc = torch.where(m, h - aff[SA_AFF["shift_l"], : h.shape[-1]], 0.0)
    e_hi = torch.where(m, h, NEG)
    e_lo = torch.where(m, h, -NEG)
    return (_sum64(hc), _sum64(hc.double() * hc),  # argmax/argmin: first extreme slot
            torch.amax(e_hi, 2), torch.amin(e_lo, 2),
            torch.argmax(e_hi, 2).int(), torch.argmin(e_lo, 2).int())


def sa_train_main(q, cterm, idx, mask, aff, w2):
    """The last layer's pre-BN h over the valid edges (h = relu(h1) with one
    layer, relu((h1*a1 + c1) @ W2 + b2) with two): its statistics (sum(h -
    shift_l), sum((h - shift_l)^2)), each (C2,), and per centroid and
    channel the masked max and min over the K slots with the first winning
    slot: vmax, vmin (B, C, C2) float32 (-3.4e38 / 3.4e38 with no valid
    slot), amax, amin (B, C, C2) int32. w2 (C1, C2) or None; aff rows a1,
    c1, b2 (two layers) and shift_l."""
    name = "sa_train_main"
    b, n, c, k, ch1, ch2 = _sa_check(name, q, cterm, idx, mask, aff, w2)
    if not _on_card(name, q, cterm, idx, mask, aff, w2):
        return sa_train_main_plain(q, cterm, idx, mask, aff, w2)
    two = w2 is not None
    grid = _sa_grid(name, aff, b, c, ch1, ch2, two)
    partial = torch.empty((grid, 2, ch2), dtype=torch.float32, device=q.device)
    vmax, vmin = (torch.empty((b, c, ch2), dtype=torch.float32, device=q.device) for _ in range(2))
    amax, amin = (torch.empty((b, c, ch2), dtype=torch.int32, device=q.device) for _ in range(2))
    _launch(name, q.device, q, cterm, idx, mask, aff, w2, partial, vmax, vmin, amax, amin,
            grid, b, n, c, k, ch1, int(two))
    s = partial.sum(0)
    return s[0], s[1], vmax, vmin, amax, amin


def sa_train_bwd1_plain(q, cterm, idx, mask, aff, w2, awin, gt):
    e = sa_train_edges(q, cterm, idx, mask, aff, w2, awin, gt)
    dy1, du = e["dy1"], e["du"]
    dw2 = torch.einsum("bcki,bcko->io", e["y1"].double(), du.double()).float()
    return _sum64(dy1), _sum64(dy1.double() * e["xhat1"]), _sum64(du), dw2


def sa_train_bwd1(q, cterm, idx, mask, aff, w2, awin, gt):
    """Two layers: BN2's backward at every valid edge, its cotangent `gt`
    (B, C, C2) at each centroid's winner slot `awin` (B, C, C2) int32, then
    over the valid edges S1_1 = sum dy1 and S2_1 = sum dy1 * xhat1 (C1,),
    db2 = sum du (C2,) and dW2 = sum y1 du^T (C1, C2). aff rows a1, c1, b2,
    gos2, m2, inv_s2, s1n2, s2n2, m1, inv_s1."""
    name = "sa_train_bwd1"
    _expect(w2 is not None, name, "runs with two layers only")
    b, n, c, k, ch1, ch2 = _sa_check(name, q, cterm, idx, mask, aff, w2, awin, gt)
    if not _on_card(name, q, cterm, idx, mask, aff, w2, awin, gt):
        return sa_train_bwd1_plain(q, cterm, idx, mask, aff, w2, awin, gt)
    grid = _sa_grid(name, aff, b, c, ch1, ch2, True)
    partial = torch.empty((grid, 3 + ch1, ch2), dtype=torch.float32, device=q.device)
    _launch(name, q.device, q, cterm, idx, mask, aff, w2, awin, gt, partial,
            grid, b, n, c, k, ch1)
    s = partial.sum(0)
    return s[0], s[1], s[2], s[3:]


def sa_train_bwd2_plain(q, cterm, idx, mask, aff, w2, awin, gt):
    e = sa_train_edges(q, cterm, idx, mask, aff, w2, awin, gt)
    de0 = e["de0"]
    b, n, ch1 = q.shape
    flat = (idx.long() + (torch.arange(b, device=q.device) * n)[:, None, None]).reshape(-1)
    dq = torch.zeros((b * n, ch1), dtype=torch.float64, device=q.device)
    dq.index_add_(0, flat, de0.reshape(-1, ch1).double())
    return dq.float().reshape(b, n, ch1), -_sum64(de0, dims=2)


def sa_train_dq_ordered_plain(de: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                              n: int) -> torch.Tensor:
    """dq (B, N, C1) as csrc/sa_train.cu's dq pass sums the edge buffer de
    (B, C x K, C1): each point's row is 0 plus the rows of the valid edges
    that picked it, in increasing edge order c x K + j, each add rounded
    once (`knn_scatter_ordered_plain` in one round of one chunk)."""
    b, c, k = idx.shape
    ids = torch.where(mask, idx, -1).reshape(b, 1, c * k)
    return knn_scatter_ordered_plain(ids, None, de, n, pairs=c * k, chunk=c * k)


def sa_train_dq_plan(b: int, n: int, c: int, k: int):
    """csrc/sa_train.cu's dq pass for b clouds of n points, c centroids and
    k slots (groups of g = ceil(n / k) points): None when a block holds a
    group whole, its c centroids' keys and lists, the eight warps' counts
    and the starts (2 c + 9 g + 1 ints), as at every PROD shape (the PROD
    instance, grid (k, b)); else the windowed instance's (gp, lcap): W
    windows of gp points a group, W the most that keep the grid within one
    wave of two blocks an SM (k b W <= SA_DQ_WAVE; every window re-reads its
    group's c keys, and a block of a second wave costs as much as one of
    the first), at least 1, and raised until a window's counts and starts
    (9 gp + 1 ints) take at most a quarter of a block's shared memory; lcap,
    the list entries a block holds, at most c (a window's lists hold at
    most one entry a centroid) and what leaves two blocks' shared memory
    within an SM's (SA_DQ_PAIR_INTS)."""
    g = -(-n // k)
    if 2 * c + 9 * g + 1 <= SA_DQ_INTS:
        return None
    gp_max = (SA_DQ_INTS // 4 - 1) // 9
    w = max(1, SA_DQ_WAVE // (k * b), -(-g // gp_max))
    gp = -(-g // w)
    return gp, min(c, SA_DQ_PAIR_INTS - 9 * gp - 1)


def sa_train_bwd2(q, cterm, idx, mask, aff, w2, awin, gt, edges: bool = False):
    """BN1's backward at every valid edge through relu(e0): de0, from dy1 =
    BN2's backward @ W2^T with two layers (aff rows as `sa_train_bwd1`) or
    gt at the winner slot with one; aff rows m1, inv_s1, gos1, s1n1, s2n1.
    Returns dq (B, N, C1), the scatter of de0 onto the picked points, and
    dcterm = -sum_k de0 (B, C, C1); with `edges`, also the edge buffer of
    de0 (B, C x K, C1), 0 on a masked slot. On the card one launch runs two
    kernels: the edge pass writes that buffer and dcterm, and the dq pass
    sums the buffer into dq in one fixed order
    (`sa_train_dq_ordered_plain`), so two runs give the same bits. The dq
    pass takes idx from the grouped selection (`ball_query`): slot j picks
    only points of group j, the ceil(N/K) points from j x ceil(N/K); past
    its shared memory a block takes a window of a group's points
    (`sa_train_dq_plan`), in the same order of sums."""
    name = "sa_train_bwd2"
    b, n, c, k, ch1, ch2 = _sa_check(name, q, cterm, idx, mask, aff, w2, awin, gt)
    if not _on_card(name, q, cterm, idx, mask, aff, w2, awin, gt):
        dq, dcterm = sa_train_bwd2_plain(q, cterm, idx, mask, aff, w2, awin, gt)
        if not edges:
            return dq, dcterm
        de0 = sa_train_edges(q, cterm, idx, mask, aff, w2, awin, gt)["de0"]
        return dq, dcterm, de0.reshape(b, c * k, ch1)
    two = w2 is not None
    grid = _sa_grid(name, aff, b, c, ch1, ch2, two)
    de = torch.empty((b, c * k, ch1), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, n, ch1), dtype=torch.float32, device=q.device)
    dcterm = torch.empty((b, c, ch1), dtype=torch.float32, device=q.device)
    plan = sa_train_dq_plan(b, n, c, k)
    keys = lists = None
    gp, lcap = plan or (0, 0)  # read only by the windowed instance
    if plan is not None:  # the windowed dq pass: its keys, and lists past its shared memory
        _expect(b < 65536, name, "the windowed dq pass takes at most 65535 clouds")
        keys = torch.empty((b, k, c), dtype=torch.int32, device=q.device)
        if lcap < c:
            lists = torch.empty((b, k, c), dtype=torch.int32, device=q.device)
    _launch(name, q.device, q, cterm, idx, mask, aff, w2, awin, gt, de, dq, dcterm, keys, lists,
            grid, b, n, c, k, ch1, int(two), gp, lcap,
            path=None if plan is None else "sa_train_dq_chunked")
    return (dq, dcterm, de) if edges else (dq, dcterm)
