"""The CUDA kernels of the serve and train paths, each beside its plain
PyTorch version (counterpart of `stratanet2_tpu/ops/pallas_kernels.py`).

| wrapper          | CUDA source             | replaces (pallas_kernels.py)         |
|------------------|-------------------------|--------------------------------------|
| `fps`            | csrc/fps.cu             | `_fps_kernel` / `fps_pallas_batched` |
| `sa_fused_eval`  | csrc/sa_fused_eval.cu   | `_sa_kernel` / `sa_fused_eval`       |
| `knn_interpolate`| csrc/knn_interpolate.cu | `_knn_kernel` / `_knn_pallas_raw`    |
| `pixel_max`      | csrc/pixel_max.cu       | `_pixel_max_kernel` / `pixel_max_pallas` (forward) |
| `ball_query`     | csrc/ball_query.cu      | `_bq_kernel` / `ball_query_grouped_pallas` |
| `knn_scatter`    | csrc/knn_scatter.cu     | `_knn_scatter_kernel` / `_knn_scatter_pallas`, `scatter_add_pallas` |
| `pixel_max_bwd`  | csrc/pixel_max.cu       | `_pixel_max_bwd_kernel` / `_pixel_max_bwd` |
| `sa_train_stats` | csrc/sa_train.cu        | `_sa_stats1_kernel` / `_sa_train_stats` |
| `sa_train_main`  | csrc/sa_train.cu        | `_sa_train_main_kernel` / `_sa_train_main` |
| `sa_train_bwd1`  | csrc/sa_train.cu        | `_sa_train_bwd1_kernel` / `_sa_train_bwd1` |
| `sa_train_bwd2`  | csrc/sa_train.cu        | `_sa_train_bwd2_kernel` / `_sa_train_bwd2` |
| `ball_query_nearest` | csrc/ball_query_nearest.cu (grid pass + query, one count) | no Pallas kernel: the XLA `approx_min_k` of `ballquery.py::_ball_query_single` |

Dispatch: a wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it runs the plain version. There is no fallback between the two
and no switch. `LAUNCHES[name]` counts each wrapper's kernel launches.

Five wrappers take another path for shapes past their PROD kernels' reach,
chosen by shape alone (`fps_path`, `sel_chunk`, `pixel_max_range`,
`sa_train_dq_chunks`), and count it in `PATH_LAUNCHES` too: FPS rows over
16,384 points run a block cluster a row (`fps_cluster`, and past 131,072
points `fps_global`, its running minima in device memory); a selection
group longer than a warp's staging slice streams through it in chunks
(`ball_query_chunked`, `sa_fused_eval_chunked`); a pixel table past shared
memory is cut into pixel ranges, a cluster each (`pixel_max_ranges`);
sa_train_bwd2's dq pass walks a group whose lists outgrow shared memory in
windows (`sa_train_dq_chunked`). Every PROD shape keeps its kernels.

Every selection distance is rounded as the JAX CPU path rounds it (see
`distance.py`): the plain versions and the kernels agree with it, and with
each other, on every distance and so on every selected index. The SA train
passes likewise compute every per-edge value in the same rounding as their
kernels (`sa_train_edges`), so winner slots agree exactly.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

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
_SMEM_MAX = 227 * 1024  # opt-in dynamic shared memory of one H100 block
# csrc/knn_scatter.cu: pairs a round and contributions a chunk (kW, kL: they
# set the order of its sums), and the widest F whose accumulators fit in
# shared memory
KNN_SCATTER_PAIRS, KNN_SCATTER_CHUNK = 8192, 64
KNN_SCATTER_MAX_F = 128
PIXEL_MAX_CLUSTER = 8  # csrc/pixel_max.cu: blocks of a cloud's cluster (kCS)
PIXEL_MAX_TABLE = _SMEM_MAX // 8  # 64-bit keys (pixel x channel slots) a block's table holds
FPS_MAX_N = 16 * 1024  # csrc/fps.cu's fps_kernel: at most 16 points for each of 1024 threads
FPS_CLUSTER_MAX = 8  # fps_cluster_kernel: blocks a row at most (the portable cluster size)
# csrc/common.cuh's grouped selection: 8 warps a block each stage up to one
# group of g points as float4, for a tile of 64 centroids
SEL_WARPS, SEL_TILE = 8, 64
BQ_MAX_G = _SMEM_MAX // (16 * SEL_WARPS)  # ball_query: the longest group staged whole
SA_DQ_INTS = _SMEM_MAX // 4  # csrc/sa_train.cu's dq pass: int32 lists and counts a block holds
NEAREST_MAX_K = 128  # csrc/ball_query_nearest.cu: the longest sorted list a warp keeps (kNearMaxK)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {  # entry: (library = csrc/<library>.cu, C entry point, its arguments)
    "fps": ("fps", "fps_launch", [_VP, _VP, _VP, _I, _I, _I, _VP]),
    "sa_fused_eval": (
        "sa_fused_eval", "sa_fused_eval_launch",
        [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _VP],
    ),
    "knn_interpolate": (
        "knn_interpolate", "knn_interpolate_launch",
        [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    ),
    "pixel_max": ("pixel_max", "pixel_max_launch", [_VP] * 4 + [_I] * 5 + [_VP]),
    "ball_query": (
        "ball_query", "ball_query_launch", [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _F, _VP]
    ),
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
        "sa_train", "sa_train_bwd2_launch", [_VP] * 11 + [_I] * 9 + [_VP]
    ),
    "ball_query_nearest": (
        "ball_query_nearest", "ball_query_nearest_launch", [_VP] * 5 + [_I] * 5 + [_F, _VP]
    ),
    # the long-shape paths' own entry points (see the module's docstring)
    "fps_cluster": ("fps", "fps_cluster_launch", [_VP] * 4 + [_I] * 4 + [_VP]),
}
WRAPPERS = ("fps", "sa_fused_eval", "knn_interpolate", "pixel_max", "ball_query", "knn_scatter",
            "pixel_max_bwd", "sa_train_stats", "sa_train_main", "sa_train_bwd1", "sa_train_bwd2",
            "ball_query_nearest")
PATHS = ("fps_cluster", "fps_global", "ball_query_chunked", "sa_fused_eval_chunked",
         "pixel_max_ranges", "sa_train_dq_chunked")
_fns: Dict[str, ctypes._CFuncPtr] = {}
# kernel launches per wrapper, and per long-shape path, counted where the
# launch succeeds
LAUNCHES: Dict[str, int] = dict.fromkeys(WRAPPERS, 0)
PATH_LAUNCHES: Dict[str, int] = dict.fromkeys(PATHS, 0)


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
    for counts in (LAUNCHES, PATH_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def path_launch_counts() -> Dict[str, int]:
    return dict(PATH_LAUNCHES)


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


def fps_path(n: int):
    """csrc/fps.cu's path for rows of n points, as (path, blocks a row):
    ("block", 1), fps_kernel, up to FPS_MAX_N points; ("cluster", cs), a
    cluster of cs blocks, the least power of two up to FPS_CLUSTER_MAX with
    cs x FPS_MAX_N >= n, each block's slice in shared memory; past that
    ("global", FPS_CLUSTER_MAX), the cluster with x, y, z read from device
    memory and the running minima in a device-memory scratch."""
    if n <= FPS_MAX_N:
        return "block", 1
    cs = 2
    while cs < FPS_CLUSTER_MAX and cs * FPS_MAX_N < n:
        cs *= 2
    return ("cluster" if cs * FPS_MAX_N >= n else "global"), cs


def fps(xyz: torch.Tensor, n_samples: int, start: torch.Tensor) -> torch.Tensor:
    """Farthest point sampling per row: (R, N, 3) float32 points, (R,) int32
    start indices -> (R, n_samples) int32 indices, out[:, 0] == start."""
    name = "fps"
    _expect(xyz.dim() == 3 and xyz.shape[2] == 3, name, "xyz must be (R, N, 3)")
    _expect(xyz.dtype == torch.float32, name, "xyz must be float32")
    _expect(start.shape == (xyz.shape[0],) and start.dtype == torch.int32,
            name, "start must be (R,) int32")
    _expect(1 <= n_samples <= xyz.shape[1], name, "need 1 <= n_samples <= N")
    if not _on_card(name, xyz, start):
        return fps_plain(xyz, n_samples, start)
    r, n, _ = xyz.shape
    _expect(n < 2 ** 31, name, f"N={n}: indices are int32")
    out = torch.empty((r, n_samples), dtype=torch.int32, device=xyz.device)
    path, cs = fps_path(n)
    if path == "block":
        _launch(name, xyz.device, xyz, start, out, r, n, n_samples)
        return out
    _expect(r * cs < 2 ** 31, name, f"{r} rows of {cs} blocks exceed the grid")
    # the global path's running minima: a device-memory row of N floats a row
    md = torch.empty((r, n), dtype=torch.float32, device=xyz.device) if path == "global" else None
    _launch(name, xyz.device, xyz, start, out, md, r, n, n_samples, cs,
            entry="fps_cluster", path=f"fps_{path}")
    return out


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


def sa_fused_eval_max_g(ch1: int, ch2: int, two: bool, k: int) -> int:
    """The longest group the SA eval kernel stages whole: its block holds
    SEL_WARPS staging slices (16 B a point), the parameters padded to float4
    and a (SEL_TILE, K) int32 table of picks in shared memory."""
    n_prm = 2 * ch1 + (ch1 * ch2 + 3 * ch2 if two else 0)
    return (_SMEM_MAX - 4 * (-(-n_prm // 4) * 4) - 4 * SEL_TILE * k) // (16 * SEL_WARPS)


def sel_chunk(g: int, max_g: int) -> int:
    """Points a warp of csrc/common.cuh's select_tile stages at once for
    groups of g points, when a warp's slice of shared memory holds max_g
    (BQ_MAX_G, or sa_fused_eval_max_g of the instance): the whole group
    when it fits (one pass), else chunks of max_g in index order."""
    return min(g, max_g)


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
    g = -(-n // k)
    gc = sel_chunk(g, sa_fused_eval_max_g(ch1, ch2, two, k))
    _expect(gc >= 1, name, f"K={k} leaves no shared memory to stage points in")
    prm = torch.cat([v.reshape(-1) for v in vecs])
    out = torch.empty((b, c, ch2), dtype=torch.float32, device=q.device)
    _launch(name, q.device, q, xyz, centroids, cterm, prm, out,
            b, n, c, k, g, gc, ch1, ch2, int(two), radius_sq(radius),
            path="sa_fused_eval_chunked" if gc < g else None)
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


def knn_interpolate(x_src: torch.Tensor, pos_src: torch.Tensor, pos_tgt: torch.Tensor):
    """Exact 3-NN inverse-d^2 interpolation: x_src (B, S, F), pos_src
    (B, S, 3), pos_tgt (B, T, 3) -> out (B, T, F), idx (B, 3, T) int32 and
    normalised weights (B, 3, T) (kept for the backward of the train slice).
    Ties go to the lowest source index."""
    name = "knn_interpolate"
    b, s, f = x_src.shape
    t = pos_tgt.shape[1]
    _expect(pos_src.shape == (b, s, 3) and pos_tgt.shape == (b, t, 3), name,
            "positions must be (B, S, 3) and (B, T, 3)")
    _expect(s >= 3, name, "need at least 3 source points")
    for x in (x_src, pos_src, pos_tgt):
        _expect(x.dtype == torch.float32, name, "all inputs must be float32")
    if not _on_card(name, x_src, pos_src, pos_tgt):
        return knn_interpolate_plain(x_src, pos_src, pos_tgt)
    _expect(b < 65536, name, "the kernel takes at most 65535 clouds")
    out = torch.empty((b, t, f), dtype=torch.float32, device=x_src.device)
    idx = torch.empty((b, 3, t), dtype=torch.int32, device=x_src.device)
    w = torch.empty((b, 3, t), dtype=torch.float32, device=x_src.device)
    _launch(name, x_src.device, x_src, pos_src, pos_tgt, out, idx, w, b, s, t, f,
            knn_slices(b, t))
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
    the fewest ranges of at most PIXEL_MAX_TABLE // c pixels, cut evenly
    (the last may hold fewer)."""
    ranges = -(-n_pix // (PIXEL_MAX_TABLE // c))
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
    gc = sel_chunk(g, BQ_MAX_G)
    _expect(b < 65536, name, "the kernel takes at most 65535 clouds")
    idx = torch.empty((b, c, k), dtype=torch.int32, device=points.device)
    mask = torch.empty((b, c, k), dtype=torch.bool, device=points.device)
    _launch(name, points.device, centroids, points, idx, mask, b, n, c, k, g, gc,
            radius_sq(radius), path="ball_query_chunked" if gc < g else None)
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
    b, n, _ = points.shape
    g, layout = _nearest_layout(b, n, centroids.shape[1])
    parts = dict(zip(layout, torch.split(ws, [math.prod(s) for s in layout.values()])))
    views = {key: parts[key].view(shape) for key, shape in layout.items()}
    prm = views["params"]
    fl = prm[:, :4].view(torch.float32)
    grid = dict(xmin=fl[:, 0], ymin=fl[:, 1], inv_h=fl[:, 2], rc2=fl[:, 3],
                gx=prm[:, 4].long(), gy=prm[:, 5].long(), starts=views["starts"].long(),
                sorted_idx=views["sidx"].long(), cent_order=views["corder"].long(),
                sorted_pts=views["spts"].view(torch.float32))
    return idx, mask, grid


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
    mask and the workspace (`_nearest_layout`)."""
    b, c, _ = centroids.shape
    n = points.shape[1]
    idx = torch.empty((b, c, k), dtype=torch.int32, device=points.device)
    mask = torch.empty((b, c, k), dtype=torch.bool, device=points.device)
    ws, g = _nearest_workspace(b, n, c, points.device)
    _launch("ball_query_nearest", points.device, centroids, points, idx, mask, ws, b, n, c, k,
            g, radius_sq(radius))
    return idx, mask, ws


def _nearest_layout(b: int, n: int, c: int):
    """g = `ballquery.nearest_grid_side(N)`, from the shapes alone, and the
    int32 parts of the nearest kernel's workspace in the order of
    csrc/ball_query_nearest.cu's `carve`, by name and shape: spts (B, N, 4)
    (float4 [x, y, z, |p|^2]), sidx (B, N), starts (B, g^2 + 1), corder
    (B, C) and params (B, 6)."""
    g = ballquery.nearest_grid_side(n)
    return g, {"spts": (b, n, 4), "sidx": (b, n), "starts": (b, g * g + 1), "corder": (b, c),
               "params": (b, 6)}


def _nearest_workspace(b: int, n: int, c: int, device: torch.device):
    """The nearest kernel's workspace (`_nearest_layout`) as one int32
    tensor, and g."""
    g, layout = _nearest_layout(b, n, c)
    size = sum(math.prod(s) for s in layout.values())
    return torch.empty(size, dtype=torch.int32, device=device), g


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


def sa_train_dq_chunks(n: int, c: int, k: int):
    """(points, centroids) of a window of csrc/sa_train.cu's dq pass for
    groups of g = ceil(n / k) points and c centroids: (g, c), one window,
    when a block's shared memory holds the keys and lists (c ints each), the
    eight warps' counts and the starts (9 g + 1 ints), as at every PROD
    shape; else windows of at most half of it in counts and starts, and
    the centroids in the rest."""
    g = -(-n // k)
    if 2 * c + 9 * g + 1 <= SA_DQ_INTS:
        return g, c
    gp = min(g, (SA_DQ_INTS // 2 - 1) // 9)
    return gp, min(c, (SA_DQ_INTS - 9 * gp - 1) // 2)


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
    its shared memory it walks a group in windows (`sa_train_dq_chunks`),
    in the same order of sums."""
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
    gp, cc = sa_train_dq_chunks(n, c, k)
    _launch(name, q.device, q, cterm, idx, mask, aff, w2, awin, gt, de, dq, dcterm,
            grid, b, n, c, k, ch1, int(two), gp, cc,
            path="sa_train_dq_chunked" if (gp, cc) != (-(-n // k), c) else None)
    return (dq, dcterm, de) if edges else (dq, dcterm)
