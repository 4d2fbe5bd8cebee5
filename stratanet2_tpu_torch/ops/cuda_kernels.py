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

Dispatch: a wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it runs the plain version. There is no fallback between the two
and no switch. `LAUNCHES[name]` counts each wrapper's kernel launches.

Every selection distance is rounded as the JAX CPU path rounds it (see
`distance.py`): the plain versions and the kernels agree with it, and with
each other, on every distance and so on every selected index.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from stratanet2_tpu_torch.ops import _build
from stratanet2_tpu_torch.ops.ballquery import ball_query_grouped, radius_sq
from stratanet2_tpu_torch.ops.distance import expanded_d2, fma_f32, sq_norm3

NEG = -3.4e38  # the empty-pixel / masked-edge value of the Pallas kernels
_KNN_EPS = 1e-16
_KNN_CHUNK = 512  # targets per (B, chunk, S) distance tile of the plain kNN
_SMEM_MAX = 227 * 1024  # opt-in dynamic shared memory of one H100 block

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {  # wrapper: (library = csrc/<library>.cu, C entry point, its arguments)
    "fps": ("fps", "fps_launch", [_VP, _VP, _VP, _I, _I, _I, _VP]),
    "sa_fused_eval": (
        "sa_fused_eval", "sa_fused_eval_launch",
        [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _F, _VP],
    ),
    "knn_interpolate": (
        "knn_interpolate", "knn_interpolate_launch",
        [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    ),
    "pixel_max": (
        "pixel_max", "pixel_max_launch", [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP]
    ),
    "ball_query": (
        "ball_query", "ball_query_launch", [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP]
    ),
    "knn_scatter": (
        "knn_scatter", "knn_scatter_launch", [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP]
    ),
    "pixel_max_bwd": (
        "pixel_max", "pixel_max_bwd_launch", [_VP, _VP, _VP, _I, _I, _I, _I, _VP]
    ),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}
# kernel launches per wrapper, counted where the launch succeeds
LAUNCHES: Dict[str, int] = dict.fromkeys(_ENTRIES, 0)


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel `name`'s C entry point on `device`'s current stream.
    Tensors pass as their data pointers; the entry returns
    cudaGetLastError() after its launches, and a non-zero code raises."""
    library, symbol, argtypes = _ENTRIES[name]
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load(library)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]  # None: NULL
    with torch.cuda.device(device):
        rc = fn(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = _build.load(library).error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
    LAUNCHES[name] += 1


def _on_card(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors (all contiguous, one device), False for CPU
    tensors; raises on anything else. None entries (absent optional
    inputs) are skipped."""
    tensors = tuple(t for t in tensors if t is not None)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
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
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


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
    _expect(16 * n <= _SMEM_MAX, name, f"N={n} exceeds the block's shared memory")
    out = torch.empty((r, n_samples), dtype=torch.int32, device=xyz.device)
    _launch(name, xyz.device, xyz, start, out, r, n, n_samples)
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
    g = -(-n // k)
    n_prm = 2 * ch1 + (ch1 * ch2 + 3 * ch2 if two else 0)
    _expect(4 * (n_prm + g * (ch1 + 5)) <= _SMEM_MAX, name,
            f"group of {g} points exceeds the block's shared memory")
    prm = torch.cat([v.reshape(-1) for v in vecs])
    out = torch.empty((b, c, ch2), dtype=torch.float32, device=q.device)
    _launch(name, q.device, q, xyz, centroids, cterm, prm, out,
            b, n, c, k, g, ch1, ch2, int(two), radius_sq(radius))
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
    for t0 in range(0, pos_tgt.shape[1], _KNN_CHUNK):
        t = pos_tgt[:, t0 : t0 + _KNN_CHUNK]
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
    out = torch.empty((b, t, f), dtype=torch.float32, device=x_src.device)
    idx = torch.empty((b, 3, t), dtype=torch.int32, device=x_src.device)
    w = torch.empty((b, 3, t), dtype=torch.float32, device=x_src.device)
    _launch(name, x_src.device, x_src, pos_src, pos_tgt, out, idx, w, b, s, t, f)
    return out, idx, w


# ---------------------------------------------------------------------------
# per-pixel max and its backward
# ---------------------------------------------------------------------------


def pixel_max_plain(pix: torch.Tensor, vals: torch.Tensor, n_pix: int):
    """Dense masked max over an explicit (B, P, N) pixel-membership mask, as
    the JAX CPU path of ops/projection.py does; argmax takes the first
    maximum. Ids outside [0, n_pix) match no pixel."""
    seg = torch.arange(n_pix, device=pix.device, dtype=pix.dtype)
    member = pix[:, None, :] == seg[None, :, None]  # (B, P, N)
    occ = torch.any(member, dim=-1, keepdim=True)
    vmax, amax = [], []
    for ch in range(vals.shape[-1]):
        e = torch.where(member, vals[:, None, :, ch], torch.tensor(NEG, device=vals.device))
        vmax.append(torch.amax(e, dim=-1))
        amax.append(torch.argmax(e, dim=-1))
    vmax = torch.where(occ, torch.stack(vmax, -1), torch.tensor(NEG, device=vals.device))
    amax = torch.where(occ, torch.stack(amax, -1), -1).int()
    return vmax, amax


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
    _expect(8 * n_pix * c <= _SMEM_MAX, name, "pixel table exceeds shared memory")
    keys = torch.empty((b, n_pix, c), dtype=torch.int64, device=vals.device)
    vmax = torch.empty((b, n_pix, c), dtype=torch.float32, device=vals.device)
    amax = torch.empty((b, n_pix, c), dtype=torch.int32, device=vals.device)
    _launch(name, vals.device, pix, vals, keys, vmax, amax, b, n, n_pix, c)
    return vmax, amax


def pixel_max_bwd_plain(amax: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """dv (B, n, C): each pixel's cotangent stored at its winning point,
    zero elsewhere (an indexed store; winners are unique per channel)."""
    b, _, c = g.shape
    dv = torch.zeros((b, n, c), dtype=g.dtype, device=g.device)
    hit = (amax >= 0) & (amax < n)
    bi, _, ci = torch.nonzero(hit, as_tuple=True)
    dv[bi, amax[hit].long(), ci] = g[hit]
    return dv


def pixel_max_bwd(amax: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """Backward of `pixel_max` in its values: amax (B, P, C) int32 winners
    (-1 where empty), g (B, P, C) float32 cotangents of vmax -> dv (B, n, C)
    float32 with g[b, p, ch] at point amax[b, p, ch] of channel ch."""
    name = "pixel_max_bwd"
    b, p, c = g.shape
    _expect(amax.shape == (b, p, c) and amax.dtype == torch.int32, name,
            "amax must be (B, P, C) int32, the shape of g")
    _expect(g.dtype == torch.float32, name, "g must be float32")
    _expect(b >= 1 and p >= 1 and c >= 1 and n >= 1, name, "empty input")
    if not _on_card(name, amax, g):
        return pixel_max_bwd_plain(amax, g, n)
    dv = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    _launch(name, g.device, amax, g, dv, b, n, p, c)
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
    _expect(16 * g <= _SMEM_MAX, name, f"group of {g} points exceeds the block's shared memory")
    idx = torch.empty((b, c, k), dtype=torch.int32, device=points.device)
    mask = torch.empty((b, c, k), dtype=torch.bool, device=points.device)
    _launch(name, points.device, centroids, points, idx, mask, b, n, c, k, g,
            radius_sq(radius))
    return idx, mask


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


def knn_scatter(idx: torch.Tensor, w: Optional[torch.Tensor], g: torch.Tensor, s: int):
    """Weighted scatter-add into S rows: idx (B, k, T) int32 in [0, S),
    w (B, k, T) float32 or None (all ones), g (B, T, F) float32 -> dx
    (B, S, F) with dx[b, idx[b, j, t]] += w[b, j, t] * g[b, t]. The backward
    of `knn_interpolate` (k=3, its normalised weights) and of `gather_rows`
    (k=1, no weights). On the card the sum order is not fixed (atomics)."""
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
    dx = torch.empty((b, s, f), dtype=torch.float32, device=g.device)
    _launch(name, g.device, idx, w, g, dx, b, k, t, s, f)
    return dx
