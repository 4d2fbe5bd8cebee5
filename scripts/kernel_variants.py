#!/usr/bin/env python3
"""Time design variants of a PyTorch-port kernel on one CUDA card (an H100).

Each SOURCE is a copy of `stratanet2_tpu_torch/ops/csrc/<library>.cu` with
another design behind the same C entry point, or such a file followed by
`@name=value,...`: a copy with those `constexpr int` constants set (written to
the git-ignored build/variant_src/). The script builds every source
at once with the port's nvcc flags (`ops/_build.py`), prints each kernel's
registers and spills (`cuobjdump -res-usage`) and, for sa_train.cu, the SASS,
SHFLs and FP32 instructions an edge of each batched slot loop (chip_smoke.py's
`sass_edge_loops`), then runs the entry point at the PROD step shapes (B=20 x
N=10000: kNN's FP1 and FP2; the SA train passes' SA1 and SA2, stats and bwd1
SA1 only, on ball-query picks of a synthetic cloud) against the plain PyTorch
version and prints one JSON line a source and site: the error against the
plain version (for sa_train_main the winners that differ) and the CUDA-event
time of one launch (mean of 20, after a warm-up); for sa_train_stats also
the device time a launch and whether two launches agree bit for bit. kNN runs every slice count the
entry takes (1, 2, 4, 8). knn_scatter runs at the train step's FP1 and FP2
sites (kNN picks of synthetic plots) and at the k = 1 gather site (20% of the
pairs on row 0); pixel_max at the serve step's site (1 m pixels of synthetic
20 m plots). Both also print the device time and the device operations of a
launch (torch.profiler), whether two launches agree bit for bit and, for a
scatter whose source sets its round and chunk (kW, kL), whether it equals
`knn_scatter_ordered_plain` bit for bit; a pixel_max source whose entry
still takes a key scratch (the parent's design) gets one.

    python3 scripts/kernel_variants.py knn_interpolate a.cu b.cu
    python3 scripts/kernel_variants.py sa_train_main stratanet2_tpu_torch/ops/csrc/sa_train.cu x.cu
    python3 scripts/kernel_variants.py knn_scatter stratanet2_tpu_torch/ops/csrc/knn_scatter.cu \
        stratanet2_tpu_torch/ops/csrc/knn_scatter.cu@kTS=32,kL=128

ball_query_nearest runs at the nearest serve step's SA1 and SA2 sites (FPS
centroids of synthetic plots) and at SA1's shape on a clustered cloud. A
SOURCE named twice runs once; a setting that changes nothing makes a second
copy, to run them in turns:

    python3 scripts/kernel_variants.py ball_query_nearest \
        stratanet2_tpu_torch/ops/csrc/ball_query_nearest.cu \
        stratanet2_tpu_torch/ops/csrc/ball_query_nearest.cu@kNearBuf=32

fps runs the long rows' designs (see `run_fps`):

    python3 scripts/kernel_variants.py fps scripts/variants/fps_one_block.cu

Kernels: knn_interpolate, sa_train_stats, sa_train_main, sa_train_bwd1, sa_train_bwd2,
knn_scatter, pixel_max, ball_query_nearest, fps.

Builds go to the git-ignored build/variants/. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its SASS parsers)

SEED = 0
REPS = 20


def source_file(spec: str) -> Path:
    """The file of a SOURCE: `path`, or `path@name=value,...`, a copy of
    path with those `constexpr int` constants set."""
    path, _, sets = spec.partition("@")
    if not sets:
        return Path(path)
    text = Path(path).read_text()
    for item in sets.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"{spec}: constant {name} not found once in {path}")
    out = ROOT / "build" / "variant_src" / f"{Path(path).stem}_{sets.replace('=', '').replace(',', '_')}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def build(sources):
    """{source: loaded library}; each source compiled by its own nvcc."""
    from stratanet2_tpu_torch.ops import _build

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for i, src in enumerate(sources):
        lib = out_dir / f"{i}_{Path(src.partition('@')[0]).stem}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               str(source_file(src))]
        procs[src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
        usage = subprocess.run([str(cuobjdump), "-res-usage", str(lib)], capture_output=True,
                               text=True, check=True).stdout
        print(json.dumps({"source": str(src), "resource_usage": " ".join(usage.split())}),
              flush=True)
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        libs[src] = ctypes.CDLL(str(lib))
        loops = chip_smoke.sass_edge_loops(sass, lambda ch: stats_lanes(libs[src], ch))
        if loops:  # empty but for sa_train.cu
            print(json.dumps({"source": str(src), "edge_loops": {
                f: v and {key: v[key] for key in ("kernel", "C1", "lanes", "KB", "per_edge",
                                                  "shfl_per_edge", "fp32_per_edge")}
                for f, v in loops.items()}}), flush=True)
    return libs


def event_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def plot_clouds(torch, gen, b, n, device):
    """(B, N, 3) synthetic 20 m plots, z up to 3 m (utils/synthetic.py)."""
    return torch.cat([torch.rand((b, n, 2), generator=gen, device=device) * 20 - 10,
                      torch.rand((b, n, 1), generator=gen, device=device) * 3], -1)


def run_knn(torch, ck, libs, gen, device):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, s, t, f in (("FP1", 2500, 10000, 34), ("FP2", 625, 2500, 64)):
        b = 20
        pt = plot_clouds(torch, gen, b, t, device)
        ps = pt[:, torch.randperm(t, generator=gen, device=device)[:s]].contiguous()
        x = torch.randn((b, s, f), generator=gen, device=device)
        want_out, want_idx, want_w = ck.knn_interpolate_plain(x, ps, pt)
        for src, lib in libs.items():
            fn = lib.knn_interpolate_launch
            fn.argtypes = [vp] * 6 + [i32] * 5 + [vp]
            fn.restype = i32
            for slices in (1, 2, 4, 8):
                out = torch.empty((b, t, f), device=device)
                idx = torch.empty((b, 3, t), dtype=torch.int32, device=device)
                w = torch.empty((b, 3, t), device=device)
                args = [x.data_ptr(), ps.data_ptr(), pt.data_ptr(), out.data_ptr(), idx.data_ptr(),
                        w.data_ptr(), b, s, t, f, slices, stream]
                rc = fn(*args)
                torch.cuda.synchronize()
                print(json.dumps({
                    "source": str(src), "site": site, "slices": slices, "rc": rc,
                    "differing_indices": int((idx != want_idx).sum()),
                    "max_abs_diff": max(float((out - want_out).abs().max()),
                                        float((w - want_w).abs().max())),
                    "ms": event_ms(torch, lambda: fn(*args)),
                }), flush=True)


def sa_sites(torch, ck, gen, device, two_layer_only=False):
    """The SA train passes' PROD sites, (site, b, n, c, k, ch, args) with
    args = (q, cterm, idx, mask, aff, w2, awin, gt): SA1 (16 channels, two
    layers, K=32) and SA2 (32, one layer, K=64) on ball-query picks of a
    synthetic cloud, BN terms and W2 drawn from `gen`."""
    pts = plot_clouds(torch, gen, 20, 10000, device)
    for site, n, c, k, radius, ch in (("SA1", 10000, 2500, 32, 2 ** 0.5, 16),
                                      ("SA2", 2500, 625, 64, 8 ** 0.5, 32)):
        b, two = 20, ch == 16
        if two_layer_only and not two:
            continue
        xyz = pts[:, :n].contiguous()
        idx, mask = ck.ball_query_plain(xyz[:, :c].contiguous(), xyz, radius, k)

        def rnd(*shape, scale=1.0, shift=0.0, uniform=False):
            draw = torch.rand if uniform else torch.randn
            return draw(shape, generator=gen, device=device) * scale + shift

        aff = ck.sa_aff(ch, a1=rnd(ch, uniform=True, shift=0.5), c1=rnd(ch, scale=0.1),
                        b2=rnd(ch, scale=0.1), gos2=rnd(ch, uniform=True, shift=0.5),
                        m2=rnd(ch, scale=0.1), inv_s2=rnd(ch, uniform=True, shift=0.5),
                        s1n2=rnd(ch, scale=0.01), s2n2=rnd(ch, scale=0.01), m1=rnd(ch, scale=0.1),
                        inv_s1=rnd(ch, uniform=True, shift=0.5),
                        gos1=rnd(ch, uniform=True, shift=0.5), s1n1=rnd(ch, scale=0.01),
                        s2n1=rnd(ch, scale=0.01), shift1=rnd(ch, scale=0.1),
                        shift_l=rnd(ch, scale=0.1)).contiguous()
        args = (rnd(b, n, ch), rnd(b, c, ch, scale=0.5), idx, mask, aff,
                rnd(ch, ch, scale=0.25) if two else None,
                torch.randint(0, k, (b, c, ch), generator=gen, device=device, dtype=torch.int32),
                rnd(b, c, ch))
        yield site, b, n, c, k, ch, args


def entry(lib, symbol, n_ptrs, n_ints):
    """`symbol` of `lib` with n_ptrs pointers, n_ints ints and the stream."""
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ptrs(args):
    return [None if a is None else a.data_ptr() for a in args]


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def stats_lanes(lib, ch):
    """Lanes a centroid of a source's stats pass at ch channels: its
    library's `sa_train_stats_lanes`, or ch (a lane a channel) where the
    source exports none."""
    fn = getattr(lib, "sa_train_stats_lanes", None)
    return ch if fn is None else fn(ch)


def run_stats(torch, ck, libs, gen, device):
    """The stats pass at the train step's SA1 site: sums against the plain
    version, whether two launches agree bit for bit, and CUDA-event and
    device time a launch. The grid follows each source's lanes a centroid
    (`stats_lanes`)."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, b, n, c, k, ch, args in sa_sites(torch, ck, gen, device, two_layer_only=True):
        fwd = args[:5]
        want = ck.sa_train_stats_plain(*fwd)
        for src, lib in libs.items():
            consts = constants(src)
            lanes = stats_lanes(lib, ch)
            grid = ck.sa_grid(b, c, lanes)
            fn = entry(lib, "sa_train_stats_launch", 6, 6)
            parts = [torch.full((grid, 2, ch), float("nan"), device=device) for _ in range(2)]
            cargs = [ptrs(fwd) + [p.data_ptr(), grid, b, n, c, k, ch, stream] for p in parts]
            rc = fn(*cargs[0])
            fn(*cargs[1])
            torch.cuda.synchronize()
            sums = parts[0].sum(0)
            print(json.dumps({
                "source": str(src), "kernel": "sa_train_stats", "site": site, "rc": rc,
                **{name: consts[name] for name in ("kStatsV", "kStatsKB") if name in consts},
                "lanes": lanes, "grid": grid, "sum_rel_diff": rel(sums[0], want[0]),
                "sumsq_rel_diff": rel(sums[1], want[1]),
                "launches_equal": torch.equal(parts[0].view(torch.int32),
                                              parts[1].view(torch.int32)),
                "ms": event_ms(torch, lambda: fn(*cargs[0])),
                **device_cost(torch, lambda: fn(*cargs[0]), "sa_train_stats"),
            }), flush=True)


def run_main(torch, ck, libs, gen, device):
    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, b, n, c, k, ch, args in sa_sites(torch, ck, gen, device):
        two = ch == 16
        fwd = args[:6]
        want = ck.sa_train_main_plain(*fwd)
        grid = ck.sa_grid(b, c, ch)
        for src, lib in libs.items():
            fn = entry(lib, "sa_train_main_launch", 11, 7)
            partial = torch.empty((grid, 2, ch), device=device)
            outs = [torch.empty((b, c, ch), device=device, dtype=dt)
                    for dt in (torch.float32, torch.float32, torch.int32, torch.int32)]
            cargs = ptrs(fwd) + ptrs([partial, *outs]) + [grid, b, n, c, k, ch, int(two), stream]
            rc = fn(*cargs)
            torch.cuda.synchronize()
            sums = partial.sum(0)
            print(json.dumps({
                "source": str(src), "kernel": "sa_train_main", "site": site, "rc": rc,
                "differing_winners": sum(int((g != w).sum()) for g, w in zip(outs, want[2:])),
                "sum_rel_diff": rel(sums[0], want[0]), "sumsq_rel_diff": rel(sums[1], want[1]),
                "ms": event_ms(torch, lambda: fn(*cargs)),
            }), flush=True)


def run_bwd1(torch, ck, libs, gen, device):
    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, b, n, c, k, ch, args in sa_sites(torch, ck, gen, device, two_layer_only=True):
        want = ck.sa_train_bwd1_plain(*args)
        grid = ck.sa_grid(b, c, ch)
        for src, lib in libs.items():
            fn = entry(lib, "sa_train_bwd1_launch", 9, 6)
            partial = torch.empty((grid, 3 + ch, ch), device=device)
            cargs = ptrs(args) + [partial.data_ptr(), grid, b, n, c, k, ch, stream]
            rc = fn(*cargs)
            torch.cuda.synchronize()
            s = partial.sum(0)
            print(json.dumps({
                "source": str(src), "kernel": "sa_train_bwd1", "site": site, "rc": rc,
                **{f"{what}_rel_diff": rel(g, w) for what, g, w in
                   zip(("S1", "S2", "db2", "dW2"), (s[0], s[1], s[2], s[3:]), want)},
                "ms": event_ms(torch, lambda: fn(*cargs)),
            }), flush=True)


def run_bwd2(torch, ck, libs, gen, device):
    """The edge pass and the dq pass of one `sa_train_bwd2_launch`: dq and
    dcterm against the plain version, the edge buffer against the plain
    de0, dq bit for bit against `sa_train_dq_ordered_plain` of the buffer
    and two launches against each other, the CUDA-event ms of a launch and
    the device ms of each pass."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, b, n, c, k, ch, args in sa_sites(torch, ck, gen, device):
        want_dq, want_dct = ck.sa_train_bwd2_plain(*args)
        want_de = ck.sa_train_edges(*args)["de0"].reshape(b, c * k, ch)
        grid = ck.sa_grid(b, c, ch)
        for src, lib in libs.items():
            # a source whose dq pass takes windows (gp, cc) gets the wrapper's
            windows = re.search(r"sa_train_bwd2_launch\([^)]*int gp, int cc",
                                source_file(src).read_text()) is not None
            fn = entry(lib, "sa_train_bwd2_launch", 11, 9 if windows else 7)
            de = torch.empty((b, c * k, ch), device=device)
            dq = torch.empty((b, n, ch), device=device)
            dct = torch.empty((b, c, ch), device=device)
            cargs = ptrs(args) + [de.data_ptr(), dq.data_ptr(), dct.data_ptr(), grid, b, n, c,
                                  k, ch, int(ch == 16),
                                  *(ck.sa_train_dq_chunks(n, c, k) if windows else ()), stream]
            rc = fn(*cargs)
            torch.cuda.synchronize()
            first = dq.clone()
            ordered = ck.sa_train_dq_ordered_plain(de, args[2], args[3], n)
            row = {"source": str(src), "kernel": "sa_train_bwd2", "site": site, "rc": rc,
                   "dq_rel_diff": rel(dq, want_dq), "dcterm_rel_diff": rel(dct, want_dct),
                   "edge_buffer_equal": bool(torch.equal(de, want_de)),
                   "dq_equal_ordered_plain": bool(torch.equal(dq, ordered)),
                   "ms": event_ms(torch, lambda: fn(*cargs)),
                   "two_launches_equal": bool(torch.equal(dq, first))}
            for part, prefix in (("edge_pass", "sa_train_bwd2_kernel"),
                                 ("dq_pass", "sa_train_dq_kernel")):
                row[part] = device_cost(torch, lambda: fn(*cargs), prefix)
            print(json.dumps(row), flush=True)


def constants(src):
    """{name: value} of the `constexpr int` constants of a SOURCE's file."""
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (\w+) = (\d+);", source_file(src).read_text())}


def device_cost(torch, fn, prefix):
    """(device ms, device operations) a launch of fn (chip_smoke.device_profile)."""
    ms, launches, ops = chip_smoke.device_profile(torch, fn, (prefix,))
    return {"device_ms": ms, "device_ops_a_launch": ops / max(launches, 1)}


def scatter_sites(torch, ck, gen, device_):
    """knn_scatter's sites at PROD, (site, idx, w, g, s): FP1 and FP2, the
    kNN picks and weights of synthetic plots (sources a random subset of the
    targets), and the k = 1 gather of SA2's slots with 20% on row 0."""
    for site, s, t, f in (("FP1", 2500, 10000, 34), ("FP2", 625, 2500, 64)):
        pt = plot_clouds(torch, gen, 20, t, device_)
        ps = pt[:, torch.randperm(t, generator=gen, device=device_)[:s]].contiguous()
        _, idx, w = ck.knn_interpolate(torch.zeros((20, s, 1), device=device_), ps, pt)
        yield site, idx, w, torch.randn((20, t, f), generator=gen, device=device_), s
    idx = torch.randint(0, 2500, (20, 1, 40000), generator=gen, device=device_, dtype=torch.int32)
    idx[torch.rand(idx.shape, generator=gen, device=device_) < 0.2] = 0
    yield "gather", idx, None, torch.randn((20, 40000, 32), generator=gen, device=device_), 2500


def run_knn_scatter(torch, ck, libs, gen, device_):
    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, idx, w, g, s in scatter_sites(torch, ck, gen, device_):
        b, k, t = idx.shape
        f = g.shape[2]
        want = ck.knn_scatter_plain(idx, w, g, s)
        cnt = torch.zeros(b * s, device=device_).index_add_(
            0, (idx.long() + (torch.arange(b, device=device_) * s)[:, None, None]).reshape(-1),
            torch.ones(idx.numel(), device=device_))
        print(json.dumps({"site": site, "shape": [b, k, t, s, f],
                          "max_degree": int(cnt.max())}), flush=True)
        for src, lib in libs.items():
            fn = entry(lib, "knn_scatter_launch", 4, 5)
            consts = constants(src)
            outs = [torch.full((b, s, f), float("nan"), device=device_) for _ in range(2)]
            cargs = [[idx.data_ptr(), None if w is None else w.data_ptr(), g.data_ptr(),
                      dx.data_ptr(), b, k, t, s, f, stream] for dx in outs]
            rc = fn(*cargs[0])
            fn(*cargs[1])
            torch.cuda.synchronize()
            ordered = None
            if "kW" in consts and "kL" in consts:
                o = ck.knn_scatter_ordered_plain(idx, w, g, s, consts["kW"], consts["kL"])
                ordered = torch.equal(o.view(torch.int32), outs[0].view(torch.int32))
            print(json.dumps({
                "source": src, "kernel": "knn_scatter", "site": site, "rc": rc,
                **{c: consts[c] for c in ("kTS", "kRowsMax", "kW", "kL", "kB") if c in consts},
                "max_abs_diff": float((outs[0] - want).abs().max()),
                "launches_equal": torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32)),
                "equals_ordered_plain": ordered,
                "ms": event_ms(torch, lambda: fn(*cargs[0])),
                **device_cost(torch, lambda: fn(*cargs[0]), "knn_scatter"),
            }), flush=True)


def run_pixel_max(torch, ck, libs, gen, device_):
    """The serve step's site: B=20 x N=10000 points of 20 m plots in 1 m
    pixels (P = 20), three values a point."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    b, n, p, c = 20, 10000, 20, 3
    xy = torch.rand((b, n, 2), generator=gen, device=device_) * p
    pix = (xy[..., 0].long().clamp(0, p - 1) * p + xy[..., 1].long().clamp(0, p - 1)).int()
    vals = torch.rand((b, n, c), generator=gen, device=device_)
    want_v, want_a = ck.pixel_max_plain(pix, vals, p * p)
    for src, lib in libs.items():
        text = source_file(src).read_text()
        keys = re.search(r"pixel_max_launch\([^)]*keys", text) is not None
        ranged = re.search(r"pixel_max_launch\([^)]*int per", text) is not None  # one range here
        fn = entry(lib, "pixel_max_launch", 5 if keys else 4, 5 if ranged else 4)
        vmax = torch.empty((b, p * p, c), device=device_)
        amax = torch.empty((b, p * p, c), dtype=torch.int32, device=device_)
        scratch = [torch.empty((b, p * p, c), dtype=torch.int64, device=device_).data_ptr()] \
            if keys else []
        cargs = [pix.data_ptr(), vals.data_ptr(), *scratch, vmax.data_ptr(), amax.data_ptr(),
                 b, n, p * p, c, *([p * p] if ranged else []), stream]
        rc = fn(*cargs)
        torch.cuda.synchronize()
        print(json.dumps({
            "source": src, "kernel": "pixel_max", "site": "serve", "rc": rc,
            **{k: v for k, v in constants(src).items() if k in ("kCS", "kThreads", "kChunk")},
            "equal": torch.equal(vmax, want_v) and torch.equal(amax, want_a),
            "ms": event_ms(torch, lambda: fn(*cargs)),
            **device_cost(torch, lambda: fn(*cargs), "pixel_max"),
        }), flush=True)


def nearest_sites(torch, ck, gen, device_):
    """The nearest serve step's sites, (site, centroids, points, radius, k):
    SA1 (FPS's 2500 of a synthetic plot's 10000 points, r = sqrt(2), k = 32)
    and SA2 (FPS's 625 of those 2500, r = sqrt(8), k = 64), B = 20; and SA1's
    shape on a clustered cloud (90% of the points in 5% of the plot)."""
    b = 20
    start = torch.zeros(b, dtype=torch.int32, device=device_)
    pts = plot_clouds(torch, gen, b, 10000, device_)

    def fps(p, s):
        pick = ck.fps(p, s, start).long()
        return torch.gather(p, 1, pick[..., None].expand(b, s, 3)).contiguous()

    c1 = fps(pts, 2500)
    yield "SA1", c1, pts, 2 ** 0.5, 32
    yield "SA2", fps(c1, 625), c1, 8 ** 0.5, 64
    side = 20 * 0.05 ** 0.5
    crowd = torch.rand((b, 10000), generator=gen, device=device_) < 0.9
    square = (torch.rand((b, 10000, 2), generator=gen, device=device_) - 0.5) * side
    clustered = pts.clone()
    clustered[..., :2] = torch.where(crowd[..., None], square, pts[..., :2])
    yield "SA1_clustered", fps(clustered, 2500), clustered, 2 ** 0.5, 32


def run_ball_query_nearest(torch, ck, libs, gen, device_):
    """Each source at the nearest serve step's sites, its workspace from
    `cuda_kernels._nearest_workspace`: differing idx and mask entries
    against the plain version, the CUDA-event ms of a call, and its device
    ms (both kernels; the grid pass alone beside it)."""
    from stratanet2_tpu_torch.ops.ballquery import radius_sq

    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, cent, pts, radius, k in nearest_sites(torch, ck, gen, device_):
        b, c, _ = cent.shape
        n = pts.shape[1]
        want_idx, want_mask = ck.ball_query_nearest_plain(cent, pts, radius, k)
        for src, lib in libs.items():
            idx = torch.empty((b, c, k), dtype=torch.int32, device=device_)
            mask = torch.empty((b, c, k), dtype=torch.bool, device=device_)
            ws, g = ck._nearest_workspace(b, n, c, device_)
            fn = entry(lib, "ball_query_nearest_launch", 5, 5)
            fn.argtypes = fn.argtypes[:-1] + [ctypes.c_float, ctypes.c_void_p]
            cargs = [cent.data_ptr(), pts.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                     ws.data_ptr(), b, n, c, k, g, radius_sq(radius), stream]
            rc = fn(*cargs)
            torch.cuda.synchronize()
            # device_profile gives the ms of one device kernel over 10 calls
            ms, launches, _ = chip_smoke.device_profile(
                torch, lambda: fn(*cargs), ("ball_query_nearest_kernel", "nearest_grid_kernel"))
            grid_ms = chip_smoke.device_profile(torch, lambda: fn(*cargs), ("nearest_grid_kernel",))[0]
            print(json.dumps({
                "source": src, "kernel": "ball_query_nearest", "site": site, "rc": rc,
                "shape": [b, n, c, k],
                "differing": int((idx != want_idx).sum()) + int((mask != want_mask).sum()),
                "ms": event_ms(torch, lambda: fn(*cargs)),
                "device_ms": ms * launches / 10,
                "grid_device_ms": grid_ms,
                **{key: v for key, v in constants(src).items() if key in ("kNearWarps", "kNearBuf")},
            }), flush=True)


def run_fps(torch, ck, libs, gen, device_):
    """FPS's long rows: each FPS entry a source's library exports, the
    cluster path's `fps_cluster_launch` (cs from `cuda_kernels.fps_path`,
    the running-minima scratch past its shared memory) and a variant's
    `fps_stream_launch` (scripts/variants/fps_one_block.cu: one block a
    row, the points past shared memory read from L2), in turns (cluster,
    stream, stream, cluster), at the dense serve step's SA1 parts (40 rows
    of 32,768 points, 8,192 picks) and at a row past the cluster's shared
    memory (1 x 200,000, 1,024 picks), synthetic 20 m plots: differing
    picks against the plain version and the CUDA-event ms of a launch
    (mean of REPS) and us a pick."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    for site, rows, n, s in (("dense_SA1_parts", 40, 32768, 8192), ("global", 1, 200000, 1024)):
        xyz = plot_clouds(torch, gen, rows, n, device_)
        start = torch.randint(0, n, (rows,), generator=gen, device=device_, dtype=torch.int32)
        want = ck.fps_plain(xyz, s, start)
        _, cs = ck.fps_path(n)
        md = torch.empty((rows, n), device=device_)
        for src, lib in libs.items():
            fns = {}
            if hasattr(lib, "fps_cluster_launch"):
                fn = entry(lib, "fps_cluster_launch", 4, 4)
                glob = ck.fps_path(n)[0] == "global"
                fns["cluster"] = (fn, lambda out, fn=fn, glob=glob: fn(
                    xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                    md.data_ptr() if glob else None, rows, n, s, cs, stream))
            if hasattr(lib, "fps_stream_launch"):
                fn = entry(lib, "fps_stream_launch", 4, 3)
                fns["stream"] = (fn, lambda out, fn=fn: fn(
                    xyz.data_ptr(), start.data_ptr(), out.data_ptr(), md.data_ptr(), rows, n, s,
                    stream))
            order = list(fns) + list(fns)[::-1]
            for design in order:
                out = torch.empty((rows, s), dtype=torch.int32, device=device_)
                rc = fns[design][1](out)
                torch.cuda.synchronize()
                ms = event_ms(torch, lambda: fns[design][1](out))
                print(json.dumps({
                    "source": src, "kernel": "fps", "design": design, "site": site, "rc": rc,
                    "shape": [rows, n, s], "cs": cs if design == "cluster" else 1,
                    "differing": int((out != want).sum()), "ms": ms,
                    "us_a_pick": ms / (s - 1) * 1e3,
                }), flush=True)


RUNS = {"knn_interpolate": run_knn, "sa_train_stats": run_stats, "sa_train_main": run_main, "sa_train_bwd1": run_bwd1,
        "sa_train_bwd2": run_bwd2, "knn_scatter": run_knn_scatter, "pixel_max": run_pixel_max,
        "ball_query_nearest": run_ball_query_nearest, "fps": run_fps}


def main() -> int:
    import torch

    if len(sys.argv) < 3 or sys.argv[1] not in RUNS:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    from stratanet2_tpu_torch.ops import cuda_kernels as ck

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    libs = build(sys.argv[2:])
    gen = torch.Generator(device=device).manual_seed(SEED)
    RUNS[sys.argv[1]](torch, ck, libs, gen, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
