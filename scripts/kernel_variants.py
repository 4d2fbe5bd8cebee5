#!/usr/bin/env python3
"""Time design variants of a PyTorch-port kernel on one CUDA card (an H100).

Each SOURCE is a copy of `stratanet2_tpu_torch/ops/csrc/<library>.cu` with
another design behind the same C entry point, or such a file followed by
`@name=value,...`: a copy with those `constexpr int` constants set (written to
the git-ignored build/variant_src/). The script builds every source
at once with the port's nvcc flags (`ops/_build.py`), prints each kernel's
registers and spills (`cuobjdump -res-usage`), a digest of its SASS
(`sass_digest`) and, for sa_train.cu, the SASS,
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
pairs on row 0); pixel_max at PIXEL_MAX_SITES (the serve step's 1 m pixels
of synthetic 20 m plots, the dense plots' table and diam_pix 300). Both also
print the device time and the device operations of a launch
(torch.profiler); the scatter whether two launches agree bit for bit and,
for a source that sets its round and chunk (kW, kL), whether it equals
`knn_scatter_ordered_plain` bit for bit; a pixel_max source whose entry
still takes a key scratch or a range size (a parent's design) gets one.

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

fps runs FPS's designs at every shape chip_smoke.py holds (see
`run_fps`): the package's pruned kernels, the earlier ones with 1024-thread
clusters only (scripts/variants/fps_pr21.cu), sub-boxes in the warp's
update, a flat cluster exchange, one block a row with the row in L2, the
unpruned ones (in scripts/variants/fps_unpruned.cu), the cluster-barrier
design and one block a row from device memory;
sa_train_bwd2 the windowed dq pass's (see `run_bwd2`). The earlier
designs are files of scripts/variants/ that include the package's source,
so one library holds both designs:

    python3 scripts/kernel_variants.py fps stratanet2_tpu_torch/ops/csrc/fps.cu \
        scripts/variants/fps_pr21.cu scripts/variants/fps_sub_boxes.cu \
        scripts/variants/fps_sub_boxes.cu@kSubBranch=1 scripts/variants/fps_flat_exchange.cu \
        scripts/variants/fps_unpruned.cu scripts/variants/fps_cluster_barrier.cu
    python3 scripts/kernel_variants.py sa_train_bwd2 scripts/variants/sa_train_dq_windows.cu

selection runs the grouped selection (the standalone query and the SA
eval kernel) at SEL_SITES: the dense plots' SA1 on uniform, clustered,
shifted and x-sorted clouds and at a radius over the whole plot, and
PROD's SA1; each design that a source exports in turns A, B, B, A (the
package's whole-group and cell-grid entries, the earlier chunked design of
scripts/variants/selection_chunked.cu, and a parent's entries, which take
the staged points at once), outputs held bit for bit to the first design's,
with the grid path's kernels' device ms and the pairs it scores. A
constant set by a SOURCE may live in a header beside it (grouped_cull.cuh's
kCullCents, kCullSlots):

    python3 scripts/kernel_variants.py selection scripts/variants/selection_chunked.cu \
        build/parent/stratanet2_tpu_torch/ops/csrc/ball_query.cu \
        stratanet2_tpu_torch/ops/csrc/ball_query.cu@kCullCents=4,kCullSlots=896

knn_grid times kNN's whole-cloud kernel against its cell grid's designs
(see `run_knn_grid`: the package's, and PR 19's in
scripts/variants/knn_cull_ldg.cu) over S, the crossover that sets
cuda_kernels.KNN_GRID_MIN_S; cell_grid times the cell grid's pass alone,
PR 19's one block a cloud against the cluster at every size (see
`run_cell_grid`; scripts/variants/cell_grid_one_block.cu).
pixel_max runs every design a source exports at the serve, dense and
diam_pix 300 tables (see `run_pixel_max`: the package's ranges, the
fewest that fit a block and other counts; 64-bit maxima through
distributed shared memory, a counting sort and a block a slice of the
pixels are files of scripts/variants/). sass builds the sources
and prints their SASS digests only, to show which kernels a change left as
they were:

    python3 scripts/kernel_variants.py knn_grid stratanet2_tpu_torch/ops/csrc/knn_interpolate.cu \
        scripts/variants/knn_cull_ldg.cu
    python3 scripts/kernel_variants.py cell_grid scripts/variants/cell_grid_one_block.cu
    python3 scripts/kernel_variants.py pixel_max stratanet2_tpu_torch/ops/csrc/pixel_max.cu \
        scripts/variants/pixel_max_dsmem.cu scripts/variants/pixel_max_owner_scan.cu \
        scripts/variants/pixel_max_sort.cu
    python3 scripts/kernel_variants.py sass build/parent/stratanet2_tpu_torch/ops/csrc/ball_query.cu \
        stratanet2_tpu_torch/ops/csrc/ball_query.cu

Kernels: knn_interpolate, knn_grid, cell_grid, sa_train_stats, sa_train_main,
sa_train_bwd1, sa_train_bwd2, knn_scatter, pixel_max, ball_query_nearest, fps,
selection, sass.

Builds go to the git-ignored build/variants/. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import hashlib
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
    path with those `constexpr int` constants set, each found once in path
    or in the headers (*.cuh) beside it, which are copied with it into a
    folder of its own (build/variant_src/<stem>_<settings>_<path hash>/),
    so that the copy includes the set headers."""
    path, _, sets = spec.partition("@")
    if not sets:
        return Path(path)
    path = Path(path)
    texts = {f.name: f.read_text() for f in [path, *sorted(path.parent.glob("*.cuh"))]}
    for item in sets.split(","):
        name, value = item.split("=")
        found = 0
        for fname, text in texts.items():
            texts[fname], n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{value};",
                                      text)
            found += n
        if found != 1:
            raise SystemExit(f"{spec}: constant {name} not found once in {path} and its headers")
    where = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:8]  # two trees' copies apart
    out_dir = (ROOT / "build" / "variant_src"
               / f"{path.stem}_{sets.replace('=', '').replace(',', '_')}_{where}")
    out_dir.mkdir(parents=True, exist_ok=True)
    for fname, text in texts.items():
        (out_dir / fname).write_text(text)
    return out_dir / path.name


def source_text(spec: str) -> str:
    """A SOURCE's text with the sources it includes (`#include "<name>.cu"`,
    as the files of scripts/variants/ do: beside it, else the package's)
    inlined."""
    from stratanet2_tpu_torch.ops import _build

    path = source_file(spec)

    def inline(m):
        near = path.parent / m.group(1)
        return source_text(str(near)) if near.exists() else (_build.CSRC / m.group(1)).read_text()

    return re.sub(r'#include "(\w+\.cu)"', inline, path.read_text())


def sass_digest(ins, blank=False):
    """A digest of one kernel's SASS text; with `blank`, the kernel
    parameters' constant-bank offsets left out. Equal digests in two
    sources' libraries are the same machine code (with `blank`: but for
    where a changed parameter list puts its arguments)."""
    text = "\n".join(t for _, t in ins)
    if blank:
        text = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", text)
    return hashlib.sha1(text.encode()).hexdigest()[:12]


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
        print(json.dumps({"source": str(src), "sass_digest": {
            func: [len(ins), sass_digest(ins), sass_digest(ins, blank=True)]
            for func, ins in chip_smoke.sass_functions(sass).items()}}), flush=True)
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


# kNN's two paths (cuda_kernels.knn_path) over S: (S, T, F) at B = 20, T =
# 4 S as SA1's centroids are a quarter of the points: below PROD's FP1, PROD's
# FP1, the dense plots' FP2, between, and the dense plots' FP1
KNN_GRID_SITES = ((1024, 4096, 64), (2500, 10000, 34), (4096, 16384, 64), (8192, 32768, 34),
                  (16384, 65536, 34))
# the grid path's designs a library may export: (entry, pointers, ints
# without cs, the kernels of a launch by name prefix)
KNN_GRID_DESIGNS = {
    "grid": ("knn_interpolate_grid_launch", 8, 5, ("knn_grid_kernel", "knn_cull_kernel")),
    # scripts/variants/knn_cull_ldg.cu: PR 19's query after the cluster pass,
    # and PR 19's design whole (the one-block pass)
    "grid_ldg": ("knn_interpolate_grid_ldg_launch", 8, 5,
                 ("knn_grid_kernel", "knn_cull_ldg_kernel")),
    "pr19": ("knn_interpolate_grid_pr19_launch", 8, 5,
             ("one_block_extent_grid_kernel", "knn_cull_ldg_kernel")),
}


def run_knn_grid(torch, ck, libs, gen, device):
    """kNN's whole-cloud kernel against its cell grid's designs: at each
    KNN_GRID_SITES shape, synthetic plots (sources a random subset of the
    targets), each source's `knn_interpolate_launch` (knn_slices' slices)
    and each grid design it exports (KNN_GRID_DESIGNS: the package's
    cluster grid pass and staged query; PR 19's query after the cluster
    pass; PR 19's one-block pass and query) in turns A, B, ..., B, A: the
    CUDA-event ms of a call (mean of REPS), indices differing from the
    plain version, weights and outputs bit for bit its, the pairs the grid
    scored and the device ms of the grid pass and the query apart. First
    each library's grid query scan loops (chip_smoke.sass_per_pair: the
    staged query's on its LDS.128, PR 19's on its LDG.128 loads)."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    for src, lib in libs.items():
        sass = subprocess.run([str(_nvcc_dir() / "cuobjdump"), "-sass", lib._name],
                              capture_output=True, text=True, check=True).stdout
        loops = {f: v for load in (r"LDS\.128", r"LDG\.E\S*\.128")
                 for f, v in chip_smoke.sass_per_pair(sass, 1, load).items()
                 if "knn_cull" in f and ("ldg" in f) == ("LDG" in load)}
        print(json.dumps({"source": str(src), "grid_query_loops": loops}), flush=True)
    b = 20
    for s, t, f in KNN_GRID_SITES:
        pt = plot_clouds(torch, gen, b, t, device)
        ps = pt[:, torch.randperm(t, generator=gen, device=device)[:s]].contiguous()
        x = torch.randn((b, s, f), generator=gen, device=device)
        want_out, want_idx, want_w = ck.knn_interpolate_plain(x, ps, pt)
        ws, gmax = ck._cell_workspace(b, s, t, device)
        scored = torch.empty((b, t), dtype=torch.int32, device=device)
        calls = {}
        for src, lib in libs.items():
            whole = entry(lib, "knn_interpolate_launch", 6, 5)
            calls[(src, "whole")] = (lambda o, fn=whole: fn(*ptrs([x, ps, pt, *o]), b, s, t, f,
                                                             ck.knn_slices(b, t), stream), ())
            for design, (symbol, n_ptrs, n_ints, kernels) in KNN_GRID_DESIGNS.items():
                if hasattr(lib, symbol):
                    fn = grid_call(src, lib, symbol, n_ptrs, n_ints, radius=False)
                    calls[(src, design)] = (lambda o, fn=fn: fn(
                        [x, ps, pt, *o, ws, scored], [b, s, t, f, gmax], None,
                        ck.cell_grid_cluster(b, s + t), stream), kernels)
        for key in list(calls) + list(calls)[::-1]:
            call, kernels = calls[key]
            o = (torch.empty((b, t, f), device=device),
                 torch.empty((b, 3, t), dtype=torch.int32, device=device),
                 torch.empty((b, 3, t), device=device))
            rc = call(o)
            torch.cuda.synchronize()
            row = {"source": str(key[0]), "kernel": "knn_interpolate", "design": key[1],
                   "shape": [b, s, t, f], "rc": rc, "cs": ck.cell_grid_cluster(b, s + t),
                   "differing_indices": int((o[1] != want_idx).sum()),
                   "weights_equal": torch.equal(o[2], want_w),
                   "outputs_equal": torch.equal(o[0], want_out),
                   "ms": event_ms(torch, lambda: call(o)),
                   "all_pairs": float(b) * s * t}
            if kernels:
                row["scored_pairs"] = float(scored.double().sum())
                row["scored_share"] = row["scored_pairs"] / row["all_pairs"]
                row["device_ms"] = {k: chip_smoke.device_profile(torch, lambda: call(o), (k,))[0]
                                    for k in kernels}
            print(json.dumps(row), flush=True)
        del pt, ps, x, want_out, want_idx, want_w, ws, scored


# the grid pass's sites (cell_grid mode): (site, B, N points or sources, C
# centroids or targets, radius (None: kNN's extent form), the wrappers whose
# grid kernel runs there): kNN's dense FP1 and FP2, the grouped selection's
# dense SA1 (ball_query_grid_kernel in training, sa_grid_kernel serving),
# the nearest route's PROD SA1 and SA2, the 80,000-point train step's SA1
# ball query and kNN FP1 and FP2, kNN's grid reference sites (B = 2, one
# cloud, 67 clouds) and small clouds (1,024 sources, 4,096 targets) at
# B = 1 and 20
CELL_GRID_SITES = (("knn_dense_FP1", 20, 16384, 65536, None, ("knn_interpolate",)),
                   ("knn_dense_FP2", 20, 4096, 16384, None, ("knn_interpolate",)),
                   ("dense_SA1", 20, 65536, 16384, 2 ** 0.5, ("ball_query", "sa_fused_eval")),
                   ("nearest_PROD_SA1", 20, 10000, 2500, 2 ** 0.5, ("ball_query_nearest",)),
                   ("nearest_PROD_SA2", 20, 2500, 625, 8 ** 0.5, ("ball_query_nearest",)),
                   ("step80k_SA1", 20, 80000, 20000, 2 ** 0.5, ("ball_query",)),
                   ("step80k_knn_FP1", 20, 20000, 80000, None, ("knn_interpolate",)),
                   ("step80k_knn_FP2", 20, 5000, 20000, None, ("knn_interpolate",)),
                   ("knn_ref_B2", 2, 16384, 65536, None, ()),
                   ("knn_ref_one", 1, 16384, 65536, None, ()),
                   ("knn_ref_many", 67, 16384, 65536, None, ()),
                   ("small_B1", 1, 1024, 4096, None, ()),
                   ("small_B20", 20, 1024, 4096, None, ()))
GRID_KERNEL = {"knn_interpolate": "knn_grid_kernel", "ball_query": "ball_query_grid_kernel",
               "sa_fused_eval": "sa_grid_kernel", "ball_query_nearest": "nearest_grid_kernel"}


def run_cell_grid(torch, ck, libs, gen, device):
    """The grid pass alone (a source that exports scripts/variants/
    cell_grid_one_block.cu's entries): first the clusters of cs blocks the
    card holds at once (cs 1-8, gmax 64). Then at CELL_GRID_SITES, plots
    with centroids drawn from the points, PR 19's one block a cloud and the
    package's cluster at the wrapper's cs (`cuda_kernels.cell_grid_cluster`
    of B and the entries a cloud) in turns (one block, cluster, cluster,
    one block), then the cluster at every other cs: the CUDA-event ms of a
    pass (mean of REPS), its grid against the one-block pass's (parameters
    and starts bit for bit) and, the first pass at each cs, against the CPU
    mirror (chip_smoke.cell_grid_check: parameters, starts, points and
    centroids cell by cell, 0 differing); then each wrapper whose path runs the grid
    there (cuda_kernels, the package's build) with its grid kernel's device
    ms (torch.profiler), the same pass under the library's own name."""
    from stratanet2_tpu_torch.ops.ballquery import radius_sq

    stream = torch._C._cuda_getCurrentRawStream(0)
    lib = next((lb for lb in libs.values() if hasattr(lb, "cell_grid_one_block_launch")), None)
    if lib is None:
        raise SystemExit("cell_grid: give scripts/variants/cell_grid_one_block.cu")
    resident = entry(lib, "cell_grid_cluster_resident", 0, 2)
    resident.argtypes = [ctypes.c_int, ctypes.c_int]
    print(json.dumps({"cell_grid_cluster_resident": {cs: resident(cs, 64) for cs in range(1, 9)},
                      "sms": torch.cuda.get_device_properties(device).multi_processor_count}),
          flush=True)
    one = entry(lib, "cell_grid_one_block_launch", 3, 4)
    one.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
    clu = entry(lib, "cell_grid_cluster_launch", 3, 4)
    clu.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_int, ctypes.c_void_p]
    for site, b, n_p, n_c, radius, wrappers in CELL_GRID_SITES:
        by_extent = radius is None
        if by_extent:  # kNN: the targets (its centroids) are the cloud, the sources a subset
            cen = plot_clouds(torch, gen, b, n_c, device)
            pnt = cen[:, torch.randperm(n_c, generator=gen, device=device)[:n_p]].contiguous()
        else:  # the selections: centroids drawn from the points
            pnt = plot_clouds(torch, gen, b, n_p, device)
            cen = pnt[:, torch.randperm(n_p, generator=gen, device=device)[:n_c]].contiguous()
        r2 = 0.0 if by_extent else radius_sq(radius)
        cs0 = ck.cell_grid_cluster(b, n_p + n_c)
        runs = {}

        def pass_of(cs):
            ws, gmax = ck._cell_workspace(b, n_p, n_c, device)
            if cs == 0:
                return ws, lambda: one(cen.data_ptr(), pnt.data_ptr(), ws.data_ptr(), b, n_p, n_c,
                                       gmax, r2, int(by_extent), stream)
            return ws, lambda: clu(cen.data_ptr(), pnt.data_ptr(), ws.data_ptr(), b, n_p, n_c,
                                   gmax, r2, int(by_extent), cs, stream)

        order = [0, cs0, cs0, 0] + [cs for cs in range(1, 9) if cs != cs0]
        for cs in order:
            ws, fn = pass_of(cs)
            rc = fn()
            torch.cuda.synchronize()
            grid = ck.cell_grid_view(ws, b, n_p, n_c)
            seen = cs in runs
            runs.setdefault(cs, grid)
            first = runs[0]
            same = {key: torch.equal(grid[key], first[key]) for key in
                    ("xmin", "ymin", "inv_h", "rc2", "gx", "gy", "starts")}
            diff, parts = None, None  # the mirror holds the first pass of each cs
            if not seen:
                diff, _, parts = chip_smoke.cell_grid_check(torch, grid, pnt, cen,
                                                            None if by_extent else radius)
            print(json.dumps({"kernel": "cell_grid", "site": site, "shape": [b, n_p, n_c],
                              "design": "one_block" if cs == 0 else "cluster", "cs": cs or None,
                              "wrapper_cs": cs0, "rc": rc, "ms": event_ms(torch, fn),
                              "equal_to_one_block": same, "mirror_differing": diff,
                              "mirror_parts": parts}), flush=True)
        for name in wrappers:
            if name == "knn_interpolate":
                x = torch.randn((b, n_p, 34), generator=gen, device=device)
                args = (x, pnt, cen)
            elif name == "sa_fused_eval":
                ch = 16
                args = (torch.randn((b, n_p, ch), generator=gen, device=device), pnt, cen,
                        torch.randn((b, n_c, ch), generator=gen, device=device),
                        torch.rand(ch, generator=gen, device=device) + 0.5,
                        torch.rand(ch, generator=gen, device=device) - 0.5,
                        torch.randn((ch, ch), generator=gen, device=device) * 0.25,
                        torch.rand(ch, generator=gen, device=device) - 0.5,
                        torch.rand(ch, generator=gen, device=device) + 0.5,
                        torch.rand(ch, generator=gen, device=device) - 0.5, radius, 32)
            else:
                args = (cen, pnt, radius, 32)
            fn = getattr(ck, name)
            print(json.dumps({"kernel": "cell_grid", "site": site, "wrapper": name,
                              "grid_kernel": GRID_KERNEL[name], "cs": cs0,
                              "grid_device_ms": chip_smoke.device_profile(
                                  torch, lambda: fn(*args), (GRID_KERNEL[name],))[0],
                              "call_ms": event_ms(torch, lambda: fn(*args))}), flush=True)
        del pnt, cen, runs


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


def fentry(lib, symbol, n_ptrs, n_ints):
    """`entry` with a float (the radius squared) before the stream."""
    fn = entry(lib, symbol, n_ptrs, n_ints)
    fn.argtypes = fn.argtypes[:-1] + [ctypes.c_float, ctypes.c_void_p]
    return fn


def ptrs(args):
    return [None if a is None else a.data_ptr() for a in args]


def takes_cs(src, symbol):
    """Whether the C entry `symbol` of a SOURCE takes the grid pass's
    cluster size (the package's grid entries since the cluster pass: `int
    cs` before the stream; a parent tree's do not)."""
    sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', source_text(src))
    return sig is not None and re.search(r"\bint cs\b", sig[1]) is not None


def grid_call(src, lib, symbol, n_ptrs, n_ints, radius=True):
    """`symbol` of a grid entry as fn(pointers, ints, r2, cs, stream): the
    float r2 where the entry takes one, cs dropped where it takes none."""
    cs = takes_cs(src, symbol)
    fn = entry(lib, symbol, n_ptrs, n_ints)
    fn.argtypes = (fn.argtypes[:-1] + ([ctypes.c_float] if radius else [])
                   + ([ctypes.c_int] if cs else []) + [ctypes.c_void_p])

    def call(pointers, ints, r2, c, stream):
        return fn(*ptrs(pointers), *ints, *([r2] if radius else []), *([c] if cs else []), stream)

    return call


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


def pr16_dq_chunks(n, c, k):
    """PR 16's dq windows, (points, centroids) a window (its
    cuda_kernels.sa_train_dq_chunks): the group and every centroid while
    they fit, else windows of points within half of the block and the
    centroids in the rest."""
    g = -(-n // k)
    ints = 227 * 1024 // 4
    if 2 * c + 9 * g + 1 <= ints:
        return g, c
    gp = min(g, (ints // 2 - 1) // 9)
    return gp, min(c, (ints - 9 * gp - 1) // 2)


def dq_plans(ck, b, n, c, k):
    """The windowed dq pass's plans to time at a shape, {label: (gp, lcap)}:
    the wrapper's (`sa_train_dq_plan`) and one window a group fewer and
    more (lcap by the same rule, where the counts fit); {"prod": None}
    where the wrapper takes the PROD instance."""
    plan = ck.sa_train_dq_plan(b, n, c, k)
    if plan is None:
        return {"prod": None}
    g = -(-n // k)
    w = -(-g // plan[0])
    plans = {"plan": plan}
    for label, ww in (("W-1", w - 1), ("W+1", w + 1)):
        gp = -(-g // max(ww, 1))
        if ww >= 1 and -(-g // gp) == ww and 9 * gp + 1 <= ck.SA_DQ_INTS // 4:
            plans[label] = (gp, min(c, ck.SA_DQ_PAIR_INTS - 9 * gp - 1))
    return plans


def run_bwd2(torch, ck, libs, gen, device):
    """The edge pass and the dq pass of one bwd2 launch at the PROD sites,
    at chip_smoke.DQ_REFERENCE (1 x 80,000, 20,000 centroids, K = 32) and at
    the SA1 site of a train step of 20 x 80,000 (synthetic draws as
    chip_smoke's SA train reference sites): dq and dcterm against the plain
    version, the edge buffer against the plain de0, dq bit for bit against
    `sa_train_dq_ordered_plain` of the buffer and two launches against each
    other, the CUDA-event ms of a launch and the device ms of each pass
    (the dq pass: every kernel named sa_train_dq*). Each source's entries:
    `sa_train_bwd2_launch` with keys and lists (the package's: at each of
    `dq_plans`), the same entry with PR 16's windows (gp, cc) (the parent's
    file), and `sa_train_bwd2_pr16_launch` (scripts/variants/
    sa_train_dq_windows.cu, PR 16's design); in turns A, B, B, A."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    sites = [(site, b, n, c, k, ch, args) for site, b, n, c, k, ch, args in
             sa_sites(torch, ck, gen, device)]
    for site, shape in (("DQ_REFERENCE", chip_smoke.DQ_REFERENCE),
                        ("step80k_SA1", (20, chip_smoke.DENSE_DQ_N, chip_smoke.DENSE_DQ_N // 4, 32,
                                         16))):
        sites.append((site, *shape, chip_smoke.sa_train_site_args(torch, ck, gen, device, *shape)))
    for site, b, n, c, k, ch, args in sites:
        want_dq, want_dct = ck.sa_train_bwd2_plain(*args)
        want_de = ck.sa_train_edges(*args)["de0"].reshape(b, c * k, ch)
        grid = ck.sa_grid(b, c, ch)
        runs = {}
        for src, lib in libs.items():
            text = source_text(src)
            if re.search(r"sa_train_bwd2_launch\([^)]*int\* keys", text):
                fn = entry(lib, "sa_train_bwd2_launch", 13, 9)
                for label, plan in dq_plans(ck, b, n, c, k).items():
                    keys = lists = None
                    gp, lcap = (-(-n // k), c) if plan is None else plan
                    if plan is not None:
                        keys = torch.empty((b, k, c), dtype=torch.int32, device=device)
                        lists = torch.empty((b, k, c), dtype=torch.int32, device=device)
                    runs[(src, label)] = (fn, ptrs([keys, lists]), [gp, lcap], (keys, lists))
            elif re.search(r"sa_train_bwd2_launch\([^)]*int gp, int cc", text):  # PR 16's file
                runs[(src, "pr16")] = (entry(lib, "sa_train_bwd2_launch", 11, 9), [],
                                       list(pr16_dq_chunks(n, c, k)), ())
            if hasattr(lib, "sa_train_bwd2_pr16_launch"):
                runs[(src, "pr16_variant")] = (entry(lib, "sa_train_bwd2_pr16_launch", 11, 9), [],
                                               list(pr16_dq_chunks(n, c, k)), ())
        order = list(runs) + list(runs)[::-1]
        for key in order:
            fn, scratch, plan_args, _ = runs[key]
            de = torch.empty((b, c * k, ch), device=device)
            dq = torch.empty((b, n, ch), device=device)
            dct = torch.empty((b, c, ch), device=device)
            cargs = ptrs(args) + [de.data_ptr(), dq.data_ptr(), dct.data_ptr(), *scratch, grid,
                                  b, n, c, k, ch, int(ch == 16), *plan_args, stream]
            rc = fn(*cargs)
            torch.cuda.synchronize()
            first = dq.clone()
            ordered = ck.sa_train_dq_ordered_plain(de, args[2], args[3], n)
            row = {"source": str(key[0]), "design": key[1], "kernel": "sa_train_bwd2",
                   "site": site, "shape": [b, n, c, k, ch], "plan": plan_args, "rc": rc,
                   "dq_rel_diff": rel(dq, want_dq), "dcterm_rel_diff": rel(dct, want_dct),
                   "edge_buffer_equal": bool(torch.equal(de, want_de)),
                   "dq_equal_ordered_plain": bool(torch.equal(dq, ordered)),
                   "ms": event_ms(torch, lambda: fn(*cargs)),
                   "two_launches_equal": bool(torch.equal(dq, first))}
            # the dq pass a call: the keys kernel and the windowed kernel
            # where the design takes windows of points, else one kernel
            windowed = bool(scratch) and scratch[0] is not None
            for part, prefix, kernels in (("edge_pass", "sa_train_bwd2_kernel", 1),
                                          ("dq_pass", "sa_train_dq", 2 if windowed else 1)):
                row[part] = device_cost(torch, lambda: fn(*cargs), prefix, kernels)
            print(json.dumps(row), flush=True)
            del de, dq, dct, first, ordered
        del want_dq, want_dct, want_de, args, runs
        torch.cuda.empty_cache()


def constants(src, headers=False):
    """{name: value} of the `constexpr int` constants of a SOURCE's file
    (and, with `headers`, of the headers it includes: those beside it, else
    the package's)."""
    from stratanet2_tpu_torch.ops import _build

    path = source_file(src)
    near = sorted(path.parent.glob("*.cuh")) or sorted(_build.CSRC.glob("*.cuh"))
    files = [path] + (near if headers else [])
    return {m.group(1): int(m.group(2)) for f in files for m in
            re.finditer(r"constexpr int (\w+) = (\d+);", f.read_text())}


def device_cost(torch, fn, prefix, kernels=1):
    """The device ms a call of fn of its `kernels` kernels named `prefix`
    (chip_smoke.device_profile gives the ms a launch of one of them: their
    mean), and the device operations a matching launch."""
    ms, launches, ops = chip_smoke.device_profile(torch, fn, (prefix,))
    return {"device_ms": ms * kernels, "device_ops_a_launch": ops / max(launches, 1)}


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


# pixel_max's sites: (site, B, N, P), C = 3, points of 20 m plots in P x P
# pixels: the serve step's (1 m pixels), the dense plots' (B=20 x N=65,536
# at diam_pix 100: a table past one block) binned uniformly, as the plot
# coverages bin them, and as the dense serve step's rasters bin them
# ("dense_raster": projection._raster_bins of the rescaled plot at 20 m,
# whose clamp puts a fifth of the points on pixel 0 and two fifths on the
# first row and column), and diam_pix 300
PIXEL_MAX_SITES = (("serve", 20, 10000, 20), ("dense", 20, 65536, 100),
                   ("dense_raster", 20, 65536, 100), ("wide", 4, 65536, 300))


SORT_PIXELS = 51200  # scripts/variants/pixel_max_sort.cu: pixels a range (4 B counters)


def pixel_max_designs(lib, text, b, n, p2, c, per_fit):
    """{design: (its entry, extra int arguments, scratch)} of the pixel-max
    designs a library exports, at a table of p2 pixels. A file that defines
    `pixel_max_launch` (the package's, a parent's): one range where the
    table fits a block ("block"), else the package's ranges ("plan",
    `cuda_kernels.pixel_max_range`), the fewest ranges that fit a block
    ("fit", `per_fit`) and 3, 4, 6 or 8 ranges where their tables fit a
    block; an older parent's entry that takes a key scratch ("keys") runs
    once. The variants' entries (scripts/variants/): a block a slice of
    the pixels reading every id,
    with 64-bit keys ("slices") or in two 32-bit passes ("owner2"), and the
    table spread over the cluster with 64-bit DSMEM maxima ("dsmem"), at
    ranges whose 8 slices fit 8 blocks; the counting sort at ranges of
    SORT_PIXELS ("sort", "order": its (b, ranges, n) scratch)."""
    from stratanet2_tpu_torch.ops import cuda_kernels as ck

    designs = {}
    keys = re.search(r"pixel_max_launch\([^)]*keys", text) is not None
    ranged = re.search(r"pixel_max_launch\([^)]*int per", text) is not None
    fits = 8 * p2 * c <= 232448
    if keys:
        designs["keys"] = (entry(lib, "pixel_max_launch", 5, 4), [], "keys")
    elif ranged:
        fn = entry(lib, "pixel_max_launch", 4, 5)
        plans = [("block", p2)] if fits else [
            ("plan", ck.pixel_max_range(p2, c)), ("fit", per_fit),
            *((f"ranges{r}", -(-p2 // r)) for r in (3, 4, 6, 8)
              if 8 * -(-p2 // r) * c <= 232448)]  # a range's table within a block
        for design, per in plans:
            if per not in [v[1][0] for v in designs.values()]:
                designs[design] = (fn, [per], None)
    if not fits:
        def even(cap):  # the fewest ranges of at most cap pixels, cut evenly
            return -(-p2 // -(-p2 // cap))

        spread = even(8 * (ck.PIXEL_MAX_TABLE // c))
        slices = max(8, -(-p2 // (ck.PIXEL_MAX_TABLE // c)))
        for design, symbol, arg, scratch in (
                ("slices", "pixel_max_slice_launch", slices, None),
                ("owner2", "pixel_max_owner2_launch", spread, None),
                ("dsmem", "pixel_max_dsmem_launch", spread, None),
                ("sort", "pixel_max_sort_launch", even(SORT_PIXELS), "order")):
            if hasattr(lib, symbol):
                designs[design] = (entry(lib, symbol, 5 if scratch else 4, 5), [arg], scratch)
    return designs


def run_pixel_max(torch, ck, libs, gen, device_):
    """pixel_max at PIXEL_MAX_SITES, every design each source exports
    (`pixel_max_designs`) in turns A, B, ..., B, A: equal to the plain
    version exactly, the CUDA-event ms of a call and the device ms and
    device operations of a launch (torch.profiler)."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    from stratanet2_tpu_torch.ops.projection import _raster_bins

    for site, b, n, p in PIXEL_MAX_SITES:
        c = 3
        xy = torch.rand((b, n, 2), generator=gen, device=device_) * p
        pix = (xy[..., 0].long().clamp(0, p - 1) * p + xy[..., 1].long().clamp(0, p - 1)).int()
        if site == "dense_raster":
            pix = _raster_bins((xy / p * 2 - 1).contiguous(), p, 20).contiguous()
        vals = torch.rand((b, n, c), generator=gen, device=device_)
        want_v, want_a = ck.pixel_max_plain(pix, vals, p * p)
        per_fit = -(-(p * p) // -(-(p * p) // (ck.PIXEL_MAX_TABLE // c)))  # the fewest that fit
        runs = []
        for src, lib in libs.items():
            text = source_file(src).read_text()
            for design, (fn, extra, scratch) in pixel_max_designs(lib, text, b, n, p * p, c,
                                                                  per_fit).items():
                runs.append((src, design, fn, extra, scratch))
        for src, design, fn, extra, scratch in runs + runs[::-1]:
            vmax = torch.empty((b, p * p, c), device=device_)
            amax = torch.empty((b, p * p, c), dtype=torch.int32, device=device_)
            if scratch == "keys":
                work = [torch.empty((b, p * p, c), dtype=torch.int64, device=device_)]
            elif scratch == "order":
                work = [torch.empty((b, -(-(p * p) // extra[0]), n), dtype=torch.int32,
                                    device=device_)]
            else:
                work = []
            ptr_args = [pix, vals, *work, vmax, amax] if scratch == "keys" else \
                [pix, vals, vmax, amax, *work]
            cargs = [*ptrs(ptr_args), b, n, p * p, c, *extra, stream]
            rc = fn(*cargs)
            torch.cuda.synchronize()
            print(json.dumps({
                "source": src, "kernel": "pixel_max", "design": design, "site": site,
                "shape": [b, n, p * p, c], "extra": extra, "rc": rc,
                **{k: v for k, v in constants(src).items() if k in ("kCS", "kThreads")},
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
    `cuda_kernels._cell_workspace`: differing idx and mask entries
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
            ws, g = ck._cell_workspace(b, n, c, device_)
            call = grid_call(src, lib, "ball_query_nearest_launch", 5, 5)

            def run():
                return call([cent, pts, idx, mask, ws], [b, n, c, k, g], radius_sq(radius),
                            ck.cell_grid_cluster(b, n + c), stream)

            rc = run()
            torch.cuda.synchronize()
            # device_profile gives the ms a launch of the kernels it matches
            query_ms = chip_smoke.device_profile(torch, run, ("ball_query_nearest_kernel",))[0]
            grid_ms = chip_smoke.device_profile(torch, run, ("nearest_grid_kernel",))[0]
            print(json.dumps({
                "source": src, "kernel": "ball_query_nearest", "site": site, "rc": rc,
                "shape": [b, n, c, k],
                "differing": int((idx != want_idx).sum()) + int((mask != want_mask).sum()),
                "ms": event_ms(torch, run),
                "device_ms": query_ms + grid_ms,
                "grid_device_ms": grid_ms,
                **{key: v for key, v in constants(src).items() if key in ("kNearWarps", "kNearBuf")},
            }), flush=True)


def pr16_fps_cs(n):
    """PR 16's cluster size for rows of n points: the least power of two
    with cs x 16,384 >= n, at most 8."""
    cs = 2
    while cs < 8 and cs * 16384 < n:
        cs *= 2
    return cs


# FPS's sites (`run_fps`): (site, rows, N, S). One point a thread (the
# pick's chain, chip_smoke's fps_chain), then every shape of
# chip_smoke.FPS_REFERENCE (its serve and dense parts, fps_kernel's last
# row, the cluster's shapes and the global path's row), with the dense
# serve step's SA2 rows (40 x 8,192, 2,048 picks) and the 80,000-point
# train step's SA1 rows (40 x 40,000, 10,000 picks).
FPS_SITES = (("chain_floor", 40, 1024, 1024),
             ("PROD_SA1_parts", 40, 5000, 1250), ("PROD_SA2", 20, 2500, 625),
             ("PROD_unpartitioned", 20, 10000, 2500), ("block_last", 20, 16384, 1024),
             ("dense_SA2_parts", 40, 8192, 2048), ("dense_SA1_parts", 40, 32768, 8192),
             ("step80k_SA1_parts", 40, 40000, 10000), ("odd_40001", 4, 40001, 10000),
             ("rows_60000", 4, 60000, 2048), ("rows_100000", 2, 100000, 2048),
             ("global", 1, 200000, 1024))


def takes(src, symbol, arg):
    """Whether the C entry `symbol` of a SOURCE takes the argument `arg`:
    FPS's pruning counter (`unsigned long long* stats`; a parent tree's
    entries take none), the cluster's block size (`int threads`; those of
    scripts/variants/fps_pr21.cu take none), the running-minima scratch
    (`float* md`; scripts/variants/fps_flat_exchange.cu's takes none)."""
    sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', source_text(src))
    return sig is not None and arg in sig[1]


# The entries of FPS's variants in scripts/variants/ that include the
# package's source: their libraries' package entries are timed from the
# package's own SOURCE, not again.
FPS_VARIANT_ENTRIES = ("fps_sub_launch", "fps_flat_cluster_launch", "fps_row_launch")


def run_fps(torch, ck, libs, gen, device_):
    """FPS at FPS_SITES on synthetic 20 m plots. Each design a source's
    library exports, in turns A, B, B, A: the package's `fps_launch`
    (fps_kernel, exact pruning) at rows of up to 16,384 points and its
    `fps_cluster_launch` (its library also exports `fps_cluster_resident`)
    past them, at the wrapper's instance (`cuda_kernels.fps_path` on the
    card's resident clusters of each block size, printed) and at every
    other cs and block size that holds the slices; at the wrapper's
    instance also the cluster of one block (cs = 1) and fps_kernel on each
    row's first slice alone, whose time a pick against the row's is the
    cluster exchange's share, and fps_kernel's on the slice against its
    chain floor (one point a thread, FPS_SITES' first) the share of the
    slice's points (`"exchange_split"` line);
    scripts/variants/fps_unpruned.cu's `fps_unpruned_launch` (the
    unpruned fps_kernel) and `fps_unpruned_cluster_launch` (the unpruned
    cluster) at the same cs; scripts/variants/fps_pr21.cu's or a parent's
    `fps_launch` / `fps_cluster_launch` (no block size; a parent's without
    a counter) likewise, or at the power-of-two cs (`pr16_fps_cs`) for a
    file with no `fps_cluster_resident`; `fps_sub_launch`
    (scripts/variants/fps_sub_boxes.cu, sub-boxes in fps_kernel's update)
    up to 16,384 points, `fps_flat_cluster_launch`
    (scripts/variants/fps_flat_exchange.cu) at the wrapper's instance and,
    alone on the first slice, at cs = 1 (`"flat_split"` line),
    `fps_row_launch` (scripts/variants/fps_row_l2.cu, one block a row, the
    row in L2), `fps_barrier_launch` (scripts/variants/fps_cluster_barrier.cu,
    a cluster barrier a pick) and `fps_stream_launch`
    (scripts/variants/fps_one_block.cu: one block a row): differing picks
    against the plain version, the CUDA-event ms of a launch (mean of
    REPS), us a pick and, for a design with the counter, the share of its
    warp updates skipped (and for the sub-boxes of its sub-box updates,
    `sub_skipped_share`)."""
    stream = torch._C._cuda_getCurrentRawStream(0)
    floor_us = {}  # each source's fps_kernel at one point a thread
    for site, rows, n, s in FPS_SITES:
        xyz = plot_clouds(torch, gen, rows, n, device_)
        start = torch.randint(0, n, (rows,), generator=gen, device=device_, dtype=torch.int32)
        want = ck.fps_plain(xyz, s, start)
        md = torch.empty((rows, n), device=device_)
        stats = torch.zeros(4, dtype=torch.int64, device=device_)
        glob = int(n > ck.FPS_CLUSTER_MAX * ck.FPS_MAX_N)
        fns = {}
        sliced = {}  # the first slice of every row alone, at the wrapper's instance

        def first_slice(cs):
            if not sliced:
                length = -(-n // cs)
                part, pstart = xyz[:, :length].contiguous(), start % length
                sliced.update(part=(part, pstart, ck.fps_plain(part, min(s, length), pstart)))
            return sliced["part"]

        def add(label, lib, src, symbol, cs, scratch, threads=None, part=None):
            """label -> (cs, counter, call(out, counted), its picks) for
            entry `symbol`: pointers xyz, start, out (then md where the
            entry takes it, the counter where it takes one), ints rows, n,
            s (then cs on a cluster entry, then the block size where the
            entry takes one); `part` the (xyz, start, want) of a slice
            instead."""
            px, pstart, pwant = part or (xyz, start, want)
            pn, ps = px.shape[1], pwant.shape[1]
            cluster = "cluster" in symbol or "barrier" in symbol
            counter = takes(src, symbol, "unsigned long long* stats")
            md_arg = takes(src, symbol, "float* md")
            sized = takes(src, symbol, "int threads")
            n_ptrs = 3 + md_arg + counter
            fn = entry(lib, symbol, n_ptrs, 3 + cluster + sized)
            fns[label] = (cs, counter, lambda out, counted=False: fn(
                px.data_ptr(), pstart.data_ptr(), out.data_ptr(),
                *([md.data_ptr() if scratch else None] if md_arg else []),
                *([stats.data_ptr() if counted else None] if counter else []),
                rows, pn, ps, *([cs] if cluster else []),
                *([threads or ck.FPS_THREADS] if sized else []), stream), pwant)

        instance = None  # the wrapper's (cs, threads), from the package's library
        for src, lib in libs.items():
            if any(hasattr(lib, e) for e in FPS_VARIANT_ENTRIES):
                continue
            if n <= ck.FPS_MAX_N:
                for symbol in ("fps_launch", "fps_unpruned_launch"):
                    if hasattr(lib, symbol):
                        add((src, symbol.removesuffix("_launch")), lib, src, symbol, 1, False)
                continue
            if hasattr(lib, "fps_cluster_resident"):
                sized = takes(src, "fps_cluster_launch", "int threads")
                res = entry(lib, "fps_cluster_resident", 0, 3 + sized)
                res.argtypes = [ctypes.c_int] * (3 + sized)
                blocks = ((ck.FPS_THREADS, ck.FPS_PAIR_THREADS) if sized and not glob
                          else (ck.FPS_THREADS,))
                resident = {t: {cs: res(n, cs, *([t] if sized else []), glob)
                                for cs in (range(2, ck.FPS_CLUSTER_MAX + 1) if glob
                                           else ck._fps_sizes(n, t))} for t in blocks}
                print(json.dumps({"source": str(src), "site": site, "resident_clusters": resident,
                                  "table": ck.FPS_RESIDENT}), flush=True)
                _, pick, pick_t = ck.fps_path(n, rows, resident)
                options = [(pick_t, pick)] + [
                    (t, cs) for t in blocks for cs in (range(2, ck.FPS_CLUSTER_MAX + 1) if glob
                                                       else ck._fps_sizes(n, t))
                    if (t, cs) != (pick_t, pick) and site != "global"]
                for t, cs in options:
                    label = "cluster" if (t, cs) == (pick_t, pick) else f"cluster{t}_cs{cs}"
                    add((src, label), lib, src, "fps_cluster_launch", cs, glob, t)
                    if hasattr(lib, "fps_unpruned_cluster_launch") and not glob and label == "cluster":
                        add((src, "unpruned_cluster"), lib, src, "fps_unpruned_cluster_launch",
                            cs, False)
                if sized and not glob:  # the exchange's share: the row's first slice alone
                    instance = (pick, pick_t)
                    add((src, "slice_cluster_cs1"), lib, src, "fps_cluster_launch", 1, False,
                        pick_t, first_slice(pick))
                    add((src, "slice_block"), lib, src, "fps_launch", 1, False,
                        part=first_slice(pick))
            elif hasattr(lib, "fps_cluster_launch"):  # PR 16's file
                add((src, "cluster_pr16"), lib, src, "fps_cluster_launch", pr16_fps_cs(n), glob)
            if hasattr(lib, "fps_barrier_launch"):
                add((src, "barrier"), lib, src, "fps_barrier_launch", pr16_fps_cs(n), glob)
            if hasattr(lib, "fps_stream_launch"):
                fn = entry(lib, "fps_stream_launch", 4, 3)
                fns[(src, "stream")] = (1, False, lambda out, counted=False, fn=fn: fn(
                    xyz.data_ptr(), start.data_ptr(), out.data_ptr(), md.data_ptr(), rows, n, s,
                    stream), want)
        for src, lib in libs.items():  # the variants that include the package's source
            if n <= ck.FPS_MAX_N:
                if hasattr(lib, "fps_sub_launch"):
                    add((src, "sub"), lib, src, "fps_sub_launch", 1, False)
                continue
            if hasattr(lib, "fps_flat_cluster_launch") and not glob and instance:
                pick, pick_t = instance
                add((src, "flat"), lib, src, "fps_flat_cluster_launch", pick, False, pick_t)
                add((src, "slice_flat_cs1"), lib, src, "fps_flat_cluster_launch", 1, False,
                    pick_t, first_slice(pick))
            if hasattr(lib, "fps_row_launch") and not glob:  # one block a row, the row in L2
                rpts = lib.fps_row_pts(n)
                if rpts > 0:
                    fn = entry(lib, "fps_row_launch", 5, 3)
                    sorted_ = torch.empty((rows, rpts * ck.FPS_THREADS, 4), device=device_)
                    fns[(src, "row_l2")] = (1, True, lambda out, counted=False, fn=fn, t=sorted_: fn(
                        xyz.data_ptr(), start.data_ptr(), out.data_ptr(), t.data_ptr(),
                        stats.data_ptr() if counted else None, rows, n, s, stream), want)
        us = {}
        for key in list(fns) + list(fns)[::-1]:
            cs, counter, call, pwant = fns[key]
            out = torch.empty_like(pwant)
            stats.zero_()
            rc = call(out, True)
            torch.cuda.synchronize()
            skipped, possible, sub_skipped, sub_possible = stats.tolist()
            ms = event_ms(torch, lambda: call(out))
            us.setdefault(key, []).append(ms / (pwant.shape[1] - 1) * 1e3)
            print(json.dumps({
                "source": str(key[0]), "kernel": "fps", "design": key[1], "site": site, "rc": rc,
                "shape": [rows, n, s] if pwant is want else [rows, *pwant.shape[1:], "slice"],
                "cs": cs, "differing": int((out != pwant).sum()), "ms": ms,
                "us_a_pick": us[key][-1],
                "skipped_share": skipped / possible if counter and possible else None,
                **({"sub_skipped_share": sub_skipped / sub_possible} if sub_possible else {}),
            }), flush=True)

        def mean(key):
            return sum(us[key]) / len(us[key]) if key in us else None

        for src in libs:
            row, one, block = ((src, "cluster"), (src, "slice_cluster_cs1"), (src, "slice_block"))
            if site == "chain_floor" and (src, "fps") in us:
                floor_us[src] = mean((src, "fps"))
            if one in us:
                print(json.dumps({
                    "source": str(src), "site": site, "exchange_split": True,
                    "row_us_a_pick": mean(row), "slice_alone_cs1_us_a_pick": mean(one),
                    "slice_block_us_a_pick": mean(block), "chain_floor_us_a_pick": floor_us.get(src),
                    "cluster_exchange_us_a_pick": mean(row) - mean(one),
                    "cs1_vs_block_us_a_pick": mean(one) - mean(block),
                    "slice_points_us_a_pick": (mean(block) - floor_us[src]
                                               if src in floor_us else None)}), flush=True)
            if (src, "flat") in us:
                print(json.dumps({
                    "source": str(src), "site": site, "flat_split": True,
                    "row_us_a_pick": mean((src, "flat")),
                    "slice_alone_cs1_us_a_pick": mean((src, "slice_flat_cs1")),
                    "cluster_exchange_us_a_pick": mean((src, "flat")) - mean((src, "slice_flat_cs1"))
                }), flush=True)
        del xyz, md, want, sliced


# The grouped selection's sites (`run_selection`): (site, cloud, B, N, C, K,
# radius). The dense plots' SA1 (groups of 2,048: the cell grid), on uniform
# 20 m plots and on the clouds that stress the culling: 90% of the points in
# 5% of the plot ("clustered"), plots 1 km from the origin ("shifted": the
# culling radius's margin widens the cells), points sorted by x ("sorted":
# each group a strip of the plot), and a radius over the whole plot (one
# cell: every point scored, every pair within the radius; B=2); then PROD's
# SA1 (groups of 313, staged whole), where the grid path is timed beside
# the PROD kernels without being taken.
SEL_SITES = (("dense_SA1", "uniform", 20, 65536, 16384, 32, 2 ** 0.5),
             ("dense_SA1_clustered", "clustered", 20, 65536, 16384, 32, 2 ** 0.5),
             ("dense_SA1_shifted", "shifted", 20, 65536, 16384, 32, 2 ** 0.5),
             ("dense_SA1_sorted", "sorted", 20, 65536, 16384, 32, 2 ** 0.5),
             ("dense_SA1_one_cell", "uniform", 2, 65536, 16384, 32, 30.0),
             ("PROD_SA1", "uniform", 20, 10000, 2500, 32, 2 ** 0.5))


def sel_cloud(torch, gen, kind, b, n, device_):
    """A (B, N, 3) cloud of SEL_SITES."""
    pts = plot_clouds(torch, gen, b, n, device_)
    if kind == "clustered":
        side = 20 * 0.05 ** 0.5
        crowd = torch.rand((b, n), generator=gen, device=device_) < 0.9
        square = (torch.rand((b, n, 2), generator=gen, device=device_) - 0.5) * side
        pts[..., :2] = torch.where(crowd[..., None], square, pts[..., :2])
    elif kind == "shifted":
        pts[..., :2] += 1000.0
    elif kind == "sorted":
        pts = torch.gather(pts, 1, pts[..., 0].argsort(dim=1)[..., None].expand(b, n, 3))
    return pts.contiguous()


def run_selection(torch, ck, libs, gen, device_):
    """The grouped selection at SEL_SITES, the
    standalone query (ball_query) and the SA eval kernel's SA1 instance (16
    -> 16, two layers), each design a source's library exports, in turns A,
    B, ..., B, A: the package's whole-group kernels where the groups fit
    (PROD), its cell-grid path (`*_grid_launch`) at every site, the earlier
    chunked design (`*_chunked_launch`, scripts/variants/selection_chunked.cu)
    past the slices, and a parent's entries. First each library's grid
    query scan loop (chip_smoke.sass_per_pair on its LDG.128 loads, the
    fold's retry loop nested). Then a line a design and site: the CUDA-event
    ms of a call (mean of REPS), the device ms of each kernel of the grid
    path (torch.profiler), the pairs the grid scores (`ballquery.
    nearest_cells`) against all pairs, and the entries that differ from the
    first design's output (bit for bit) and, for the query, from the plain
    version."""
    from stratanet2_tpu_torch.ops.ballquery import nearest_cells, radius_sq

    stream = torch._C._cuda_getCurrentRawStream(0)
    for src, lib in libs.items():
        sass = subprocess.run([str(_nvcc_dir() / "cuobjdump"), "-sass", lib._name],
                              capture_output=True, text=True, check=True).stdout
        cents = constants(src, headers=True).get("kCullCents", 1)
        loops = {f: dict(v, centroids_a_point=cents) for f, v in
                 chip_smoke.sass_per_pair(sass, cents, r"LDG\.E\S*\.128", nested=True).items()
                 if "grouped_cull" in f}
        print(json.dumps({"source": str(src), "grid_query_loops": loops}), flush=True)
    for site, kind, b, n, c, k, radius in SEL_SITES:
        pts = sel_cloud(torch, gen, kind, b, n, device_)
        cent = pts[:, torch.randperm(n, generator=gen, device=device_)[:c]].contiguous()
        g, r2 = -(-n // k), radius_sq(radius)
        ch, two = 16, True
        q = torch.randn((b, n, ch), generator=gen, device=device_)
        cterm = torch.randn((b, c, ch), generator=gen, device=device_)
        prm = torch.cat([torch.rand(ch, generator=gen, device=device_) + 0.5,
                         torch.rand(ch, generator=gen, device=device_) - 0.5,
                         (torch.randn((ch, ch), generator=gen, device=device_) * 0.25).reshape(-1),
                         torch.rand(ch, generator=gen, device=device_) - 0.5,
                         torch.rand(ch, generator=gen, device=device_) + 0.5,
                         torch.rand(ch, generator=gen, device=device_) - 0.5])
        cells = nearest_cells(cent, pts, radius)
        scored = float(cells.scored.sum())
        del cells
        want_idx, want_mask = ck.ball_query_plain(cent, pts, radius, k)
        ws, gmax = ck._cell_workspace(b, n, c, device_)
        picks = torch.empty((b, c, k), dtype=torch.int32, device=device_)
        max_g = {"ball_query": ck.BQ_MAX_G, "sa": ck.sa_fused_eval_max_g(ch, ch, two, k)}
        for kernel in ("ball_query", "sa"):
            fns = {}
            gc = min(g, max_g[kernel])
            for src, lib in libs.items():
                # a library without a grid entry is a parent tree's:
                # its entry stages gc points at once, whole groups or chunks
                prefix = "ball_query" if kernel == "ball_query" else "sa_fused_eval"
                grid_entry = hasattr(lib, f"{prefix}_grid_launch")
                if kernel == "ball_query" and hasattr(lib, "ball_query_launch"):
                    def out():
                        return (torch.empty((b, c, k), dtype=torch.int32, device=device_),
                                torch.empty((b, c, k), dtype=torch.bool, device=device_))
                    base = [cent, pts]
                    if not grid_entry:
                        fn = fentry(lib, "ball_query_launch", 4, 6)
                        fns[(src, "parent")] = (out, lambda o, fn=fn: fn(
                            *ptrs(base + list(o)), b, n, c, k, g, gc, r2, stream))
                        continue
                    if g <= max_g[kernel]:
                        fn = fentry(lib, "ball_query_launch", 4, 5)
                        fns[(src, "whole")] = (out, lambda o, fn=fn: fn(
                            *ptrs(base + list(o)), b, n, c, k, g, r2, stream))
                    elif hasattr(lib, "ball_query_chunked_launch"):
                        fn = fentry(lib, "ball_query_chunked_launch", 4, 6)
                        fns[(src, "chunked")] = (out, lambda o, fn=fn: fn(
                            *ptrs(base + list(o)), b, n, c, k, g, gc, r2, stream))
                    fn = grid_call(src, lib, "ball_query_grid_launch", 5, 5)
                    fns[(src, "grid")] = (out, lambda o, fn=fn: fn(
                        base + list(o) + [ws], [b, n, c, k, gmax], r2,
                        ck.cell_grid_cluster(b, n + c), stream))
                elif kernel == "sa" and hasattr(lib, "sa_fused_eval_launch"):
                    def out():
                        return (torch.empty((b, c, ch), device=device_),)
                    base = [q, pts, cent, cterm, prm]
                    if not grid_entry:
                        fn = fentry(lib, "sa_fused_eval_launch", 6, 9)
                        fns[(src, "parent")] = (out, lambda o, fn=fn: fn(
                            *ptrs(base + list(o)), b, n, c, k, g, gc, ch, ch, int(two), r2,
                            stream))
                        continue
                    if g <= max_g[kernel]:
                        fn = fentry(lib, "sa_fused_eval_launch", 6, 8)
                        fns[(src, "whole")] = (out, lambda o, fn=fn: fn(
                            *ptrs(base + list(o)), b, n, c, k, g, ch, ch, int(two), r2, stream))
                    elif hasattr(lib, "sa_fused_eval_chunked_launch"):
                        fn = fentry(lib, "sa_fused_eval_chunked_launch", 6, 9)
                        fns[(src, "chunked")] = (out, lambda o, fn=fn: fn(
                            *ptrs(base + list(o)), b, n, c, k, g, gc, ch, ch, int(two), r2,
                            stream))
                    fn = grid_call(src, lib, "sa_fused_eval_grid_launch", 8, 8)
                    fns[(src, "grid")] = (out, lambda o, fn=fn: fn(
                        base + list(o) + [ws, picks], [b, n, c, k, gmax, ch, ch, int(two)], r2,
                        ck.cell_grid_cluster(b, n + c), stream))
            first = None
            for key in list(fns) + list(fns)[::-1]:
                make, call = fns[key]
                o = make()
                rc = call(o)
                torch.cuda.synchronize()
                first = o if first is None else first
                differing = sum(int((x != y).sum()) for x, y in zip(o, first))
                if kernel == "ball_query":
                    plain_diff = int((o[0] != want_idx).sum()) + int((o[1] != want_mask).sum())
                else:
                    plain_diff = None
                row = {"source": str(key[0]), "kernel": kernel, "design": key[1], "site": site,
                       "rc": rc, "shape": [b, n, c, k, g], "radius": radius,
                       "differing_from_first": differing, "differing_from_plain": plain_diff,
                       "ms": event_ms(torch, lambda: call(o)),
                       "all_pairs": float(b * c * n), "grid_scored_pairs": scored,
                       "grid_scored_share": scored / (b * c * n)}
                if key[1] == "grid":
                    parts = (("ball_query_grid_kernel", "grouped_cull_kernel")
                             if kernel == "ball_query"
                             else ("sa_grid_kernel", "grouped_cull_kernel", "sa_apply_kernel"))
                    row["device_ms"] = {p: chip_smoke.device_profile(torch, lambda: call(o),
                                                                     (p,))[0] for p in parts}
                print(json.dumps(row), flush=True)
        del q, cterm, ws, picks, want_idx, want_mask


def _nvcc_dir():
    from stratanet2_tpu_torch.ops import _build

    return Path(_build._nvcc()).parent


RUNS = {"knn_interpolate": run_knn, "knn_grid": run_knn_grid, "cell_grid": run_cell_grid,
        "sass": lambda *a: None, "sa_train_stats": run_stats, "sa_train_main": run_main,
        "sa_train_bwd1": run_bwd1,
        "sa_train_bwd2": run_bwd2, "knn_scatter": run_knn_scatter, "pixel_max": run_pixel_max,
        "ball_query_nearest": run_ball_query_nearest, "fps": run_fps,
        "selection": run_selection}


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
