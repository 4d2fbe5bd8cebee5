"""CPU checks of the parts of chip_smoke.py and of the kernel wrappers that
need no card: the SASS parsers of phase 16 on synthetic `cuobjdump -sass`
listings (scan and slot loops, global atomics), the kNN, SA train, scatter
and pixel-max reference sites' inputs, the scatter's and pixel max's site
checks, and the kNN wrapper's split of sources across warps."""

import re
from pathlib import Path

import pytest
import numpy as np
import torch

import chip_smoke as cs
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.utils import profiling

MAIN1 = "_Z20sa_train_main_kernelILi16ELb1ELi4EEvPKfS1_PKiPKbS1_S1_PfS6_S6_PiS7_iiii"
MAIN2 = "_Z20sa_train_main_kernelILi32ELb0ELi16EEvPKfS1_PKiPKbS1_S1_PfS6_S6_PiS7_iiii"
BWD1 = "_Z20sa_train_bwd1_kernelILi16ELi4EEvPKfS1_PKiPKbS1_S1_S3_S1_Pfiiii"
BWD2_1 = "_Z20sa_train_bwd2_kernelILi16ELb1ELi4EEvPKfS1_PKiPKbS1_S1_S3_S1_PfS6_iiii"
BWD2_2 = "_Z20sa_train_bwd2_kernelILi32ELb0ELi8EEvPKfS1_PKiPKbS1_S1_S3_S1_PfS6_iiii"
STATS = "_Z21sa_train_stats_kernelILi16ELi8EEvPKfS1_PKiPKbS1_Pfiiii"  # <C1, KB>


def stats_lanes(ch):
    """The stats pass's lanes a centroid as its library gives them (a float4
    of the q row a lane)."""
    return ch // 4

# a listing in cuobjdump's layout: a kNN-like scan loop (0x10-0x80) whose
# forward branch at 0x40 skips an insert of two instructions; and the slot
# loops of the six SA train instances: the stats pass's (4 lanes a centroid,
# KB 8) and main's at SA1, each followed by a loop without a global load (the
# block's reduction), bwd2's at SA1 with a shuffle
SASS = f"""
        Function : _Z10knn_kernelPKfS0_S0_PfPiS1_iiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R8, R4, R5, R6 ;
        /*0030*/                   FSETP.GEU.AND P0, PT, R8, R9, PT ;
        /*0040*/              @P0 BRA 0x70 ;
        /*0050*/                   FMNMX R8, R8, RZ, !PT ;
        /*0060*/                   MOV R9, R8 ;
        /*0070*/                   IADD3 R2, R2, 0x10, RZ ;
        /*0080*/              @P1 BRA 0x10 ;
        /*0090*/                   EXIT ;
        Function : {STATS}
        /*0000*/                   LDG.E.128.CONSTANT R4, [R2.64] ;
        /*0010*/                   FADD R8, R4, -R9 ;
        /*0020*/                   FMNMX R8, R8, RZ, !PT ;
        /*0030*/                   FFMA R10, R8, R8, R10 ;
        /*0040*/              @P0 BRA 0x0 ;
        /*0050*/                   LDS R4, [R3] ;
        /*0060*/                   FADD R5, R5, R4 ;
        /*0070*/              @P1 BRA 0x50 ;
        /*0080*/                   EXIT ;
        Function : {MAIN1}
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.CONSTANT R2, [R4.64] ;
        /*0020*/                   STS [R3], R2 ;
        /*0030*/                   LDS.128 R8, [R3] ;
        /*0040*/                   FFMA R4, R8, R5, R6 ;
        /*0050*/              @P0 BRA 0x10 ;
        /*0060*/                   STS [R3], RZ ;
        /*0070*/                   LDS R4, [R3] ;
        /*0080*/                   FADD R5, R5, R4 ;
        /*0090*/                   STG.E [R6.64], R5 ;
        /*00a0*/              @P1 BRA 0x70 ;
        /*00b0*/                   EXIT ;
        Function : {MAIN2}
        /*0000*/                   LDG.E R2, [R4.64] ;
        /*0010*/                   FMNMX R3, R2, RZ, !PT ;
        /*0020*/              @P0 BRA 0x0 ;
        /*0030*/                   EXIT ;
        Function : {BWD1}
        /*0000*/                   LDG.E R2, [R4.64] ;
        /*0010*/                   LDS.128 R8, [R3] ;
        /*0020*/                   FFMA R4, R8, R5, R6 ;
        /*0030*/                   FMUL R4, R4, R5 ;
        /*0040*/              @P0 BRA 0x0 ;
        /*0050*/                   EXIT ;
        Function : {BWD2_1}
        /*0000*/                   SHFL.IDX R1, R2, R3, 0x1f ;
        /*0010*/                   LDG.E R7, [R8.64] ;
        /*0020*/                   FFMA R4, R4, R5, R6 ;
        /*0030*/                   STG.E [R2.64], R4 ;
        /*0040*/              @P0 BRA 0x0 ;
        /*0050*/                   EXIT ;
        Function : {BWD2_2}
        /*0000*/                   LDG.E R7, [R8.64] ;
        /*0010*/                   FFMA R4, R4, R5, R6 ;
        /*0020*/                   STG.E [R2.64], R4 ;
        /*0030*/              @P0 BRA 0x0 ;
        /*0040*/                   EXIT ;
"""


@pytest.mark.parametrize("r", [1, 2])
def test_sass_per_pair_counts_the_loop_with_and_without_the_insert(r):
    loops = cs.sass_per_pair(SASS, r)
    assert list(loops) == ["_Z10knn_kernelPKfS0_S0_PfPiS1_iiii"]
    loop = loops["_Z10knn_kernelPKfS0_S0_PfPiS1_iiii"]
    assert (loop["instructions"], loop["points"]) == (8, 1)
    assert loop["per_pair"] == 8 / r
    assert loop["common_per_pair"] == 6 / r  # the FMNMX and MOV of the insert are skipped
    assert loop["opcodes"]["BRA"] == 2


# the nearest selection's library: the grid pass (32-bit global loads and a
# compare) and the query's scan loop over sorted points in global memory,
# whose `continue` at 0x50 skips the candidate path
NEAREST_SASS = """
        Function : _Z19nearest_grid_kernelPKfS0_P6float4PiS3_S3_S3_iiif
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0010*/                   FSETP.GT.AND P0, PT, R4, RZ, PT ;
        /*0020*/              @P1 BRA 0x0 ;
        /*0030*/                   EXIT ;
        Function : _Z25ball_query_nearest_kernelILi1EEvPKfPK6float4PKiS6_S6_S6_PiPhiiiif
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   FFMA R8, R4, R5, R6 ;
        /*0030*/                   FSETP.GTU.AND P0, PT, R8, R9, PT ;
        /*0040*/                   VOTE.ANY R10, PT, P0 ;
        /*0050*/              @!P2 BRA 0x90 ;
        /*0060*/                   LDG.E.CONSTANT R11, desc[UR4][R12.64] ;
        /*0070*/                   STS.64 [R13], R10 ;
        /*0080*/                   IADD3 R14, R14, 0x1, RZ ;
        /*0090*/                   IADD3 R2, R2, 0x200, RZ ;
        /*00a0*/              @P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_per_pair_finds_the_nearest_scan_loop_by_its_global_load():
    """The nearest kernel reads its sorted points with LDG.E.128, not from
    staged shared memory: its scan loop is found by that load (the grid
    pass's 32-bit loads are not one point), and the pair that inserts
    nothing skips the candidate path."""
    assert cs.sass_per_pair(NEAREST_SASS, 1) == {}
    loops = cs.sass_per_pair(NEAREST_SASS, 1, r"LDG\.E\S*\.128")
    assert list(loops) == ["_Z25ball_query_nearest_kernelILi1EEvPKfPK6float4PKiS6_S6_S6_PiPhiiiif"]
    loop = next(iter(loops.values()))
    assert (loop["instructions"], loop["points"]) == (10, 1)
    assert loop["common_per_pair"] == 7  # the candidate path's three are skipped


# the grouped cell-grid query: its scan loop (0x10-0xb0) holds a
# compare-and-swap retry loop (0x60-0x80) behind the forward branch at 0x50
CULL_SASS = """
        Function : _Z19grouped_cull_kernelILb0EEvPKfPK6float4PKiS6_S6_S6_PiPhiiiiiif
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E.CONSTANT R8, desc[UR4][R12.64] ;
        /*0030*/                   FFMA R9, R4, R5, R6 ;
        /*0040*/                   FSETP.GTU.AND P0, PT, R9, R10, PT ;
        /*0050*/              @P0 BRA 0xa0 ;
        /*0060*/                   ATOMS.CAS.64 R14, [R11], R16, R18 ;
        /*0070*/                   ISETP.NE.U32.AND P1, PT, R14, R16, PT ;
        /*0080*/              @P1 BRA 0x60 ;
        /*0090*/                   NOP ;
        /*00a0*/                   IADD3 R2, R2, 0x200, RZ ;
        /*00b0*/              @P2 BRA 0x10 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_per_pair_finds_the_cull_scan_loop_around_its_retries():
    """The cell-grid query's scan loop is not innermost: its slot fold is a
    compare-and-swap loop. Innermost loops alone find no scan loop; with
    `nested` the loop that loads the points is found, the retry loop left
    out of its counts (and reported), and the pair that folds nothing skips
    the fold's path. Each point is scored for two centroids."""
    ldg = r"LDG\.E\S*\.128"
    assert cs.sass_per_pair(CULL_SASS, 2, ldg) == {}
    (loop,) = cs.sass_per_pair(CULL_SASS, 2, ldg, nested=True).values()
    assert (loop["instructions"], loop["points"], loop["nested"]) == (8, 1, 3)
    assert loop["per_pair"] == 4.0 and loop["common_per_pair"] == 3.5
    assert "ATOMS" not in loop["opcodes"]


def test_sass_edge_loops_count_shuffles_an_edge():
    """Each SA train instance's slot loop (the innermost loop with a global
    load), counted over its KB x 32 / L edges a pass (L lanes a centroid:
    C1 for main, bwd1 and bwd2, the library's lanes for stats)."""
    loops = cs.sass_edge_loops(SASS, stats_lanes)
    assert sorted(loops) == sorted([STATS, MAIN1, MAIN2, BWD1, BWD2_1, BWD2_2])
    cs.check_edge_loops(loops)
    want = {  # function: (kernel, C1, lanes, KB, instructions, SHFLs, FP32 instructions)
        STATS: ("sa_train_stats", 16, 4, 8, 5, 0, 3),
        MAIN1: ("sa_train_main", 16, 16, 4, 5, 0, 1), MAIN2: ("sa_train_main", 32, 32, 16, 3, 0, 1),
        BWD1: ("sa_train_bwd1", 16, 16, 4, 5, 0, 2), BWD2_1: ("sa_train_bwd2", 16, 16, 4, 5, 1, 1),
        BWD2_2: ("sa_train_bwd2", 32, 32, 8, 4, 0, 1),
    }
    for func, (kernel, ch, lanes, kb, n, shfl, fp32) in want.items():
        loop = loops[func]
        edges = kb * 32 // lanes
        assert (loop["kernel"], loop["C1"], loop["lanes"], loop["KB"], loop["edges_a_pass"]) == (
            kernel, ch, lanes, kb, edges)
        assert loop["instructions"] == n
        assert loop["per_edge"] == n / edges
        assert loop["shfl_per_edge"] == shfl / edges
        assert loop["fp32_per_edge"] == fp32 / edges


def _drop_function(sass, func):
    """`sass` without function `func`'s listing."""
    return re.sub(rf"\s*Function : {func}\n(\s*/\*[0-9a-f]+\*/.*\n)*", "\n", sass)


@pytest.mark.parametrize("func", [MAIN1, MAIN2, BWD1, BWD2_1, BWD2_2, STATS])
def test_check_edge_loops_fails_without_a_slot_loop(func):
    """Phase 16 fails when an instance's slot loop is not found: its loop has
    no global load, or the instance is missing from the listing."""
    head = SASS.index(f"Function : {func}")
    tail = SASS.find("Function :", head + 1)
    tail = len(SASS) if tail < 0 else tail
    no_load = SASS[:head] + SASS[head:tail].replace("LDG", "LDS") + SASS[tail:]
    loops = cs.sass_edge_loops(no_load, stats_lanes)
    assert loops[func] is None
    with pytest.raises(SystemExit):
        cs.check_edge_loops(loops)
    loops = cs.sass_edge_loops(_drop_function(SASS, func), stats_lanes)
    assert func not in loops and len(loops) == 5
    with pytest.raises(SystemExit):
        cs.check_edge_loops(loops)


def test_knn_reference_sites_are_tie_heavy_ragged_and_chunked():
    """The inputs of kNN's reference sites have the properties their
    comment in chip_smoke.py claims: KNN_REFERENCE's on knn_kernel, then
    KNN_GRID_REFERENCE's on the cell grid at the dense FP1 shape."""
    calls = cs.knn_reference_calls(torch, torch.device("cpu"))
    sites = cs.KNN_REFERENCE + cs.KNN_GRID_REFERENCE
    assert len(calls) == len(sites)
    for (kind, b, s, t, f), (x, src, tgt) in zip(sites, calls):
        assert (x.shape, src.shape, tgt.shape) == ((b, s, f), (b, s, 3), (b, t, 3))
        assert x.dtype == src.dtype == tgt.dtype == torch.float32
        if kind == "grid":
            assert torch.equal(src, src.round()) and torch.equal(tgt, tgt.round())
            half = s // 2
            assert torch.equal(src[:, half : half + s // 8], src[:, : s // 8])
            on_src = (tgt[:, : t // 8, None] == src[:, None]).all(-1).any(-1)
            assert bool(on_src.all())
        elif kind == "shifted":
            assert float(src[..., :2].min()) > 980 and float(tgt[..., :2].min()) > 980
        elif kind == "clustered":
            share, side = cs.NEAREST_CLUSTER
            crowd = (tgt[..., :2].abs() <= side / 2).all(-1).float().mean()
            assert abs(float(crowd) - share) < 0.02
        elif kind == "sorted":
            assert bool((src[:, 1:, 0] >= src[:, :-1, 0]).all())
        elif kind == "far":  # every target off the sources' extent by KNN_FAR - 20 m
            assert float((tgt[..., 0].amin(1) - src[..., 0].amax(1)).min()) > cs.KNN_FAR - 20.5
    kinds = {kind: (s, t) for kind, _, s, t, _ in cs.KNN_REFERENCE}
    assert kinds["s3"][0] == 3
    assert all(v % 32 for v in kinds["ragged"])
    assert kinds["chunked"][0] > 4096  # csrc/knn_interpolate.cu stages 4096 sources at once
    # KNN_REFERENCE runs on knn_kernel ("chunked" through knn_whole), the
    # grid sites on the cell grid at the dense FP1 shape
    assert all(ck.knn_path(s, t) == "whole" for kind, _, s, t, _ in cs.KNN_REFERENCE
               if kind != "chunked")
    assert ck.knn_path(*kinds["chunked"]) == "grid"
    with cs.knn_whole(ck):
        assert ck.knn_path(*kinds["chunked"]) == "whole"
    assert ck.knn_path(*kinds["chunked"]) == "grid"
    assert all(ck.knn_path(s, t) == "grid" and (s, t) == (16384, 65536)
               for _, _, s, t, _ in cs.KNN_GRID_REFERENCE)


@pytest.fixture(scope="module")
def sa_reference_calls():
    return cs.sa_train_reference_calls(torch, ck, torch.device("cpu"))


@pytest.mark.parametrize("site", range(len(cs.SA_TRAIN_REFERENCE)))
def test_sa_train_reference_sites_are_tie_heavy_and_ragged(sa_reference_calls, site):
    """The inputs of the SA train passes' reference sites have the
    properties their comment in chip_smoke.py claims."""
    b, n, c, k, ch = cs.SA_TRAIN_REFERENCE[site]
    assert {name: len(v) for name, v in sa_reference_calls.items()} == cs.SA_TRAIN_REF_SITES
    q, cterm, idx, mask, aff, w2 = sa_reference_calls["sa_train_main"][site]
    assert (q.shape, cterm.shape, idx.shape) == ((b, n, ch), (b, c, ch), (b, c, k))
    assert (w2 is not None) == (ch == 16)
    assert torch.equal(q, q.round()) and torch.equal(cterm, cterm.round())
    assert all(k % kb for kb in (2, 4, 8, 16))  # the last batch is cut for every KB tried
    assert (b * c) % (ck.SA_THREADS // ch)  # the last block's groups are not all used
    for kb in (2, 4, 8, 16):  # batches that hold masked and valid slots
        m = mask[..., : k - k % kb].reshape(b, c, -1, kb)
        assert float((m.any(-1) & ~m.all(-1)).float().mean()) > 0.3
    empty = ~mask.any(2)
    assert 0.15 < float(empty.float().mean()) < 0.25
    _, _, vmax, _, amax, _ = ck.sa_train_main_plain(q, cterm, idx, mask, aff, w2)
    assert bool((vmax[empty] == ck.NEG).all()) and bool((amax[empty] == 0).all())
    e = ck.sa_train_edges(q, cterm, idx, mask, aff, w2)
    h = torch.where(e["m"], e["h"], ck.NEG)
    tied = ((h == vmax[:, :, None]) & e["m"]).sum(2) > 1  # the max is reached at two slots
    assert float(tied[~empty].float().mean()) > 0.5
    bwd = sa_reference_calls["sa_train_bwd2"][site]
    assert torch.equal(bwd[6], amax) and bwd[7].shape == (b, c, ch)


@pytest.mark.parametrize("name,site", [(name, site) for name, n in cs.SA_TRAIN_REF_SITES.items()
                                       for site in range(n)])
def test_sa_train_reference_sites_pass_the_smoke_checks(sa_reference_calls, name, site,
                                                        monkeypatch):
    """At each SA train reference site, chip_smoke's comparison passes a
    result equal to the plain version, and its float32 bound rejects a
    result of zeros and, for the sums over edges, one with block 0's
    partial row taken out: the checks are not vacuous there. (The stats
    pass's lanes, read from its library on the card, are given here.)"""
    monkeypatch.setattr(ck, "sa_train_stats_lanes", stats_lanes)
    args = sa_reference_calls[name][site]
    want = getattr(ck, f"{name}_plain")(*args)
    shape, nbytes, ops, err = cs.compare_sa_train_site(torch, ck, name, site, args, want, want)
    assert err == 0.0 and nbytes > 0 and ops > 0
    assert f"K={args[2].shape[2]}" in shape


@pytest.mark.parametrize("b,t,slices", [(20, 10000, 2), (20, 2500, 8), (200, 10000, 1),
                                        (2, 33, 8), (32, 2500, 4)])
def test_knn_slices_fill_the_card(b, t, slices):
    """The fewest warps a target group that give 64 warps an SM of 132."""
    assert ck.knn_slices(b, t) == slices
    if slices < ck.KNN_WARPS:
        assert b * -(-t // 32) * slices >= ck.KNN_MIN_WARPS
    if slices > 1:
        assert b * -(-t // 32) * (slices // 2) < ck.KNN_MIN_WARPS


DQ_16 = "_Z18sa_train_dq_kernelILi16ELb0EEvPKfPKiPKbPfiiiiii"
# phase 16's atomics check: the kernels that write each output element once,
# with shared-memory atomics only (ATOMS, not counted)
ATOMIC_SASS = f"""
        Function : _Z18knn_scatter_kernelILb1EEvPKiPKfS3_Pfiiiii
        /*0000*/                   ATOMS.ADD RZ, [R2], R3 ;
        /*0010*/                   LDG.E R4, [R6.64] ;
        /*0020*/                   STG.E [R8.64], R4 ;
        /*0030*/                   EXIT ;
        Function : _Z16pixel_max_kernelPKiPKfPfPiiiii
        /*0000*/                   ATOMS.CAS.64 R4, [R2], R4, R6 ;
        /*0010*/                   STG.E [R8.64], R4 ;
        /*0020*/                   EXIT ;
        Function : {BWD2_1}
        /*0000*/                   LDG.E R4, [R6.64] ;
        /*0010*/                   STG.E [R8.64], R4 ;
        /*0020*/                   EXIT ;
        Function : {DQ_16}
        /*0000*/                   ATOMS.ADD RZ, [R2], R3 ;
        /*0010*/                   STG.E [R8.64], R4 ;
        /*0020*/                   EXIT ;
        Function : _Z23sa_train_dq_keys_kernelPKiPKbPiiii
        /*0000*/                   LDG.E R4, [R6.64] ;
        /*0010*/                   STG.E [R8.64], R4 ;
        /*0020*/                   EXIT ;
"""


@pytest.mark.parametrize("kernel", [kernel for kernel, _ in cs.ATOMIC_FREE])
def test_atomics_check_passes_shared_atomics_and_fails_a_global_one(kernel):
    """The listing's shared atomics pass; a global float RED, an ATOMG or a
    REDG in the kernel fails phase 16, and so does a kernel missing from
    the listing."""
    counts = cs.global_atomics(ATOMIC_SASS, kernel)
    assert list(counts.values()) == [0]
    cs.check_no_atomics(counts, kernel)
    for bad in ("RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R8.64], R4",
                "@P0 ATOMG.E.MAX.STRONG.GPU PT, R5, [R8.64], R4",
                "REDG.E.ADD.F32.FTZ.RN.STRONG.GPU [R8.64], R4"):
        counts = cs.global_atomics(ATOMIC_SASS.replace("STG.E [R8.64], R4", bad), kernel)
        assert list(counts.values()) == [1]
        with pytest.raises(SystemExit):
            cs.check_no_atomics(counts, kernel)
    with pytest.raises(SystemExit):
        cs.check_no_atomics(cs.global_atomics(ATOMIC_SASS, "sa_kernel"), "sa_kernel")


def test_atomic_free_kernels_are_the_wrappers_device_kernels():
    """Phase 16's atomics check covers every device kernel of the scatter
    wrappers and of sa_train_bwd2 (its edge and dq passes), each from the
    library its wrapper loads."""
    want = {(kernel, ck._ENTRIES[name][0]) for name in ("knn_scatter", "pixel_max",
                                                         "sa_train_bwd2")
            for kernel in cs.DEVICE_KERNELS[name]}
    assert set(cs.ATOMIC_FREE) == want
    src = (Path(ck.__file__).parent / "csrc" / "sa_train.cu").read_text()
    assert "launch_bwd2<16, true" in src and "launch_bwd2<32, false" in src
    assert "sa_train_dq_kernel<C, true> : sa_train_dq_kernel<C, false>" in src


def _degrees(idx, s):
    """(B, S) contributions a row, ids outside [0, S) left out."""
    valid = (idx >= 0) & (idx < s)
    deg = torch.zeros((idx.shape[0], s + 1), dtype=torch.long)
    deg.scatter_add_(1, torch.where(valid, idx, s).long().reshape(idx.shape[0], -1),
                     torch.ones(idx[:, 0].numel() * idx.shape[1], dtype=torch.long)
                     .reshape(idx.shape[0], -1))
    return deg[:, :s]


def test_knn_scatter_reference_sites_are_hot_and_ragged():
    """The inputs of knn_scatter's synthetic sites have the properties their
    comment in chip_smoke.py claims."""
    calls = cs.knn_scatter_reference_calls(torch, torch.device("cpu"))
    assert len(calls) == len(cs.KNN_SCATTER_REFERENCE)
    for (kind, b, k, t, s, f), (idx, w, g, s_arg) in zip(cs.KNN_SCATTER_REFERENCE, calls):
        assert (idx.shape, idx.dtype, g.shape, s_arg) == ((b, k, t), torch.int32, (b, t, f), s)
        deg = _degrees(idx, s)
        if kind == "hot":
            assert w is None and bool(((idx >= 0) & (idx < s)).all())
            assert (t, s, f) == (625 * 64, 2500, 32)  # phase 10's gather site, SA2's slots
            assert 0.19 < float((idx == 0).float().mean()) < 0.21
            # row 0 spans many chunks in every round
            assert int(deg[:, 0].min()) * ck.KNN_SCATTER_PAIRS // (k * t) > 8 * ck.KNN_SCATTER_CHUNK
        else:
            assert w is not None and w.shape == idx.shape
            assert all(s % rows and t % rows for rows in (32, 64, 128, 193, 256))
            assert (k * t) % ck.KNN_SCATTER_PAIRS and (k * t) % 4096
            assert int((deg == 0).sum(1).min()) >= s // 10  # a band of empty rows
            outside = (idx < 0) | (idx >= s)
            assert 0.005 < float(outside.float().mean()) < 0.02
            assert bool((idx == -1).any()) and bool((idx >= s).any())


def test_pixel_max_reference_sites_tie_across_cluster_blocks():
    """The inputs of pixel_max's reference sites have the properties their
    comment in chip_smoke.py claims, for every cluster size tried; the
    large tables' sites take several pixel ranges, the one at P = 100 with
    equal maxima on both sides of its ranges' boundary."""
    calls = cs.pixel_max_reference_calls(torch, torch.device("cpu"))
    assert len(calls) == len(cs.PIXEL_MAX_REFERENCE)
    for (kind, b, n, p), (pix, vals, p2) in zip(cs.PIXEL_MAX_REFERENCE, calls):
        assert (pix.shape, vals.shape, p2) == ((b, n), (b, n, 3), p * p) and p != 20
        inside = (pix >= 0) & (pix < p2)
        vmax, amax = ck.pixel_max_plain(pix, vals, p2)
        assert bool((~inside).any()) and bool((amax[..., 0] < 0).any())
        per = ck.pixel_max_range(p2, 3)
        assert (per < p2) == (p >= 100)
        if kind == "tiny":
            for size in (4, 8):  # the last block of the cluster gets no point
                assert (size - 1) * -(-n // size) >= n
            continue
        if kind == "wide":  # 19 ranges, most pixels empty
            assert -(-p2 // per) == 19 and float((amax[..., 0] < 0).float().mean()) > 0.9
            continue
        if per < p2:  # a maximum value on both sides of the first boundary
            occupied = amax[0, :, 0] >= 0
            left = set(vmax[0, :per, 0][occupied[:per]].tolist())
            right = set(vmax[0, per:2 * per, 0][occupied[per:2 * per]].tolist())
            assert max(left) == max(right)
        assert torch.equal(vals * 2, (vals * 2).round())
        assert all(n % m for m in (2, 4, 8, 256, 512, 1024))
        index = torch.where(inside, pix, p2).long()[..., None].expand(b, n, 3)
        top = torch.cat([vmax, torch.full((b, 1, 3), ck.NEG)], 1).gather(1, index)
        at_max = inside[..., None] & (vals == top)
        for size in (2, 4, 8):
            block = torch.arange(n) // -(-n // size)
            blocks = torch.zeros((b, p2 + 1, 3))
            for r in range(size):
                hit = torch.zeros((b, p2 + 1, 3)).scatter_reduce(
                    1, index, (at_max & (block == r)[None, :, None]).float(), "amax")
                blocks += hit
            occupied = amax >= 0
            assert float((blocks[:, :p2] >= 2)[occupied].float().mean()) > 0.2


@pytest.fixture
def smoke_on_cpu(monkeypatch):
    """chip_smoke's site checks on the CPU: no timing, a profile that saw
    ten launches and nothing else, and the kernel's order of sums standing
    in for the scatter kernel."""
    monkeypatch.setattr(profiling, "time_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(cs, "device_profile", lambda *a, **k: (0.0, 10, 10))
    monkeypatch.setattr(ck, "knn_scatter", ck.knn_scatter_ordered_plain)
    monkeypatch.setattr(ck, "knn_scatter_rows", lambda *a: 32)


@pytest.fixture(scope="module")
def scatter_calls():
    return cs.knn_scatter_reference_calls(torch, torch.device("cpu"))


@pytest.mark.parametrize("site", range(len(cs.KNN_SCATTER_REFERENCE)))
def test_knn_scatter_reference_sites_pass_the_smoke_checks(smoke_on_cpu, scatter_calls, site):
    """A result in the kernel's order passes every check of the site: two
    launches equal, equal to the ordered plain, within the any-order bound
    of the plain version, empty rows 0."""
    args = scatter_calls[site]
    shape, nbytes, ops, err, _, plain = cs.knn_scatter_site(torch, ck, site, args)
    assert nbytes > 0 and ops > 0 and err < 1e-3
    assert plain().shape == (args[0].shape[0], args[3], args[2].shape[2])


@pytest.mark.parametrize("bad", [-1, "S"])
def test_knn_scatter_site_rejects_unweighted_ids_out_of_range(smoke_on_cpu, scatter_calls, bad):
    """Without weights (the gather backward) an id outside [0, S) is a bug
    of the caller, and the site check fails on it; with weights (the kNN
    backward's reference site) such ids are skipped by design."""
    idx, w, g, s = scatter_calls[0]
    assert w is None
    idx = idx.clone()
    idx[0, 0, 5] = s if bad == "S" else bad
    with pytest.raises(SystemExit, match="ids outside"):
        cs.knn_scatter_site(torch, ck, 0, (idx, w, g, s))


@pytest.mark.parametrize("site", range(len(cs.KNN_SCATTER_REFERENCE)))
def test_knn_scatter_smoke_checks_reject_another_order_and_an_unstable_one(
        smoke_on_cpu, scatter_calls, monkeypatch, site):
    """A scatter that sums in rounds of half the kernel's pairs fails the
    bit-for-bit check against the ordered plain; one whose two launches
    differ fails the determinism check."""
    args = scatter_calls[site]
    half = ck.KNN_SCATTER_PAIRS // 2
    monkeypatch.setattr(ck, "knn_scatter",
                        lambda idx, w, g, s: ck.knn_scatter_ordered_plain(idx, w, g, s, half))
    with pytest.raises(SystemExit, match="differ from the ordered plain"):
        cs.knn_scatter_site(torch, ck, site, args)
    calls = []

    def unstable(idx, w, g, s):
        calls.append(1)
        return ck.knn_scatter_ordered_plain(idx, w, g, s, half if len(calls) % 2 else
                                            ck.KNN_SCATTER_PAIRS)

    monkeypatch.setattr(ck, "knn_scatter", unstable)
    with pytest.raises(SystemExit, match="two launches differ"):
        cs.knn_scatter_site(torch, ck, site, args)


def card_route_bwd2(q, cterm, idx, mask, aff, w2, awin, gt, edges=False):
    """sa_train_bwd2 as it runs on the card: the per-edge de0 (0 on a masked
    slot) as an edge buffer, summed into dq in the dq pass's order."""
    b, n, ch1 = q.shape
    c, k = idx.shape[1:]
    de = ck.sa_train_edges(q, cterm, idx, mask, aff, w2, awin, gt)["de0"].reshape(b, c * k, ch1)
    out = (ck.sa_train_dq_ordered_plain(de, idx, mask, n), -ck._sum64(de.view(b, c, k, ch1), 2))
    return (*out, de) if edges else out


@pytest.mark.parametrize("site", range(cs.SA_TRAIN_REF_SITES["sa_train_bwd2"]))
def test_bwd2_dq_checks_pass_the_card_route_and_reject_others(
        smoke_on_cpu, sa_reference_calls, monkeypatch, site):
    """At each sa_train_bwd2 reference site, chip_smoke's dq checks pass the
    card's route (edge buffer + the dq pass's fixed order) and reject a dq
    summed in decreasing edge order, a dq summed in float64 and rounded
    once (within any-order bounds, not the kernel's order), an edge buffer
    with a value on a masked slot, and two calls that differ."""
    args = sa_reference_calls["sa_train_bwd2"][site]
    monkeypatch.setattr(cs, "device_profile", lambda *a, **k: (0.0, 2, 4))
    q, cterm, idx, mask = args[:4]
    b, c, k = idx.shape
    n, ch1 = q.shape[1:]
    dq, dcterm, de = card_route_bwd2(*args, edges=True)  # computed once, then varied

    def route(dq, de):
        return lambda *a, edges=False: (dq, dcterm, de) if edges else (dq, dcterm)

    monkeypatch.setattr(ck, "sa_train_bwd2", route(dq, de))
    lib_ms, parts = cs.bwd2_dq_checks(torch, ck, site, args, (dq, dcterm))
    assert lib_ms == 0.0 and parts["edge_buffer_bytes"] == 4.0 * ch1 * (
        b * c * k + int(mask.sum()))
    flip = de.view(b, c, k, ch1).flip(1).reshape(b, c * k, ch1)
    reversed_order = ck.sa_train_dq_ordered_plain(flip, idx.flip(1), mask.flip(1), n)
    float64_sum = ck.sa_train_bwd2_plain(*args)[0]
    masked_value = torch.where(mask.reshape(b, c * k, 1), de, 1.0)
    for wrong, match in (((reversed_order, de), "differs from the ordered plain"),
                         ((float64_sum, de), "differs from the ordered plain"),
                         ((dq, masked_value), "edge buffer differs")):
        monkeypatch.setattr(ck, "sa_train_bwd2", route(*wrong))
        with pytest.raises(SystemExit, match=match):
            cs.bwd2_dq_checks(torch, ck, site, args, ck.sa_train_bwd2(*args))
    monkeypatch.setattr(ck, "sa_train_bwd2", route(dq, de))
    with pytest.raises(SystemExit, match="two calls differ in dq"):
        cs.bwd2_dq_checks(torch, ck, site, args, (dq + 1.0, dcterm))


@pytest.mark.parametrize("site", range(cs.SA_TRAIN_REF_SITES["sa_train_bwd2"]))
def test_sa_train_dq_ordered_plain_sums_each_point_in_edge_order(sa_reference_calls, site):
    """The dq pass's order, written out: each point's row is 0 plus its
    valid edges' de0 rows in increasing edge order, one float32 add at a
    time; it lies within float32 rounding of the float64 plain dq, and the
    reference site's slots pick only their own group's points, as the dq
    pass needs."""
    q, cterm, idx, mask, aff, w2, awin, gt = sa_reference_calls["sa_train_bwd2"][site]
    b, n, ch1 = q.shape
    c, k = idx.shape[1:]
    de = ck.sa_train_edges(q, cterm, idx, mask, aff, w2, awin, gt)["de0"].reshape(b, c * k, ch1)
    got = ck.sa_train_dq_ordered_plain(de, idx, mask, n)
    g = -(-n // k)
    slot = torch.arange(k)[None, None, :]
    assert bool(((idx // g == slot) | ~mask).all())
    want = torch.zeros((b, n, ch1))
    for bi in range(b):
        for e in torch.nonzero(mask[bi].reshape(-1)).squeeze(1).tolist():
            p = int(idx[bi].reshape(-1)[e])
            want[bi, p] = want[bi, p] + de[bi, e]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = ck.sa_train_bwd2_plain(q, cterm, idx, mask, aff, w2, awin, gt)[0]
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4)


def test_reproducible_steps_on_the_cpu(monkeypatch, capsys):
    """Phase 12b at N=256 on the CPU: two train steps from one saved state
    (after a first step, so Adam has moments) are equal bit for bit; a step
    that draws noise of its own fails the check."""
    import json

    from dataclasses import replace

    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
    from stratanet2_tpu_torch.utils.synthetic import random_model, train_batch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = default_config()
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16))
    cloud, xyz, gt = train_batch(2, 256, torch.Generator().manual_seed(0), torch.device("cpu"))
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).numpy())
    model = random_model(cfg.model, 0, torch.device("cpu"), running_stats=False)
    opt, sched = make_optimizer(cfg, model, cs.STEPS_PER_EPOCH)
    step = make_train_step(cfg, kde, device="cpu")
    step(model, opt, sched, cloud, xyz, gt)
    cs.reproducible_steps(torch, cfg, step, model, opt, sched, (cloud, xyz, gt))
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["phase"] == "train_step_reproducible" and row["differ"] == []
    assert row["tensors"] == 4 + len(list(model.parameters())) + len(list(model.buffers()))

    def noisy(m, o, s, c, x, g):
        return step(m, o, s, c + 1e-3 * torch.rand(c.shape), x, g)

    with pytest.raises(SystemExit, match="differ in"):
        cs.reproducible_steps(torch, cfg, noisy, model, opt, sched, (cloud, xyz, gt))


@pytest.mark.parametrize("site", range(len(cs.PIXEL_MAX_REFERENCE)))
def test_pixel_max_reference_sites_pass_the_smoke_checks(smoke_on_cpu, monkeypatch, site):
    """The plain version passes pixel_max's site checks; a call that shows
    three device operations a launch (the parent's memset, scatter and
    decode) fails them."""
    args = cs.pixel_max_reference_calls(torch, torch.device("cpu"))[site]
    shape, nbytes, ops, err, diff_sel, _ = cs.pixel_max_site(torch, ck, site, args)
    assert err == 0.0 and diff_sel == 0 and nbytes > 0
    monkeypatch.setattr(cs, "device_profile", lambda *a, **k: (0.0, 10, 30))
    with pytest.raises(SystemExit, match="device operations"):
        cs.pixel_max_site(torch, ck, site, args)


def test_loader_steps_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 15c's control flow at a tiny size on the CPU: LAS plots written,
    read and prepared, PlotLoader batches to train and serve steps (the
    kernel wrappers run their plain versions, so no launch is counted), then
    the steady-state epoch from one pool, alone and feeding train steps."""
    from dataclasses import replace

    import json

    from stratanet2_tpu_torch.config import default_config

    monkeypatch.setattr(cs, "LOADER_PLOTS", 4)
    monkeypatch.setattr(cs, "LOADER_POINTS", 300)
    monkeypatch.setattr(cs, "LOADER_TRAIN_STEPS", 2)
    monkeypatch.setattr(cs, "LOADER_EPOCH_BATCHES", 2)
    monkeypatch.setattr(cs, "TRAIN_LAUNCHES", dict.fromkeys(cs.TRAIN_LAUNCHES, 0))
    monkeypatch.setattr(cs, "SERVE_LAUNCHES", dict.fromkeys(cs.SERVE_LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = default_config()
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=256),
                  train=replace(cfg.train, batch_size=3))
    cs.loader_steps(torch, ck, cfg, torch.device("cpu"), "cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    phase = [x for x in lines if x.get("phase") == "loader_steps"]
    assert len(phase) == 1
    row = phase[0]
    assert row["min_z_path"] in ("native", "numpy") and len(row["host_ms_a_batch"]) == 3
    assert len(row["train_step_ms"]) == 2 and len(row["loss_parts"]) == 2 + 2
    assert row["epoch_plots"] == 8 and len(row["epoch_host_ms_a_batch"]) == 2
    assert row["epoch_steady_ms_a_batch"] == row["epoch_host_ms_a_batch"][1]
    assert len(row["fed_wait_ms"]) == 2 and len(row["fed_step_ms"]) == 2
    assert [x["phase"] for x in lines] == ["loader_steps_launches", "loader_steps"]


def test_parcel_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 15e's control flow at a tiny size on the CPU: a parcel LAS
    written, tiled and extracted, predict_parcel with chains 8 and 1 for
    both tasks (equal bit for bit), the shapefile update, the upload
    variants and the card-vs-CPU corner (here CPU against CPU); the kernel
    wrappers run their plain versions, so no launch is counted."""
    from dataclasses import replace

    import json

    from stratanet2_tpu_torch.config import default_config

    monkeypatch.setattr(cs, "PARCEL_SIZE", 20.0)
    monkeypatch.setattr(cs, "PARCEL_DENSITY", 2.0)
    monkeypatch.setattr(cs, "PARCEL_CPU_PLOTS", 2)
    monkeypatch.setattr(cs, "SERVE_LAUNCHES", dict.fromkeys(cs.SERVE_LAUNCHES, 0))
    monkeypatch.setattr(cs, "device_busy_ms", lambda torch, fn: (fn(), 0.0))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)  # no card: no pinning
    cfg = default_config()
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16),
                  train=replace(cfg.train, batch_size=3),
                  data=replace(cfg.data, min_points_for_pseudo_labelling=400))
    cs.parcel_phase(torch, ck, cfg, torch.device("cpu"), "cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    phases = [x["phase"] for x in lines]
    assert phases[0] == "parcel_prepare" and phases[-2:] == ["parcel", "parcel_cpu_reference"]
    prep, row, ref = lines[0], lines[-2], lines[-1]
    assert prep["plots"] == row["plots"] > cs.PARCEL_CPU_PLOTS
    assert prep["las_points"] == round((20.0 + 40.0) ** 2 * 2.0)
    runs = row["runs"]
    inference = runs["inference_chain_8"]
    assert inference["batches"] == -(-row["plots"] // 3) == runs["inference_chain_1"]["batches"]
    assert inference["batches"] % 8  # the last chain of 8 is short
    assert 0 < runs["pseudo_chain_8"]["plots"] <= row["plots"]
    assert {k: len(v) for k, v in row["upload_seconds"].items()} == {
        "pageable": 3, "pinned": 3, "eager": 3}
    for split in ("cold", "warm", "warm_eager_body"):
        assert set(row["split_seconds"][split]) == {"prepare", "predict", "merge_and_shapefile"}
        assert row["plots_per_s"][split] > 0
    assert ref["tif_max_abs_diff"] == 0.0 and ref["pred_fields_max_abs_diff"] == 0.0
    assert sum(p == "parcel_inference_chain_8_launches" for p in phases) == 1


def test_stats_lanes_mirror_the_cuda_source(monkeypatch):
    """The stats pass's lanes come from its library alone (the wrapper's grid
    and `sa_sum_depth` read them there); main, bwd1 and bwd2 take C1."""
    src = (Path(ck.__file__).parent / "csrc" / "sa_train.cu").read_text()
    assert re.search(r'extern "C" int sa_train_stats_lanes\(int ch\)', src)
    asked = []
    monkeypatch.setattr(ck, "sa_train_stats_lanes", lambda ch: asked.append(ch) or stats_lanes(ch))
    assert [cs.sa_lanes(ck, n, c) for n, c in cs.EDGE_LOOP_INSTANCES] == [4, 16, 32, 16, 16, 32]
    assert asked == [16]


@pytest.mark.parametrize("b,c,k", [(4, 1203, 31), (20, 5000, 8)])
@pytest.mark.parametrize("lanes", [4, 16, 32])  # stats at C1 = 16, SA1, SA2
def test_sa_sum_depth_follows_the_kernels_walk(b, c, k, lanes):
    """sa_sum_depth's chain, groups and grid, and its block-0 selection,
    against the walk of csrc/sa_train.cu's loops written out: warp w of
    block i takes the 32 / L centroids from (i * 8 + w) * 32 / L on, then
    steps by grid x G (G = 256 / L groups a block); (20, 5000) fills the
    grid's cap at 4 lanes."""
    gen = torch.Generator().manual_seed(1)
    mask = torch.rand((b, c, k), generator=gen) < 0.6
    depth, blk0 = cs.sa_sum_depth(torch, ck, mask, lanes)
    groups, warps, cpw = ck.SA_THREADS // lanes, ck.SA_THREADS // 32, 32 // lanes
    grid = ck.sa_grid(b, c, lanes)
    valid = mask.sum(2).reshape(-1).tolist()
    total = b * c
    chains, owner = {}, [-1] * total
    for i in range(grid):
        for w in range(warps):
            base = (i * warps + w) * cpw
            while base < total:
                for g in range(cpw):
                    if base + g < total:
                        chains[i, w, g] = chains.get((i, w, g), 0) + valid[base + g]
                        owner[base + g] = i
                base += grid * groups
    assert min(owner) == 0
    assert depth == max(chains.values()) + groups + grid
    assert blk0.reshape(-1).tolist() == [o == 0 for o in owner]
    if (b, c, lanes) == (20, 5000, 4):
        assert grid == ck.SA_MAX_BLOCKS


def test_epoch_paths_run_on_the_cpu(monkeypatch, capsys):
    """Phase 15d's measurement of the two epoch paths at a tiny size on the
    CPU: timed epochs of each, the profiled ones, the host-sync listing of
    the device-resident loop and the tables' MB."""
    from dataclasses import replace

    import json

    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from synthetic import make_plot_dataset

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "device_busy_ms", lambda torch, fn: (fn(), 1.0))
    monkeypatch.setattr(cs, "EPOCH_REPS", 2)
    ds = make_plot_dataset(np.random.default_rng(0), n_plots=10, n_points=300)
    cfg = default_config("DEV")
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16),
                  train=replace(cfg.train, batch_size=4))
    ids = sorted(ds)
    cs.epoch_paths(torch, cfg, ds, ids[:8], ids[8:], fit_kde_mixture_from_dataset(ds),
                   torch.device("cpu"), "cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["phase"] for x in lines] == ["train_full_paths", "device_epoch_host_syncs"]
    paths, syncs = lines
    for name in ("device_resident", "host_loader"):
        assert len(paths[name]["epoch_seconds"]) == 2 and paths[name]["busy_share"] > 0
    assert paths["batches"] == 2 and paths["card_resident_mb"] > 0
    assert set(cs.SYNC_EVENTS) <= set(syncs)


def test_cli_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 15f's control flow on the CPU at N=256 (batch 8, plots of 600
    points, a sparser parcel, no figures): the six CLI runs, the subprocess
    among them, with their artifacts, and each run's logged launches equal
    to its counters (here all 0: the kernels' plain versions run, so the
    check that a path's kernels launched is the one let through)."""
    import json
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cs, "CLI_POINTS", 600)
    monkeypatch.setattr(cs, "PARCEL_DENSITY", 8.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    check = cs.check
    missed = []

    def lenient(cond, msg):
        if not cond and "never launched" in msg:
            missed.append(msg)
            return
        check(cond, msg)

    monkeypatch.setattr(cs, "check", lenient)
    cs.cli_phase(torch, ck, "cpu", flags=("--subsample_size", "256", "--batch_size", "8"),
                 device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    runs = [x["cli"] for x in lines if x.get("phase") == "cli"]
    assert runs == ["main", "prepare", "predict_inference_subprocess",
                    "predict_pseudo_labelling", "main_ssl", "main_warm_start"]
    assert lines[-1]["phase"] == "cli_data" and lines[-1]["parcel_plots"] >= cs.CLI_PLOTS
    skipped = [x["warnings"] for x in lines if x.get("cli") == "main"][0]
    assert any("KDE figure" in w for w in skipped)  # matplotlib blocked: skipped, warned
    assert len(missed) == 11 * 3 + 4 * 2  # every path kernel of the five device runs


# ---------------------------------------------------------------------------
# phase 17: the opt-ins and a reference checkpoint
# ---------------------------------------------------------------------------


def _results_csvs():
    """A cross-validation result CSV as phase 15f's training writes it:
    plot ids, predictions and class-centre ground truths."""
    import pandas as pd

    from stratanet2_tpu_torch.learning import metrics as M

    rng = np.random.default_rng(0)
    df = pd.DataFrame({"pl_id": [f"p{i}" for i in range(30)],
                       **{f"pred_{s}": rng.uniform(0, 1, 30) for s in M.STRATA},
                       **{f"vt_{s}": M.closest_class_center(rng.uniform(0, 1, 30))
                          for s in M.STRATA}})
    return {"PCC_inference_all_placettes_summary.csv": df.to_csv(index=False)}


@pytest.fixture
def optin_on_cpu(monkeypatch):
    """Phase 17 small on the CPU: N=256 (k 8/16), B=3, two timed steps, the
    reference sites cut to small clouds, and every route's launches 0 (the
    plain versions run)."""
    import sys
    from dataclasses import replace

    from stratanet2_tpu_torch.config import default_config

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(profiling, "time_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(cs, "device_busy_ms", lambda torch, fn: (fn(), 0.0))
    monkeypatch.setattr(cs, "STEPS", 2)
    monkeypatch.setattr(cs, "BF16_PROBE_ROWS", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "NEAREST_REFERENCE", (
        ("grid", 2, 400, 100, 16, 2.0), ("few", 2, 300, 50, 16, 1.0), ("all", 1, 200, 40, 128, 1e3)))
    zero = dict.fromkeys(cs.TRAIN_LAUNCHES, 0)
    monkeypatch.setattr(cs, "SERVE_LAUNCHES", zero)
    monkeypatch.setattr(cs, "OPTIN_ROUTES", {k: (v[0], zero, zero)
                                             for k, v in cs.OPTIN_ROUTES.items()})
    cfg = default_config()
    return replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16),
                   train=replace(cfg.train, batch_size=3))


def test_optin_phase_runs_on_the_cpu(optin_on_cpu, capsys):
    """Phase 17's control flow: the nearest kernel's four step sites and
    its reference sites (0 differing picks), the three routes' steps with
    their card-vs-CPU checks and baselines, the matmul probe, the reference
    checkpoint and the metascripts with matplotlib blocked (figure
    skipped, warned)."""
    import json

    row, ref_row, launches = cs.optin_phase(torch, ck, optin_on_cpu, torch.device("cpu"), "cpu",
                                            _results_csvs())
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    sites = [x for x in lines if x.get("kernel") == "ball_query_nearest"]
    assert [x["site"] for x in sites][:4] == ["serve_step 0", "serve_step 1", "train_step 0",
                                              "train_step 1"]
    assert len(sites) == 4 + 3 and all(x["differing_selections"] == 0 for x in sites)
    assert [x["reference"] for x in sites] == [False] * 4 + [True] * 3
    assert row["pairs"] == 3 * (64 * 256 + 16 * 64) and ref_row["pairs"] > 0
    grids = [x for x in lines if x.get("phase") == "nearest_grid"]
    assert [x["site"] for x in grids] == [x["site"] for x in sites]
    assert all(x["grid_differing"] == 0 and 0 < x["in_radius_pairs"] <= x["scored_pairs"]
               <= x["all_pairs"] for x in grids)
    assert row["scored_pairs"] == sum(x["scored_pairs"] for x in grids[:2])
    assert row["in_radius_pairs"] == sum(x["in_radius_pairs"] for x in grids[:2])
    routes = [x for x in lines if x.get("phase") == "optin_steps"]
    assert [x["route"] for x in routes] == ["nearest", "bf16_fused", "bf16_unfused"]
    assert all(x["serve_cpu_B2_max_abs_diff"] == 0 and x["train_cpu_B2_loss_max_abs_diff"] == 0
               for x in routes)
    assert [x["baseline"]["opt_ins"] for x in routes] == [{}, {}, {"use_pallas": False}]
    assert all(x["vs_baseline_serve_max_abs_diff"] > 0 for x in routes)
    assert all(len(x["baseline"]["train_step_ms_all"]) == 2 for x in routes)
    assert launches == dict.fromkeys(ck.LAUNCHES, 0)
    probe = [x for x in lines if x.get("phase") == "bf16_matmul_probe"][0]
    assert probe["kept"] == "widened float32"
    ref = [x for x in lines if x.get("phase") == "reference_checkpoint"][0]
    assert ref["tensors"] == 7 * 6 + 4 and ref["cpu_B2_max_abs_diff"] == 0  # 7 layers, the head
    meta = [x for x in lines if x.get("phase") == "metascripts"][0]
    assert meta["benchmark_rows"] == 1 and meta["analysis"]["n"] == 30
    assert meta["quantification_files"] == ["expected_errors_under_gaussian_msrt_error.csv",
                                            "msrt_error_description.csv"]
    assert any("quantification figure" in w for w in meta["warnings"])


@pytest.mark.parametrize("fault", ["reversed_order", "one_slot_masked"])
def test_nearest_site_check_rejects_a_wrong_selection(monkeypatch, fault):
    """nearest_site counts the entries where the kernel's idx or mask
    differs from the plain version's: 0 for the plain version itself, more
    for a selection in another order or with a slot masked."""
    monkeypatch.setattr(profiling, "time_ms", lambda *a, **k: 0.0)
    args = cs.nearest_reference_calls(torch, torch.device("cpu"))[-1]
    args = (args[0][:1, :20].contiguous(), args[1][:1, :300].contiguous(), args[2], 32)
    monkeypatch.setattr(ck, "ball_query_nearest_grid",
                        lambda *a: (*ck.ball_query_nearest_plain(*a), {}))
    assert cs.nearest_site(torch, ck, args)[3] == 0

    def wrong(*a):
        idx, mask = ck.ball_query_nearest_plain(*a)
        if fault == "reversed_order":
            return idx.flip(-1), mask, {}
        mask = mask.clone()
        mask[0, 0, 5] = False
        return idx, mask, {}

    monkeypatch.setattr(ck, "ball_query_nearest_grid", wrong)
    assert cs.nearest_site(torch, ck, args)[3] > 0


@pytest.mark.parametrize("fault", [None, "permuted_in_cells", "starts", "across_cells",
                                   "positions", "centroids", "inv_h"])
def test_nearest_grid_check_passes_the_model_and_rejects_a_wrong_grid(fault):
    """nearest_grid_check holds the card's grid to `nearest_cells`: the
    model itself and the points permuted within their cells (the kernel's
    atomics fix no order there) pass; a wrong cell start, two points of
    different cells swapped, a wrong sorted position, centroids out of cell
    order or another cell side fail. It also returns the pairs the kernel
    scores, each centroid's 3 x 3 cells."""
    from stratanet2_tpu_torch.ops.ballquery import nearest_cells

    args = cs.nearest_reference_calls(torch, torch.device("cpu"))[0]
    args = (args[0][:2, :200].contiguous(), args[1][:2, :2000].contiguous(), 2 ** 0.5, 32)
    model = nearest_cells(*args[:3])

    def faulty(*a):
        got = {key: v.clone() for key, v in ck.ball_query_nearest_grid(*a)[2].items()}
        if fault == "permuted_in_cells":  # reverse each cell's points
            for i in range(got["starts"].shape[0]):
                for lo, hi in zip(got["starts"][i, :-1].tolist(), got["starts"][i, 1:].tolist()):
                    for key in ("sorted_idx", "sorted_pts"):
                        got[key][i, lo:hi] = got[key][i, lo:hi].flip(0)
        elif fault == "starts":
            got["starts"][0, 5] += 1
        elif fault == "across_cells":
            first = int(got["starts"][0, 1])  # the first point of cell 1 and cell 0's last
            for key in ("sorted_idx", "sorted_pts"):
                got[key][0, [first - 1, first]] = got[key][0, [first, first - 1]]
        elif fault == "positions":
            got["sorted_pts"][1, 7, 3] += 1.0
        elif fault == "centroids":
            got["cent_order"][0] = got["cent_order"][0].flip(0)
        elif fault == "inv_h":
            got["inv_h"][1] = got["inv_h"][1] * 1.01
        return got

    diff, scored, parts = cs.nearest_grid_check(torch, args, faulty(*args))
    assert sum(parts.values()) == diff
    assert (diff == 0) == (fault in (None, "permuted_in_cells"))
    assert scored == float(model.scored.sum()) and 0 < scored < 200 * 2000 * 2 * 0.1


@pytest.mark.parametrize("fault", [None, "permuted_in_cells", "starts", "across_cells",
                                   "centroids", "m"])
def test_cell_grid_check_holds_a_knn_grid_to_knn_cells(fault):
    """cell_grid_check in kNN's form (no radius: `knn_cells`, the sources
    as points and the targets as centroids) passes the mirror's own grid
    in the kernel's layout and its sources permuted within their cells (the
    pass's atomics fix no order there), and fails a wrong cell start, two
    sources of different cells swapped, targets out of cell order or
    another M in the grid's fourth parameter."""
    from stratanet2_tpu_torch.ops.ballquery import knn_cells
    from stratanet2_tpu_torch.ops.distance import sq_norm3

    rng = np.random.default_rng(4)
    tgt = torch.from_numpy(np.concatenate([rng.uniform(-10, 10, (2, 1200, 2)),
                                           rng.uniform(0, 3, (2, 1200, 1))], -1).astype(np.float32))
    src = tgt[:, torch.from_numpy(rng.permutation(1200)[:300])].contiguous()
    m = knn_cells(src, tgt)
    pts = torch.gather(src, 1, m.order[..., None].expand(2, 300, 3))
    got = dict(xmin=m.xmin, ymin=m.ymin, inv_h=m.inv_h, rc2=m.m.clone(), gx=m.gx, gy=m.gy,
               starts=m.starts.clone(), sorted_idx=m.order.clone(),
               cent_order=m.cent_order.clone(),
               sorted_pts=torch.cat([pts, sq_norm3(pts)[..., None]], -1))
    if fault == "permuted_in_cells":
        for i in range(2):
            for lo, hi in zip(got["starts"][i, :-1].tolist(), got["starts"][i, 1:].tolist()):
                for key in ("sorted_idx", "sorted_pts"):
                    got[key][i, lo:hi] = got[key][i, lo:hi].flip(0)
    elif fault == "starts":
        got["starts"][1, 3] += 1
    elif fault == "across_cells":
        first = int(got["starts"][0, 1]) or int(got["starts"][0, 2])
        for key in ("sorted_idx", "sorted_pts"):
            got[key][0, [first - 1, first]] = got[key][0, [first, first - 1]]
    elif fault == "centroids":
        got["cent_order"][1] = got["cent_order"][1].flip(0)
    elif fault == "m":
        got["rc2"][0] = torch.nextafter(got["rc2"][0], torch.tensor(float("inf")))
    diff, mirror, parts = cs.cell_grid_check(torch, got, src, tgt)
    assert sum(parts.values()) == diff and torch.equal(mirror.starts, m.starts)
    assert (diff == 0) == (fault in (None, "permuted_in_cells")), parts


def test_nearest_reference_sites_are_tie_heavy_few_and_full():
    """The full-size reference sites, on one cloud and 100 centroids each:
    the grid sites hold zero distances and ties at the k-th distance, the
    "few" site masks most slots, the "all" site has every point within the
    radius at the kernel's largest k (one cell of its grid); the "shifted"
    site lies 1 km out, where the expanded d2 admits points beyond r and the
    culling radius takes a margin; the "clustered" site crowds 90% of its
    points into 5% of the plot, most of them in a few cells."""
    from stratanet2_tpu_torch.ops.ballquery import nearest_cells, radius_sq
    from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3

    calls = cs.nearest_reference_calls(torch, torch.device("cpu"))
    kinds = [site[0] for site in cs.NEAREST_REFERENCE]
    assert calls[kinds.index("all")][3] == ck.NEAREST_MAX_K
    assert {"grid", "few", "all", "shifted", "clustered"} == set(kinds)
    for (kind, b, n, c, k, radius), (cent, pts, r, kk) in zip(cs.NEAREST_REFERENCE, calls):
        assert cent.shape == (b, c, 3) and pts.shape == (b, n, 3) and (r, kk) == (radius, k)
        cc, pp = cent[:1, :100], pts[:1]
        d2 = expanded_d2(cc, sq_norm3(cc), pp, sq_norm3(pp))
        inside = d2 <= radius_sq(radius)
        if kind == "grid":
            assert float((d2 == 0).sum(-1).float().mean()) > 1.5  # duplicates: zero distances
            kth = torch.sort(torch.where(inside, d2, float("inf")), -1)[0][..., k - 1]
            ties = ((d2 == kth[..., None]).sum(-1) > 1) & (inside.sum(-1) > k)
            assert float(ties.float().mean()) > 0.5
        elif kind == "few":
            assert float((inside.sum(-1) < k).float().mean()) == 1.0
        elif kind == "all":
            assert bool(inside.all())
            assert nearest_cells(cc, pp, radius).gx.tolist() == [1]
        elif kind == "shifted":
            assert float(pp[..., :2].min()) > 980 and float(pp[..., :2].max()) < 1020
            true_d2 = ((cc[:, :, None] - pp[:, None]) ** 2).sum(-1)
            assert bool((inside & (true_d2 > radius_sq(radius))).any())  # rounding admits them
            assert float(nearest_cells(cc, pp, radius).rc2[0]) > 2 * radius_sq(radius)
        else:
            share, side = cs.NEAREST_CLUSTER
            crowd = (pp[..., :2].abs() <= side / 2).all(-1).float().mean()
            assert abs(float(crowd) - share) < 0.02


def test_reference_checkpoint_check_rejects_an_untransposed_load(optin_on_cpu, monkeypatch):
    """Phase 17d fails when a Linear weight lands untransposed (square
    layers keep their shape, so only the placement check sees it)."""
    from stratanet2_tpu_torch.utils import torch_import

    real = torch_import.params_from_torch_state_dict

    def untransposed(sd, cfg, device=None):
        model = real(sd, cfg, device)
        with torch.no_grad():
            model.sa1.layers[1].linear.w.copy_(model.sa1.layers[1].linear.w.t().clone())
        return model

    monkeypatch.setattr(torch_import, "params_from_torch_state_dict", untransposed)
    with pytest.raises(SystemExit, match="sa1_module.conv.local_nn.1.0.weight"):
        cs.reference_checkpoint_phase(torch, ck, optin_on_cpu, torch.device("cpu"), "cpu")


def test_optin_route_rejects_launches_off_its_route(optin_on_cpu, monkeypatch):
    """A route whose expected launches the step does not make fails (on the
    CPU every count is 0, so a route that expects the nearest kernel)."""
    want = {**dict.fromkeys(cs.TRAIN_LAUNCHES, 0), "ball_query_nearest": 2}
    monkeypatch.setitem(cs.OPTIN_ROUTES, "nearest", (dict(ball_query_method="nearest"), want, want))
    with pytest.raises(SystemExit, match="ball_query_nearest launched 0 times"):
        cs.optin_route(torch, ck, optin_on_cpu, torch.device("cpu"), "cpu", "nearest")


def test_dense_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 15h's control flow on the CPU, with the kernels' limits cut so
    that a small step crosses each of them as the dense step does: FPS rows
    of 1,024 points past a block's 512 (SA1's parts: the cluster), SA1's
    groups of 64 points past a slice of 16 (the cell grid; SA2's groups of 8 are
    not), kNN from 512 and 128 sources past 128 (the cell grid), a 20 x 20
    x 3 table past 64 slots (pixel ranges of 16 pixels), the global FPS
    site past 8 slices, the dq windows' site past 1,000 ints of lists and
    counts, and a train step at N=2,560 past them. The plain versions run,
    so the launch, path and profile checks are the ones let through; every
    path's sites are held to the plain version."""
    import json

    from stratanet2_tpu_torch.config import default_config

    monkeypatch.setattr(ck, "FPS_MAX_N", 512)
    monkeypatch.setattr(ck, "BQ_MAX_G", 16)
    monkeypatch.setattr(ck, "sa_fused_eval_max_g", lambda *a: 16)
    monkeypatch.setattr(ck, "PIXEL_MAX_TABLE", 64)
    monkeypatch.setattr(ck, "PIXEL_MAX_PAIR_TABLE", 48)
    monkeypatch.setattr(ck, "KNN_GRID_MIN_S", 128)
    monkeypatch.setattr(ck, "SA_DQ_INTS", 1000)
    monkeypatch.setattr(cs, "DQ_REFERENCE", (1, 2000, 500, 32, 16))
    asked = []  # the card's resident clusters: the table's here
    monkeypatch.setattr(ck, "fps_cluster_resident",
                        lambda n, device: asked.append(n) or dict(ck.FPS_RESIDENT))
    # the dq pass's order of sums is the kernel's (the plain version sums in
    # float64); bwd2_dq_checks's own tests hold it, here it is only called
    dq_sites = []
    monkeypatch.setattr(cs, "bwd2_dq_checks",
                        lambda torch, ck, site, args, got: dq_sites.append(site) or (None, {}))
    monkeypatch.setattr(profiling, "time_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(cs, "device_profile", lambda *a, **k: (0.0, 10, 10))
    monkeypatch.setattr(cs, "DENSE_STEPS", 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "FPS_REFERENCE", cs.FPS_REFERENCE[:-1] + (("uniform", 1, 4097, 64),))
    named = {"dense_serve_profile": cs.DENSE_SERVE_PATHS,
             "dense_train_profile": cs.DENSE_TRAIN_PATHS,
             "dense_dq_train_profile": cs.DENSE_DQ_TRAIN_PATHS}

    def first(prefixes):
        return prefixes if isinstance(prefixes, str) else prefixes[0]

    def profile(torch, step, args, ms, label, launches, steps, strict, warmup):
        return ([(0.5, 1.0, f"void {first(cs.DENSE_KERNELS[path])}<16>(float const*)")
                 for path, count in named[label].items() if count]
                + [(0.5, 1.0, f"void {cs.DEVICE_KERNELS[name][0]}(float const*)")
                   for name, count in launches.items() if count])

    monkeypatch.setattr(cs, "profile_step", profile)
    check, missed = cs.check, []

    def lenient(cond, msg):
        if not cond and ("launched" in msg or "launches of" in msg):
            missed.append(msg)
            return
        check(cond, msg)

    monkeypatch.setattr(cs, "check", lenient)
    small = {"B": 2, "model": {"subsample_size": 2048, "diam_pix": 20}, "dq_N": 2560}
    rows = cs.dense_phase(torch, ck, default_config(), torch.device("cpu"), "cpu", small=small)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert set(rows) == set(cs.DENSE_KERNELS) == set(cs.DENSE_WRAPPERS)
    for path, row in rows.items():
        assert row["max_abs_err"] == 0.0 and row["bound_ms"] > 0, path
        assert row["launches"] == {"serve": 0, "train": 0}  # CPU: plain versions
    held = [x for x in lines if str(x.get("site", "")).startswith("dense ") and "shape" in x]
    assert held and all(x["differing_selections"] == 0 for x in held)
    # every path's sites in both steps held to the plain version, and the
    # global FPS path's reference site; each row timed at one step's sites
    steps = {"serve": cs.DENSE_SERVE_PATHS, "train": cs.DENSE_TRAIN_PATHS}
    assert sorted({tuple(x["site"].split()[1:3]) for x in held}) == sorted(
        [(step, path) for path in cs.DENSE_KERNELS for step in steps if steps[step].get(path)]
        + [("reference", "fps_global"), ("reference", "sa_train_dq_chunked")])
    timed = {tuple(x["site"].split()[1:3]) for x in held if "kernel_ms" in x}
    assert sorted(path for _, path in timed) == sorted(cs.DENSE_KERNELS)
    # the dq windows at their reference site and at the N=2,560 step's SA1
    # site, and that step's FPS rows (SA1's parts, past 512 points) held and
    # timed beside the dense steps' rows
    assert dq_sites == ["dense sa_train_dq_chunked 0", "dense_dq sa_train_dq_chunked 0"]
    step80k = [x for x in lines if str(x.get("site", "")).startswith("dense_dq train")]
    assert {x["site"].split()[2] for x in step80k} == {"fps_cluster", "sa_train_dq_chunked"}
    assert all(x["differing_selections"] == 0 and x["max_abs_diff"] == 0.0 for x in step80k)
    assert rows["fps_cluster"]["step80k"]["bound_ms"] > 0
    assert rows["sa_train_dq_chunked"]["step80k"]["bound_ms"] > 0
    resident = [x for x in lines if x.get("phase") == "fps_cluster_resident"]
    assert [(x["rows"], x["N"]) for x in resident] == [(4, 1024), (1, 4097), (4, 1280)]
    assert all(x["one_wave"] for x in resident) and 1024 in asked
    (dense,) = [x for x in lines if x.get("phase") == "dense"]
    assert dense["N"] == 2048
    assert (dense["sa_train_bwd2_edge_buffer_bytes"]
            > dense["sa_train_bwd2_edge_buffer_allocated_bytes"] > 0)
    # kNN's grid sites: FP1 and FP2 of both steps held, the serve step's
    # timed, each with its pairs scored
    knn_sites = [x for x in held if x["kernel"] == "knn_interpolate" and "kernel_ms" not in x]
    assert len(knn_sites) == 4 and all("path=grid" in x["shape"] for x in knn_sites)
    work = [x for x in lines if x.get("phase") == "grid_work"
            and x["kernel"] == "knn_interpolate"]
    assert len(work) == 4 and all(0 < x["scored_pairs"] <= x["all_pairs"] for x in work)
    assert rows["knn_interpolate_grid"]["scored_pairs"] == sum(
        x["scored_pairs"] for x in work if x["site"].startswith("dense knn_interpolate_grid")
        and x["site"].split()[-1] in ("0", "1"))
    # the wrappers' and the paths' launch checks of both steps, and each
    # path's kernel named in a profile where nothing launched
    serve_on = sum(v > 0 for v in cs.SERVE_LAUNCHES.values())
    train_on = sum(v > 0 for v in cs.TRAIN_LAUNCHES.values())
    paths_on = sum(v > 0 for v in cs.DENSE_SERVE_PATHS.values()) + sum(
        v > 0 for v in cs.DENSE_TRAIN_PATHS.values())
    dq_on = train_on + sum(v > 0 for v in cs.DENSE_DQ_TRAIN_PATHS.values())
    assert len(missed) == serve_on + train_on + 2 * paths_on + dq_on
    (dq_step,) = [x for x in lines if x.get("phase") == "dense_dq_train"]
    assert dq_step["N"] == 2560 and len(dq_step["train_step_ms_all"]) == cs.DENSE_DQ_STEPS
    assert all(np.isfinite(v) for v in dq_step["loss_parts"].values())


def test_graphs_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 15i's control flow at a tiny size on the CPU, the steps built
    with their programs as on the card and served by `StandInGraphs`
    (tests/test_torch_port_graphs.py): every replayed output, state and
    generator held to its eager body bit for bit, captures and replays
    counted as on the card, then the timing in turns. The plain versions
    run, so no launch is counted."""
    import json
    from dataclasses import replace

    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.data import device_dataset as D
    from stratanet2_tpu_torch.inference import predict
    from stratanet2_tpu_torch.learning import programs, train
    from test_torch_port_graphs import StandInGraphs

    for module in (train, predict, D):
        monkeypatch.setattr(module, "graphed", lambda device, group=None: group is None)
    real_init = programs.StepProgram.__init__

    def init(self, body, graphs=None):
        real_init(self, body, StandInGraphs())
        self.graphs.program = self

    monkeypatch.setattr(programs.StepProgram, "__init__", init)
    for name in ("SERVE_LAUNCHES", "TRAIN_LAUNCHES", "EVAL_LAUNCHES"):
        monkeypatch.setattr(cs, name, dict.fromkeys(getattr(cs, name), 0))
    monkeypatch.setattr(cs, "device_busy_ms", lambda torch, fn: (fn(), 1.0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = default_config()
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16),
                  train=replace(cfg.train, batch_size=3))
    small = {"dense": {"subsample_size": 512, "diam_pix": 20}, "plots": (12, 300), "steps": 1}
    cs.graphs_phase(torch, ck, cfg, torch.device("cpu"), "cpu", small=small)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    row = [x for x in lines if x.get("phase") == "graphs"][0]
    assert set(row["serve"]) == {"prod_B20", "prod_B2", "dense"}
    assert all(not v["differ"] for v in row["serve"].values())
    assert row["predict_program"]["graphs"] == {"captures": 0, "replays": 3}
    assert row["train"]["graphs"] == {"captures": 1, "replays": 2} and not row["train"]["differ"]
    assert row["train"]["lr"] < row["train"]["lr0"]
    epochs = row["device_epochs"]
    assert (epochs["batches"], epochs["val_batches"]) == (2, 2) and not epochs["differ"]
    assert epochs["graphs"] == {"captures": 2, "replays": 4}
    for name in ("serve_prod", "serve_dense", "train_prod", "train_dense"):
        assert {k: len(v) for k, v in row["step_ms"][name].items()} == {"graph": 2, "eager": 2}
    assert len(row["device_epoch"]["busy_share"]["graph"]) == 2


def test_schedule_phase_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    """Phase 15j's control flow at a tiny size on the CPU (10 plots of 300
    points, batch 2, subsample 256, 6 epochs with an eval each, fold 1
    killed past epoch 2; matplotlib and scikit-learn hidden from the
    children): its lines in order with their keys, the learnability check
    and each fold's baseline check (too few epochs here to beat the
    baseline, so those are the checks let through), the launch checks (the
    plain versions run: all 0), the resume bit for bit, the host costs and
    the phase's seconds; and `main` runs it between phases 15i and 15e, with
    a timeline line after it."""
    import inspect
    import json

    from test_torch_port_schedule import quiet

    quiet(monkeypatch, tmp_path)
    for name in ("TRAIN_LAUNCHES", "EVAL_LAUNCHES"):
        monkeypatch.setattr(cs, name, dict.fromkeys(getattr(cs, name), 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "SCHEDULE_HOST_REPS", 5)
    check, missed = cs.check, []

    def lenient(cond, msg):
        if not cond and "does not beat the mean baseline" in msg:
            missed.append(msg)
            return
        check(cond, msg)

    monkeypatch.setattr(cs, "check", lenient)
    small = {"learnability": {"epochs": 4, "n_plots": 10, "subsample_size": 256},
             "schedule": ["--plots", "10", "--points", "300", "--batch", "2", "--subsample",
                          "256", "--n_epoch", "6", "--n_epoch_test", "1"],
             "kill_after": 2}
    cs.schedule_phase(torch, ck, "cpu", device="cpu", small=small)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ours = [x for x in lines if x["phase"] in ("learnability", "schedule_fold", "schedule_resume",
                                               "schedule_host", "schedule")]
    assert [x["phase"] for x in ours] == ["learnability"] + ["schedule_fold"] * 4 + [
        "schedule_resume", "schedule_host", "schedule"]
    learn, killed, resumed, fold2, unbroken, resume, host, phase = ours
    assert {"val_MAE", "baseline_MAE", "train_MAE_first", "train_MAE_last", "epochs",
            "seconds"} <= set(learn) and learn["epochs"] == 4
    assert [(x["fold"], x["run"]) for x in (killed, resumed, fold2, unbroken)] == [
        (1, "killed"), (1, "resumed"), (2, "first"), (1, "unbroken")]
    assert killed["exit_code"] == -15 and 2 <= killed["killed_after_epoch"] < 6
    for run in (resumed, fold2, unbroken):
        assert {"epochs_run", "wall_seconds", "median_epoch_seconds", "train_points_per_sec",
                "final_val_MAE", "mean_baseline_MAE", "launches", "want_launches",
                "peak_allocated_mb", "resumed_from_epoch", "killed_after_epoch"} <= set(run)
        assert run["last_epoch"] == 6 and run["launches"] == run["want_launches"]
    assert resumed["resumed_from_epoch"] > 1
    assert resume["differing_tensors"] == 0 and resume["differing_losses"] == 0
    assert resume["tensors"] > 100 and resume["killed_after_epoch"] == killed["killed_after_epoch"]
    assert set(host["us_a_call"]) == {"sink_record", "print_epoch_losses", "table_upload",
                                      "sums_read"}
    assert phase["seconds"] > 0 and phase["budget_seconds"] == cs.SCHEDULE_BUDGET_S
    # the learnability check and the three finished runs' baselines
    assert len(missed) <= 4
    # 15j runs after 15i and before 15e, with its timeline line
    src = inspect.getsource(cs.main)
    order = ['graphs_phase(', 'timeline("graphs")', 'schedule_phase(', 'timeline("schedule")',
             'parcel_phase(']
    assert [src.index(x) for x in order] == sorted(src.index(x) for x in order)


def test_ssl_cycle_phase_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    """Phase 15k's control flow at `tests/test_ssl_cycle.py`'s sizes on the
    CPU (10 plots of 1,200 points, a parcel, subsample 512, batch 4; PROD at
    2 folds of 2 epochs, 2 SSL epochs; the sweep at 10 plots, 2 epochs,
    subsample 256; matplotlib and scikit-learn hidden, also from the fold
    trained alone): its lines in order with their keys, the fold trained
    alone in a fresh process bit for bit the cross-validation's, and the
    launch and MAE checks (the plain versions run and the runs are too
    short to beat the baseline, so those are the checks let through); and
    `main` runs it between phases 15j and 15e, with a timeline line."""
    import inspect
    import json

    from test_torch_port_schedule import quiet

    quiet(monkeypatch, tmp_path)
    # the CPU's float32 sums depend on the threads: as many here as in the
    # fold trained alone (quiet's OMP_NUM_THREADS)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    check, missed = cs.check, []

    def lenient(cond, msg):
        if not cond and ("never launched" in msg or "does not beat" in msg):
            missed.append(msg)
            return
        check(cond, msg)

    monkeypatch.setattr(cs, "check", lenient)
    small = {"cycle": ["--mode", "PROD", "--n_plots", "10", "--n_parcels", "1", "--points",
                       "1200", "--subsample_size", "512", "--batch_size", "4", "--folds", "2",
                       "--epochs", "2", "--ssl_epochs", "2"],
             "sweep": {"epochs": 2, "n_plots": 10, "subsample_size": 256}}
    try:
        cs.ssl_cycle_phase(torch, ck, "cpu", device="cpu", small=small)
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ours = [x for x in lines if x.get("phase", "").startswith(("ssl_cycle", "ssl_sweep"))]
    assert [x["phase"] for x in ours] == (["ssl_cycle_stage"] * 5 + ["ssl_cycle_fold"] * 4 + [
        "ssl_cycle_fold_alone"] + ["ssl_sweep"] * 2 + ["ssl_sweep_summary"] * 2 + ["ssl_cycle"])
    stages, folds, alone = ours[:5], ours[5:9], ours[9]
    assert [x["stage"] for x in stages] == ["cold_crossval", "prepare", "pseudo_label",
                                            "ssl_pretrain", "warm_crossval"]
    for x in stages:
        assert set(x["launches"]) == set(ck.LAUNCHES) and x["wall_s"] > 0
    assert stages[2]["pseudo_labels"] > 0
    assert [(x["of"], x["fold"]) for x in folds] == [
        ("cold_crossval", 1), ("cold_crossval", 2), ("warm_crossval", 1), ("warm_crossval", 2)]
    for x in folds:
        assert {"seconds", "allocated_mb", "reserved_mb", "peak_allocated_mb", "captures",
                "replays", "val_MAE", "baseline_MAE"} <= set(x)
    assert alone["fold"] == cs.SSL_ALONE_FOLD and alone["process_seconds"] > 0
    assert alone["differing_tensors"] == 0 and alone["differing_losses"] == 0
    assert alone["tensors"] > 100 and alone["loss_values_compared"] > 0
    assert [x["policy"] for x in ours[10:12]] == ["grouped", "nearest"]
    phase = ours[-1]
    assert phase["seconds"] > 0 and phase["budget_seconds"] == cs.SSL_CYCLE_BUDGET_S
    # the kernels of three training stages, of pseudo-labelling and of the
    # two sweep runs; and at most the cold and warm MAE checks
    never = [m for m in missed if "never launched" in m]
    assert len(never) == 3 * 11 + 4 + 11 + len(cs.NEAREST_PATH)
    assert len(missed) - len(never) <= 2
    # 15k runs after 15j and before 15e, with its timeline line
    src = inspect.getsource(cs.main)
    order = ['schedule_phase(', 'timeline("schedule")', 'ssl_cycle_phase(',
             'timeline("ssl_cycle")', 'parcel_phase(']
    assert [src.index(x) for x in order] == sorted(src.index(x) for x in order)


def test_fold_memory_drift_bound():
    """A later fold's allocated MB against the first fold's, within the
    larger of SSL_MEMORY_SLACK_MB and SSL_MEMORY_SHARE of its peak."""
    folds = [{"fold": 1, "allocated_mb": 100.0, "peak_allocated_mb": 460.0},
             {"fold": 2, "allocated_mb": 110.0}, {"fold": 3, "allocated_mb": 80.0}]
    assert cs.fold_memory_drift(folds) == [(2, 10.0, 23.0), (3, -20.0, 23.0)]
    folds[0]["peak_allocated_mb"] = 100.0
    assert cs.fold_memory_drift(folds)[0][2] == cs.SSL_MEMORY_SLACK_MB


def test_cap_studies_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 15l's control flow on the CPU at small sizes (the neighbour
    study at N=1024 on 2 clouds; the gradient study at n=1024, B=2; the
    training study at 10 plots, 1 epoch, train_n 256; the parity eval on
    15f's tree of 30 plots of 600 points at subsample 256, batch 8;
    matplotlib hidden): its lines in order with their keys, the card-vs-CPU
    checks (both sides on the CPU here: equal), and the launch checks (the
    plain versions run, so those are the checks let through, one a kernel
    of each run's route); and `main` runs it between phases 15k and 15e,
    with a timeline line."""
    import inspect
    import json
    import re
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cs, "CLI_POINTS", 600)
    monkeypatch.setattr(cs, "PARCEL_DENSITY", 8.0)
    check, missed = cs.check, []

    def lenient(cond, msg):
        if not cond and re.search(r"launched 0 times .*expected [1-9]", msg):
            missed.append(msg)
            return
        check(cond, msg)

    monkeypatch.setattr(cs, "check", lenient)
    small = {"neighbor": (2, 1024, 1),
             "grad": ("--n", "1024", "--batch", "2", "--seeds", "1", "--skip_pretrain"),
             "train": ("--n_plots", "10", "--epochs", "1", "--train_n", "256"),
             "parity": ("--subsample_size", "256", "--batch_size", "8")}
    cs.cap_studies_phase(torch, ck, "cpu", device="cpu", small=small)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ours = [x for x in lines if not x["phase"].endswith("_launches")]
    assert [x["phase"] for x in ours] == ["neighbor_cap_study", "cap_grad_study",
                                          "cap_train_study", "parity_eval", "cap_studies"]
    neighbor, grad, train, parity, phase = ours
    assert set(neighbor["policies"]) == {"grouped", "nearest"}
    for row in neighbor["policies"].values():
        assert row["card_vs_cpu_max_abs_diff"] == 0.0
        assert row["cpu_mean_abs_dev"] == row["mean_abs_dev"] < 0.05
    assert [s["summary"] for s in neighbor["summaries"]] == ["grouped", "nearest"]
    assert grad["capped_k"] == [32, 64] and grad["exact_k"] == [128, 64]
    assert grad["cosine"] == grad["cpu_cosine"] and grad["card_vs_cpu_loss_diff"] == 0.0
    assert set(grad["card_vs_cpu_grad_rel"]) == {"capped", "generous"}
    assert [r["config"] for r in train["runs"]] == ["capped", "generous"]
    assert {"delta_val_MAE", "epochs", "n_plots"} <= set(train)
    assert parity["plots"] == cs.CLI_PLOTS and parity["cpu_plots"] == cs.PARITY_CPU_PLOTS
    assert parity["card_vs_cpu_max_abs_diff"] == 0.0 and parity["skipped"] is None
    assert set(parity["indicators"]) == {"error_all", "acc_all", "error2_all", "acc2_all"}
    assert phase["budget_seconds"] == cs.CAP_STUDIES_BUDGET_S and phase["seconds"] > 0
    # the nonzero launches of each run's route: two eval forwards, a
    # gradient pair, two training runs, the parity eval
    want = sum(sum(1 for v in d.values() if v) for d in (
        *cs.CAP_EVAL_LAUNCHES.values(), cs.UNFUSED_TRAIN_LAUNCHES, cs.UNFUSED_TRAIN_LAUNCHES,
        cs.UNFUSED_TRAIN_LAUNCHES, cs.EVAL_LAUNCHES))
    assert len(missed) == want == 30
    src = inspect.getsource(cs.main)
    order = ['ssl_cycle_phase(', 'timeline("ssl_cycle")', 'cap_studies_phase(',
             'timeline("cap_studies")', 'parcel_phase(']
    assert [src.index(x) for x in order] == sorted(src.index(x) for x in order)
