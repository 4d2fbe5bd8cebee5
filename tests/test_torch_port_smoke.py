"""CPU checks of the parts of chip_smoke.py and of the kernel wrappers that
need no card: the SASS parsers of phase 16 on a synthetic `cuobjdump -sass`
listing, the kNN reference sites' inputs, and the kNN wrapper's split of
sources across warps."""

import pytest
import torch

import chip_smoke as cs
from stratanet2_tpu_torch.ops import cuda_kernels as ck

# a listing in cuobjdump's layout: a kNN-like scan loop (0x10-0x80) whose
# forward branch at 0x40 skips an insert of two instructions, and two
# bwd2-like edge loops, one with a shuffle
SASS = """
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
        Function : _Z20sa_train_bwd2_kernelILi16ELb1EEvPKfS1_PKiPKbS1_S3_S1_PfS6_iiii
        /*0000*/                   SHFL.IDX R1, R2, R3, 0x1f ;
        /*0010*/                   FFMA R4, R4, R5, R6 ;
        /*0020*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R4 ;
        /*0030*/              @P0 BRA 0x0 ;
        /*0040*/                   EXIT ;
        Function : _Z20sa_train_bwd2_kernelILi32ELb0EEvPKfS1_PKiPKbS1_S3_S1_PfS6_iiii
        /*0000*/                   FFMA R4, R4, R5, R6 ;
        /*0010*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R4 ;
        /*0020*/              @P0 BRA 0x0 ;
        /*0030*/                   EXIT ;
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


def test_sass_edge_loops_count_shuffles_an_edge():
    loops = cs.sass_edge_loops(SASS, cs.BWD2_EDGES_A_PASS)
    two = loops["_Z20sa_train_bwd2_kernelILi16ELb1EEvPKfS1_PKiPKbS1_S3_S1_PfS6_iiii"]
    one = loops["_Z20sa_train_bwd2_kernelILi32ELb0EEvPKfS1_PKiPKbS1_S3_S1_PfS6_iiii"]
    assert len(loops) == 2
    assert two["per_edge"] == 4 / cs.BWD2_EDGES_A_PASS
    assert two["shfl_per_edge"] == 1 / cs.BWD2_EDGES_A_PASS
    assert two["fp32_per_edge"] == 1 / cs.BWD2_EDGES_A_PASS
    assert (one["instructions"], one["shfl_per_edge"]) == (3, 0.0)


def test_knn_reference_sites_are_tie_heavy_ragged_and_chunked():
    """The inputs of kNN's reference sites have the properties their
    comment in chip_smoke.py claims."""
    calls = cs.knn_reference_calls(torch, torch.device("cpu"))
    assert len(calls) == len(cs.KNN_REFERENCE)
    for (kind, b, s, t, f), (x, src, tgt) in zip(cs.KNN_REFERENCE, calls):
        assert (x.shape, src.shape, tgt.shape) == ((b, s, f), (b, s, 3), (b, t, 3))
        assert x.dtype == src.dtype == tgt.dtype == torch.float32
        if kind == "grid":
            assert torch.equal(src, src.round()) and torch.equal(tgt, tgt.round())
            half = s // 2
            assert torch.equal(src[:, half : half + s // 8], src[:, : s // 8])
            on_src = (tgt[:, : t // 8, None] == src[:, None]).all(-1).any(-1)
            assert bool(on_src.all())
    kinds = {kind: (s, t) for kind, _, s, t, _ in cs.KNN_REFERENCE}
    assert kinds["s3"][0] == 3
    assert all(v % 32 for v in kinds["ragged"])
    assert kinds["chunked"][0] > 4096  # csrc/knn_interpolate.cu stages 4096 sources at once


@pytest.mark.parametrize("b,t,slices", [(20, 10000, 2), (20, 2500, 8), (200, 10000, 1),
                                        (2, 33, 8), (32, 2500, 4)])
def test_knn_slices_fill_the_card(b, t, slices):
    """The fewest warps a target group that give 64 warps an SM of 132."""
    assert ck.knn_slices(b, t) == slices
    if slices < ck.KNN_WARPS:
        assert b * -(-t // 32) * slices >= ck.KNN_MIN_WARPS
    if slices > 1:
        assert b * -(-t // 32) * (slices // 2) < ck.KNN_MIN_WARPS
