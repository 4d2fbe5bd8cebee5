"""Fused set-abstraction interior for training (counterpart of
`stratanet2_tpu/ops/pallas_kernels.py::sa_train_fused` and its custom VJP
`_sa_train_for`, :2019-2287).

The edges of a set-abstraction stage are rebuilt from the per-point layer-1
projection q and the centroid term cterm in each of four passes
(`cuda_kernels.sa_train_*`, csrc/sa_train.cu), so no (B, C, K, F) edge
tensor is written. BatchNorm is a monotone per-channel affine, so the max
over the K slots of BN(h) is BN(max h) where gamma >= 0 and BN(min h)
elsewhere; the forward keeps both with their winner slots and folds the
last BN on the (B, C, C2) result.

  forward  [stats]  BN1 batch statistics (two layers), folded into a1, c1
           main     last layer's statistics, per-centroid max/min + winners
  backward          the last BN's S1 = sum dy, S2 = sum dy * xhat from the
                    winners alone (dy is zero elsewhere)
           [bwd1]   BN1's S1/S2, dW2, db2 (two layers)
           bwd2     dq (a scatter over points) and dcterm

Each cotangent of the output goes to ONE slot, the first winner (strict >
for the max, < for the min); masked slots never win. Where slots tie, an
unfused `amax` splits the cotangent among them instead. Tied slots hold
equal values, so every gradient term they feed is equal, and the split
and the single winner give the same gradients up to rounding, ties at a
ReLU's zero included (`tests/test_torch_port_sa_train.py` builds such
ties). The per-channel folds and selections on (C2,) and (B, C, C2)
tensors stay in torch, as JAX keeps them in XLA.

Over a data-parallel group (`group`), each rank runs the passes on its own
rows and the batch statistics are the global batch's, as JAX's DP step is
its single-device step on the global batch: M, the stats pass's sums, the
main pass's sums, and in the backward the last BN's S1/S2 and bwd1's
S1/S2 are all-reduced before the next pass uses them. The local S1/S2 are
also the gamma/beta gradients; those are returned unreduced, since the
train step all-reduces every parameter gradient once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.parallel.collectives import all_reduce

BN_EPS = 1e-5  # models/nn.BN_EPS, torch BatchNorm1d's (kept here: models imports ops)


def _batch_stats(s, sq, m_edges, shift):
    """Shifted one-pass sums over M edges -> (mean, biased var)."""
    dmean = s / m_edges
    return dmean + shift, torch.clamp_min(sq / m_edges - dmean * dmean, 0.0)


def _global(group, *sums):
    """The sums over the group's ranks, in one all-reduce."""
    if group is None:
        return sums
    flat = all_reduce(torch.cat([t.reshape(-1) for t in sums]), "sum", group)
    parts = torch.split(flat, [t.numel() for t in sums])
    return tuple(p.reshape(t.shape) for p, t in zip(parts, sums))


def _bn_fold(gamma, beta, mean, var):
    """Train BN as a per-channel affine x*inv + shift (pallas_kernels.py:2019)."""
    inv = torch.rsqrt(var + BN_EPS) * gamma
    return inv, beta - mean * inv


class _SATrainFused(torch.autograd.Function):
    """One or two layers (w2 None or not). Outputs: out (B, C, C2), M, then
    (mean, biased var) per layer; only `out` is differentiable. Gradients
    reach q, cterm, every gamma and beta, W2 and b2; none reach idx, mask
    or the shifts."""

    @staticmethod
    def forward(ctx, q, cterm, gamma1, beta1, w2, b2, gamma2, beta2, idx, mask, shift1, shift2,
                group):
        two = w2 is not None
        width = max(q.shape[2], w2.shape[1] if two else 0)
        (m_edges,) = _global(group, mask.sum().float().reshape(1))
        m_edges = m_edges[0].clamp_min(1.0)
        if two:
            s1, sq1 = _global(group, *ck.sa_train_stats(q, cterm, idx, mask,
                                                        ck.sa_aff(width, shift1=shift1)))
            mean1, var1 = _batch_stats(s1, sq1, m_edges, shift1)
            a1, c1 = _bn_fold(gamma1, beta1, mean1, var1)
            aff = ck.sa_aff(width, a1=a1, c1=c1, b2=b2, shift_l=shift2)
            stats = (mean1, var1)
            g_last, b_last, shift_l = gamma2, beta2, shift2
        else:
            aff = ck.sa_aff(width, shift_l=shift1)
            stats = ()
            g_last, b_last, shift_l = gamma1, beta1, shift1
        sl, sql, vmax, vmin, amax, amin = ck.sa_train_main(q, cterm, idx, mask, aff, w2)
        sl, sql = _global(group, sl, sql)
        mean_l, var_l = _batch_stats(sl, sql, m_edges, shift_l)
        inv_l, sh_l = _bn_fold(g_last, b_last, mean_l, var_l)
        pos = g_last >= 0
        hwin = torch.where(pos, vmax, vmin)  # (B, C, C2) pre-BN value of the winner
        awin = torch.where(pos, amax, amin).contiguous()
        out = hwin * inv_l + sh_l
        stats += (mean_l, var_l)
        ctx.save_for_backward(q, cterm, idx, mask, aff, w2, gamma1, gamma2, hwin, awin,
                              m_edges, *stats)
        ctx.mark_non_differentiable(m_edges, *stats)
        ctx.group = group
        return (out, m_edges) + stats

    @staticmethod
    def backward(ctx, g_out, *_):
        q, cterm, idx, mask, aff, w2, gamma1, gamma2, hwin, awin, m_edges, *stats = (
            ctx.saved_tensors
        )
        two = w2 is not None
        width = aff.shape[1]
        gt = g_out.float().contiguous()
        mean_l, var_l = stats[-2:]
        inv_s = 1.0 / torch.sqrt(var_l + BN_EPS)
        xw = (hwin - mean_l) * inv_s
        s1_l, s2_l = gt.sum((0, 1)), (gt * xw).sum((0, 1))  # the last BN's, from the winners
        g1_l, g2_l = _global(ctx.group, s1_l, s2_l)
        if two:
            mean1, var1 = stats[0], stats[1]
            sig1 = torch.sqrt(var1 + BN_EPS)
            aff = ck.sa_aff(width, aff, gos2=gamma2 * inv_s, m2=mean_l, inv_s2=inv_s,
                            s1n2=g1_l / m_edges, s2n2=g2_l / m_edges, m1=mean1,
                            inv_s1=1.0 / sig1)
            s11, s21, db2, dw2 = ck.sa_train_bwd1(q, cterm, idx, mask, aff, w2, awin, gt)
            g11, g21 = _global(ctx.group, s11, s21)
            aff = ck.sa_aff(width, aff, gos1=gamma1 / sig1, s1n1=g11 / m_edges,
                            s2n1=g21 / m_edges)
            dq, dcterm = ck.sa_train_bwd2(q, cterm, idx, mask, aff, w2, awin, gt)
            return dq, dcterm, s21, s11, dw2, db2, s2_l, s1_l, None, None, None, None, None
        aff = ck.sa_aff(width, aff, m1=mean_l, inv_s1=inv_s, gos1=gamma1 * inv_s,
                        s1n1=g1_l / m_edges, s2n1=g2_l / m_edges)
        dq, dcterm = ck.sa_train_bwd2(q, cterm, idx, mask, aff, None, awin, gt)
        return dq, dcterm, s2_l, s1_l, None, None, None, None, None, None, None, None, None


def sa_train_fused(
    q: torch.Tensor,
    cterm: torch.Tensor,
    bn_scales: Sequence[torch.Tensor],
    bn_biases: Sequence[torch.Tensor],
    w2: Optional[torch.Tensor],
    b2: Optional[torch.Tensor],
    idx: torch.Tensor,
    mask: torch.Tensor,
    bn_shifts: Sequence[torch.Tensor],
    group=None,
):
    """The train-mode SA interior: relu(q[idx] - cterm) -> BN1 [-> Linear W2,
    b2 -> ReLU -> BN2] -> max over the K slots, with BatchNorm on the batch
    statistics of the valid edges.

    q (B, N, C1) per-point layer-1 projection with bias, cterm (B, C, C1)
    centroid term, per-layer BN (gamma, beta) in `bn_scales`/`bn_biases`
    (one or two entries), w2 (C1, C2) and b2 (C2,) or None, idx/mask
    (B, C, K) int32/bool from `cuda_kernels.ball_query`; `bn_shifts`, the
    per-layer running means, shift the one-pass statistics. Returns out
    (B, C, C2), per-layer (batch mean, biased batch var), and M =
    max(number of valid edges, 1) as a float32 scalar. With a process
    `group`, the statistics and M are those of every rank's edges."""
    two = w2 is not None
    if two:
        out, me, m1, v1, m2, v2 = _SATrainFused.apply(
            q.contiguous(), cterm.contiguous(), bn_scales[0], bn_biases[0], w2.contiguous(),
            b2, bn_scales[1], bn_biases[1], idx, mask, bn_shifts[0], bn_shifts[1], group,
        )
        return out, ((m1, v1), (m2, v2)), me
    out, me, m, v = _SATrainFused.apply(
        q.contiguous(), cterm.contiguous(), bn_scales[0], bn_biases[0], None, None, None, None,
        idx, mask, bn_shifts[0], None, group,
    )
    return out, ((m, v),), me
