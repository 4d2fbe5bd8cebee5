"""2D projection of pointwise coverages (counterpart of
`stratanet2_tpu/ops/projection.py`, reference model/project_to_2d.py).

- `plotwise_coverages`: per-cloud min-max-normalised xy binned into
  diam_pix^2 cells, per-pixel max of the low/med/high coverages, bare soil
  = 1 - low per occupied pixel, mean over occupied pixels -> (B, 4).
- `raster_projection` / `batched_raster_projection`: absolute-coordinate
  binning of the rescaled (x/10) cloud, per-pixel max, NaN where no point
  falls, y-flipped -> (3, P, P) / (B, 3, P, P).

The pixel ids repeat the JAX float32 floor/clip arithmetic operation by
operation, so both packages bin every point alike. The per-pixel max is
`cuda_kernels.pixel_max`: the CUDA kernel on the card, the dense masked max
on the CPU. Only the [low, med, high] channels need it: bare soil derives
from low. `plotwise_coverages` is differentiable in the coverages, as the
train step needs: each pixel's cotangent goes to its winning point through
`cuda_kernels.pixel_max_bwd`, the one-winner backward of `pixel_max_pallas`
(pallas_kernels.py:1389-1451). `batched_raster_projection` is forward-only.
"""

from __future__ import annotations

import torch

from stratanet2_tpu_torch.ops import cuda_kernels


def _pixel_bins_minmax(xy: torch.Tensor, diam_pix: int) -> torch.Tensor:
    """(B, N, 2) -> (B, N) int32 pixel ids (projection.py:33-42)."""
    mn = torch.amin(xy, dim=1, keepdim=True)
    mx = torch.amax(xy, dim=1, keepdim=True)
    b = torch.floor((xy - mn) / (mx - mn + 1e-4) * diam_pix).int()
    b = torch.clamp(b, 0, diam_pix - 1)
    return b[..., 0] * diam_pix + b[..., 1]


def _raster_bins(xy_rescaled: torch.Tensor, diam_pix: int, diam_meters: int) -> torch.Tensor:
    """(..., 2) rescaled xy -> (...) int32 ids row*P + col (projection.py:117-126)."""
    sf = 10.0 * diam_pix / diam_meters
    b = torch.floor((xy_rescaled + 1e-4) * sf + diam_meters // 2).int()
    b = torch.clamp(b, 0, diam_pix - 1)
    return b[..., 1] * diam_pix + b[..., 0]


class _PixelMax(torch.autograd.Function):
    """`cuda_kernels.pixel_max`, differentiable in the values."""

    @staticmethod
    def forward(ctx, pix, vals, n_pix):
        vmax, amax = cuda_kernels.pixel_max(pix, vals, n_pix)
        ctx.save_for_backward(pix, amax)
        ctx.mark_non_differentiable(amax)
        return vmax, amax

    @staticmethod
    def backward(ctx, g_vmax, _g_amax):
        pix, amax = ctx.saved_tensors
        return None, cuda_kernels.pixel_max_bwd(pix, amax, g_vmax.contiguous()), None


def _low_med_high(cov: torch.Tensor) -> torch.Tensor:
    return torch.stack([cov[..., 0], cov[..., 2], cov[..., 3]], dim=-1).contiguous()


def plotwise_coverages(
    coverages_pointwise: torch.Tensor, xy: torch.Tensor, diam_pix: int
) -> torch.Tensor:
    """(B, N, 4) coverages [low, bare, med, high] and (B, N, 2) xy -> (B, 4)
    mean over occupied pixels of [max low, 1 - max low, max med, max high]."""
    pix = _pixel_bins_minmax(xy.float(), diam_pix).contiguous()
    vmax, amax = _PixelMax.apply(
        pix, _low_med_high(coverages_pointwise.float()), diam_pix * diam_pix
    )
    occ = amax[..., 0] >= 0  # (B, P^2)
    pm = torch.where(occ[..., None], vmax, 0.0)
    n_occ = torch.clamp_min(occ.float().sum(1), 1.0)
    low, med, high = pm[..., 0], pm[..., 1], pm[..., 2]
    bare = torch.where(occ, 1.0 - low, 0.0)
    sums = torch.stack([low.sum(1), bare.sum(1), med.sum(1), high.sum(1)], dim=1)
    return sums / n_occ[:, None]


def batched_raster_projection(
    xy_rescaled: torch.Tensor,
    coverages_pointwise: torch.Tensor,
    diam_pix: int,
    diam_meters: int,
) -> torch.Tensor:
    """(B, N, 2) rescaled xy, (B, N, 4) coverages -> (B, 3, P, P) rasters
    [low, med, high], NaN where empty, row 0 the northernmost."""
    pix = _raster_bins(xy_rescaled.float(), diam_pix, diam_meters).contiguous()
    vmax, amax = cuda_kernels.pixel_max(
        pix, _low_med_high(coverages_pointwise.float()), diam_pix * diam_pix
    )
    sel = torch.where(amax[..., :1] >= 0, vmax, float("nan"))  # (B, P^2, 3)
    rasters = sel.transpose(1, 2).reshape(-1, 3, diam_pix, diam_pix)
    return torch.flip(rasters, dims=[2])


def raster_projection(
    xy_rescaled: torch.Tensor,
    coverages_pointwise: torch.Tensor,
    diam_pix: int,
    diam_meters: int,
) -> torch.Tensor:
    """One cloud: (N, 2), (N, 4) -> (3, P, P)."""
    return batched_raster_projection(
        xy_rescaled[None], coverages_pointwise[None], diam_pix, diam_meters
    )[0]
