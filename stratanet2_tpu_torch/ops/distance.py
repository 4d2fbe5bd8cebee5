"""Squared distances rounded exactly as the JAX reference rounds them.

Selections (FPS, grouped ball query, kNN) compare float32 distances and
break ties by index, so a distance that rounds one way on one side and
another way on the other can change a pick. The JAX package's CPU path
(XLA) computes every 3-term sum of products as a chain of fused
multiply-adds: |p|^2 = fma(z, z, fma(y, y, x*x)) and a.b =
fma(az, bz, fma(ay, by, ax*bx)), each fma rounded once. The plain versions
here compute the same correctly rounded fmas (in float64 with
round-to-odd, which is exact for a float32 result), and the CUDA kernels
use `__fmaf_rn` in the same order: kernel, plain version and JAX agree bit
for bit on every distance. No matmul touches a distance, so no TF32 either.
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c for float32 tensors, rounded once to float32 (as fmaf).

    The float64 product of two float32 values is exact; the float64 sum s
    is made round-to-odd with its exact error e (TwoSum), and rounding a
    round-to-odd value with at least two spare bits to float32 gives the
    correctly rounded result."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    t = s - p
    e = (p - (s - t)) + (c64 - t)  # s + e == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float("inf"), float("-inf"))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) . (..., 3) -> (...) as fma(az, bz, fma(ay, by, ax*bx))."""
    return fma_f32(a[..., 2], b[..., 2], fma_f32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def sq_norm3(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) |p|^2 as fma(z, z, fma(y, y, x*x))."""
    return dot3(p, p)


def expanded_d2(
    a: torch.Tensor, a_sq: torch.Tensor, b: torch.Tensor, b_sq: torch.Tensor
) -> torch.Tensor:
    """Squared distances (B, A, Bn) between rows of a (B, A, 3) and
    b (B, Bn, 3) in the expanded form max((|a|^2 - 2 a.b) + |b|^2, 0) of the
    JAX reference (ballquery.py:76-88, knn.py:79-86)."""
    ab = dot3(a[:, :, None, :], b[:, None, :, :])
    d2 = (a_sq[:, :, None] - 2.0 * ab) + b_sq[:, None, :]
    return torch.clamp_min(d2, 0.0)


CPU_TILE = 1 << 19  # (B, rows, N) distance entries a tile of a plain selection on the CPU


def tile_rows(device: torch.device, b: int, n: int, card_rows: int) -> int:
    """Rows (centroids or targets) a distance tile of a plain selection
    takes against n points in each of b clouds: on the CPU as many as fill
    CPU_TILE entries, which the float64 fma chains then reuse from cache
    (3.4-4.6x faster than 256-512 rows at N = 65,536); on the card
    `card_rows`. Tiles cut rows only, so every distance and pick is the
    same at any tile."""
    return max(1, CPU_TILE // (b * n)) if device.type == "cpu" else card_rows

