"""Vectorized polygon/raster geometry (a copy of
`stratanet2_tpu/inference/polygons.py`), replacing shapely/GEOS and
rasterio.features for the operations this pipeline uses:

- point-in-polygon + point-to-boundary distance -> buffered containment
  (reference `keep_points_in_shape` / `keep_points_outside_shape`,
  inference/prepare_utils.py:168-185: `shape.buffer(d).contains(point)`);
- binary-mask sieve (drop connected components < N pixels, rasterio sieve at
  inference/geotiff_raster.py:164-166);
- disk erosion of a binary mask — the raster-space equivalent of
  "vectorize + negative buffer + rasterize pixel centers" used for the
  admissibility band (geotiff_raster.py:174-187): a pixel center is inside
  the -d-buffered polygon union iff the full disk of radius d around it is
  covered by the mask.

The morphology imports scipy's `ndimage` inside the functions that use it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class Polygon:
    """A polygon with optional holes, rings as (K, 2) float arrays."""

    def __init__(self, rings: Sequence[np.ndarray]):
        assert rings, "polygon needs at least one ring"
        self.rings = []
        for r in rings:
            r = np.asarray(r, np.float64)
            assert r.ndim == 2 and r.shape[1] == 2
            # _ray_cast/_segments_distance walk segments ring[i]->ring[i+1]
            # and need the closing edge: close the ring if the caller didn't
            # (shapefile rings arrive closed; hand-built ones often don't)
            if not np.array_equal(r[0], r[-1]):
                r = np.concatenate([r, r[:1]])
            self.rings.append(r)

    @property
    def exterior(self) -> np.ndarray:
        return self.rings[0]

    def bounds(self) -> Tuple[float, float, float, float]:
        xy = np.concatenate(self.rings)
        return xy[:, 0].min(), xy[:, 1].min(), xy[:, 0].max(), xy[:, 1].max()

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """Even-odd rule over all rings (handles holes). pts (N, 2) -> (N,) bool."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        inside = np.zeros(len(pts), bool)
        for ring in self.rings:
            for lo, hi in _point_chunks(len(pts), len(ring)):
                inside[lo:hi] ^= _ray_cast(pts[lo:hi], ring)
        return inside

    def contains_grid(self, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        """`contains` evaluated on the regular grid ys x xs, by scanline.

        Exactly the even-odd rule of `contains` (joint parity over all
        rings), but each row computes the ring/scanline intersections once
        — O(rows·(segments + cols·log segments)) instead of the pointwise
        O(rows·cols·segments). A 1e6-pixel mosaic against a 1500-vertex
        parcel ring drops from ~28 s to milliseconds (measured, 1 core).

        Returns (len(ys), len(xs)) bool."""
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        segs = np.concatenate([np.stack([r[:-1], r[1:]], 1) for r in self.rings])
        x1, y1 = segs[:, 0, 0], segs[:, 0, 1]
        x2, y2 = segs[:, 1, 0], segs[:, 1, 1]
        out = np.zeros((len(ys), len(xs)), bool)
        for i, y in enumerate(ys):
            cond = (y1 <= y) != (y2 <= y)
            if not cond.any():
                continue
            xi = x1[cond] + (y - y1[cond]) * (x2[cond] - x1[cond]) / (
                y2[cond] - y1[cond]
            )
            xi.sort()
            # same strict `x < x_int` crossing rule as _ray_cast: crossings
            # to the right of x = len(xi) - #(xi <= x)
            idx = np.searchsorted(xi, xs, side="right")
            out[i] = ((len(xi) - idx) % 2) == 1
        return out

    def boundary_distance(self, pts: np.ndarray) -> np.ndarray:
        """Distance from each point to the nearest ring segment."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        best = np.full(len(pts), np.inf)
        for ring in self.rings:
            for lo, hi in _point_chunks(len(pts), len(ring)):
                best[lo:hi] = np.minimum(
                    best[lo:hi], _segments_distance(pts[lo:hi], ring)
                )
        return best

    def contains_buffered(self, pts: np.ndarray, buffer: float) -> np.ndarray:
        """point in polygon.buffer(buffer) — for buffer >= 0 equivalent to
        inside-or-within-distance (what the reference uses for plot-center
        filtering, prepare_utils.py:146-151)."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        if buffer <= 0:
            inside = self.contains(pts)
            if buffer == 0:
                return inside
            return inside & (self.boundary_distance(pts) >= -buffer)
        return self.contains(pts) | (self.boundary_distance(pts) <= buffer)


def _point_chunks(n_pts: int, n_ring: int, budget: int = 4_000_000):
    """Yield (lo, hi) point ranges sized so the (points x segments) f64
    intermediates stay ~<100 MB: a parcel-scale mosaic (1e6 pixel centers)
    against a 1500-vertex ring would otherwise materialize >10 GB at once
    in _ray_cast/_segments_distance — same math, bounded memory."""
    step = max(1, budget // max(n_ring, 1))
    for lo in range(0, max(n_pts, 1), step):
        yield lo, min(lo + step, n_pts)


def _ray_cast(pts: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Even-odd ray casting, vectorized over points x segments."""
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x1, y1 = ring[:-1, 0][None, :], ring[:-1, 1][None, :]
    x2, y2 = ring[1:, 0][None, :], ring[1:, 1][None, :]
    cond = (y1 <= y) != (y2 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
    crossings = cond & (x < x_int)
    return np.sum(crossings, axis=1) % 2 == 1


def _segments_distance(pts: np.ndarray, ring: np.ndarray) -> np.ndarray:
    a = ring[:-1][None, :, :]  # (1, S, 2)
    b = ring[1:][None, :, :]
    p = pts[:, None, :]  # (N, 1, 2)
    ab = b - a
    denom = np.maximum(np.sum(ab * ab, axis=-1), 1e-300)
    t = np.clip(np.sum((p - a) * ab, axis=-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    d2 = np.sum((p - proj) ** 2, axis=-1)
    return np.sqrt(d2.min(axis=1))


def keep_points_in_shape(
    xy: np.ndarray, poly: Polygon, inclusion_buffer: float
) -> np.ndarray:
    """Boolean mask of points inside the buffered shape
    (prepare_utils.py:168-176)."""
    return poly.contains_buffered(np.asarray(xy, np.float64), inclusion_buffer)


def keep_points_outside_shape(
    xy: np.ndarray, poly: Polygon, exclusion_buffer: float
) -> np.ndarray:
    """Boolean mask of points outside the buffered shape
    (prepare_utils.py:179-185)."""
    return ~poly.contains_buffered(np.asarray(xy, np.float64), exclusion_buffer)


# ---------------------------------------------------------------------------
# binary-raster morphology
# ---------------------------------------------------------------------------

def connected_components(mask: np.ndarray, connectivity: int = 4) -> Tuple[np.ndarray, int]:
    """Label connected components of a boolean mask (0-based labels, -1 for
    background). scipy.ndimage.label (C) — parcel-scale mosaics are large."""
    from scipy import ndimage

    mask = np.asarray(mask, bool)
    structure = (
        np.ones((3, 3), bool) if connectivity == 8 else None  # default: 4-conn
    )
    labels, n = ndimage.label(mask, structure=structure)
    return labels.astype(np.int64) - 1, int(n)


def sieve(values: np.ndarray, min_size: int, mask: np.ndarray | None = None) -> np.ndarray:
    """Remove connected patches smaller than min_size, replacing them with 0
    (rasterio.features.sieve semantics for a 0/1 raster as used at
    geotiff_raster.py:164-166). Vectorized: component sizes via bincount,
    one boolean take to kill small components."""
    vals = np.asarray(values).copy()
    valid = ~np.asarray(mask, bool) if mask is not None else np.ones_like(vals, bool)
    ones = (vals == 1) & valid
    labels, n = connected_components(ones)
    if n == 0:
        return vals
    sizes = np.bincount((labels[labels >= 0]).ravel(), minlength=n)
    small = sizes < min_size  # (n,)
    kill = np.zeros(n + 1, bool)
    kill[1:] = small
    vals[kill[labels + 1]] = 0
    return vals


def erode_disk(mask: np.ndarray, radius_pixels: float) -> np.ndarray:
    """Erode a boolean mask by a disk, PER 4-CONNECTED COMPONENT: out[p] =
    the full disk around p lies within p's own component. This matches the
    reference, which polygonizes the mask with rasterio.features.shapes
    (4-connectivity) and negative-buffers each polygon separately
    (geotiff_raster.py:174-187) — two regions touching only diagonally are
    distinct polygons there, so eroding the union would wrongly let one
    region's pixels support the other's disk at the junction."""
    from scipy import ndimage

    mask = np.asarray(mask, bool)
    r = int(np.floor(radius_pixels)) + 1
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    disk = (yy * yy + xx * xx) <= radius_pixels * radius_pixels
    four = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    labels, n = ndimage.label(mask, structure=four)
    out = np.zeros_like(mask)
    if n == 0:
        return out
    # erode each component inside its r-padded bounding box only
    for i, sl in enumerate(ndimage.find_objects(labels), start=1):
        ys = slice(max(sl[0].start - r, 0), min(sl[0].stop + r, mask.shape[0]))
        xs = slice(max(sl[1].start - r, 0), min(sl[1].stop + r, mask.shape[1]))
        comp = labels[ys, xs] == i
        out[ys, xs] |= ndimage.binary_erosion(comp, structure=disk, border_value=0)
    return out
