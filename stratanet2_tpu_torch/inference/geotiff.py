"""Minimal GeoTIFF reader/writer in pure Python/numpy; a copy of
`stratanet2_tpu/inference/geotiff.py`.

Replaces the GDAL/rasterio dependency of the reference
(inference/geotiff_raster.py:64-100) for the raster shapes this pipeline
produces: band-sequential float32 GeoTIFFs with a geotransform, an EPSG
code (Lambert-93 EPSG:2154 by default, geotiff_raster.py:74-77), NaN
nodata, and GDAL-style band descriptions.

Layout written: little-endian classic TIFF, PlanarConfiguration=2 (one strip
per band), SampleFormat=IEEE float. Band descriptions are stored in the
GDAL_METADATA tag (42112) exactly as GDAL's SetDescription does, and nodata
in GDAL_NODATA (42113), so files interoperate with GDAL/QGIS.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# TIFF tag ids
T_WIDTH, T_HEIGHT = 256, 257
T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 258, 259, 262
T_STRIP_OFFSETS, T_SPP, T_ROWS_PER_STRIP, T_STRIP_COUNTS = 273, 277, 278, 279
T_PLANAR, T_SAMPLE_FORMAT = 284, 339
T_MODEL_PIXEL_SCALE, T_MODEL_TIEPOINT, T_GEO_KEYS = 33550, 33922, 34735
T_GDAL_METADATA, T_GDAL_NODATA = 42112, 42113

TYPE_SHORT, TYPE_LONG, TYPE_DOUBLE, TYPE_ASCII = 3, 4, 12, 2
_TYPE_SIZE = {TYPE_SHORT: 2, TYPE_LONG: 4, TYPE_DOUBLE: 8, TYPE_ASCII: 1}
_TYPE_FMT = {TYPE_SHORT: "H", TYPE_LONG: "I", TYPE_DOUBLE: "d"}


@dataclass
class GeoTiff:
    bands: np.ndarray  # (C, H, W) float32
    geotransform: List[float]  # [x0, px_w, 0, y0, 0, -px_h] (GDAL order)
    epsg: int = 2154
    band_names: List[str] = field(default_factory=list)
    nodata: float = float("nan")

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax)."""
        g = self.geotransform
        h, w = self.bands.shape[1:]
        xs = [g[0], g[0] + w * g[1]]
        ys = [g[3], g[3] + h * g[5]]
        return min(xs), min(ys), max(xs), max(ys)

    def xy_of_pixel_centers(self):
        """Geographic coordinates of every pixel center."""
        g = self.geotransform
        h, w = self.bands.shape[1:]
        cols = np.arange(w) + 0.5
        rows = np.arange(h) + 0.5
        x = g[0] + cols * g[1]
        y = g[3] + rows * g[5]
        return np.meshgrid(x, y)


def get_geotransform(plot_center_xy, diam_meters: int, diam_pix: int) -> List[float]:
    """Plot-centered geotransform (inference/geotiff_raster.py:46-61)."""
    return [
        float(plot_center_xy[0]) - diam_meters // 2,
        diam_meters / diam_pix,
        0.0,
        float(plot_center_xy[1]) + diam_meters // 2,
        0.0,
        -diam_meters / diam_pix,
    ]


def _gdal_metadata_xml(band_names: Sequence[str]) -> str:
    items = "".join(
        f'<Item name="DESCRIPTION" sample="{i}" role="description">{n}</Item>'
        for i, n in enumerate(band_names)
    )
    return f"<GDALMetadata>{items}</GDALMetadata>"


def write_geotiff(
    path: str,
    bands: np.ndarray,
    geotransform: Sequence[float],
    epsg: int = 2154,
    band_names: Optional[Sequence[str]] = None,
) -> None:
    bands = np.ascontiguousarray(np.asarray(bands, np.float32))
    if bands.ndim == 2:
        bands = bands[None]
    c, h, w = bands.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    entries = []  # (tag, type, count, value(s))
    entries.append((T_WIDTH, TYPE_LONG, 1, [w]))
    entries.append((T_HEIGHT, TYPE_LONG, 1, [h]))
    entries.append((T_BITS, TYPE_SHORT, c, [32] * c))
    entries.append((T_COMPRESSION, TYPE_SHORT, 1, [1]))
    entries.append((T_PHOTOMETRIC, TYPE_SHORT, 1, [1]))
    entries.append((T_SPP, TYPE_SHORT, 1, [c]))
    entries.append((T_ROWS_PER_STRIP, TYPE_LONG, 1, [h]))
    entries.append((T_PLANAR, TYPE_SHORT, 1, [2]))
    entries.append((T_SAMPLE_FORMAT, TYPE_SHORT, c, [3] * c))
    gt = list(geotransform)
    entries.append((T_MODEL_PIXEL_SCALE, TYPE_DOUBLE, 3, [gt[1], -gt[5], 0.0]))
    entries.append((T_MODEL_TIEPOINT, TYPE_DOUBLE, 6, [0.0, 0.0, 0.0, gt[0], gt[3], 0.0]))
    # GeoKeyDirectory: version 1.1.0, 3 keys: model type=projected(1),
    # raster type=pixel-is-area(1), ProjectedCSType=epsg
    geo_keys = [1, 1, 0, 3, 1024, 0, 1, 1, 1025, 0, 1, 1, 3072, 0, 1, epsg]
    entries.append((T_GEO_KEYS, TYPE_SHORT, len(geo_keys), geo_keys))
    meta = _gdal_metadata_xml(list(band_names) if band_names else [])
    if band_names:
        entries.append((T_GDAL_METADATA, TYPE_ASCII, len(meta) + 1, meta.encode() + b"\0"))
    entries.append((T_GDAL_NODATA, TYPE_ASCII, 4, b"nan\0"))

    strip_sizes = [h * w * 4] * c
    # layout: header(8) | IFD | overflow values | strips
    n_entries = len(entries) + 2  # + strip offsets/counts
    ifd_start = 8
    ifd_size = 2 + n_entries * 12 + 4

    # first pass to size overflow area
    def _val_bytes(t, cnt, vals):
        if t == TYPE_ASCII:
            return bytes(vals)
        return struct.pack("<" + _TYPE_FMT[t] * cnt, *vals)

    overflow_start = ifd_start + ifd_size
    overflow = bytearray()
    packed_entries = []
    all_entries = entries + [
        (T_STRIP_OFFSETS, TYPE_LONG, c, [0] * c),  # patched below
        (T_STRIP_COUNTS, TYPE_LONG, c, strip_sizes),
    ]
    all_entries.sort(key=lambda e: e[0])

    # compute strip offsets now: after overflow area
    tmp_overflow_len = 0
    for tag, t, cnt, vals in all_entries:
        sz = _TYPE_SIZE[t] * cnt
        if sz > 4:
            tmp_overflow_len += sz + (sz % 2)
    data_start = overflow_start + tmp_overflow_len
    strip_offsets = [data_start + i * strip_sizes[0] for i in range(c)]

    for tag, t, cnt, vals in all_entries:
        if tag == T_STRIP_OFFSETS:
            vals = strip_offsets
        raw = _val_bytes(t, cnt, vals)
        if len(raw) <= 4:
            packed_entries.append(struct.pack("<HHI", tag, t, cnt) + raw.ljust(4, b"\0"))
        else:
            off = overflow_start + len(overflow)
            packed_entries.append(struct.pack("<HHII", tag, t, cnt, off))
            overflow += raw
            if len(raw) % 2:
                overflow += b"\0"

    # atomic write: merged parcel tifs double as the inference worklist's
    # done-markers (utils/worklist.py matches by stem), so a crash mid-write
    # must not leave a truncated file that marks the parcel done forever
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_start))
        f.write(struct.pack("<H", n_entries))
        f.write(b"".join(packed_entries))
        f.write(struct.pack("<I", 0))  # next IFD
        f.write(bytes(overflow))
        f.write(bands.tobytes())
    os.replace(tmp, path)


def read_geotiff(path: str) -> GeoTiff:
    with open(path, "rb") as f:
        raw = f.read()
    order, magic, ifd_off = struct.unpack_from("<2sHI", raw, 0)
    assert order == b"II" and magic == 42, f"{path}: unsupported TIFF flavor"
    (n,) = struct.unpack_from("<H", raw, ifd_off)
    tags: Dict[int, tuple] = {}
    for i in range(n):
        tag, t, cnt = struct.unpack_from("<HHI", raw, ifd_off + 2 + i * 12)
        if t != TYPE_ASCII and t not in _TYPE_FMT:
            # tags of types this reader doesn't decode (RATIONAL
            # XResolution from a Pillow/QGIS re-save, BYTE blobs, ...) are
            # irrelevant to the band data — skip them instead of KeyError'ing
            # the whole mosaic/predict run on an interoperable file
            continue
        voff = ifd_off + 2 + i * 12 + 8
        sz = _TYPE_SIZE.get(t, 1) * cnt
        if sz > 4:
            (voff,) = struct.unpack_from("<I", raw, voff)
        if t == TYPE_ASCII:
            vals = raw[voff : voff + cnt].rstrip(b"\0").decode(errors="replace")
        else:
            vals = list(struct.unpack_from("<" + _TYPE_FMT[t] * cnt, raw, voff))
        tags[tag] = vals

    w, h = tags[T_WIDTH][0], tags[T_HEIGHT][0]
    c = tags.get(T_SPP, [1])[0]
    assert tags.get(T_COMPRESSION, [1])[0] == 1, "compressed TIFF unsupported"
    # this reader decodes strips as f32; reinterpreting integer samples
    # would silently produce denormal garbage bands
    bits = tags.get(T_BITS, [32])
    sfmt = tags.get(T_SAMPLE_FORMAT, [3] * c)
    assert all(b == 32 for b in bits) and all(s == 3 for s in sfmt), (
        f"{path}: only 32-bit IEEE-float samples supported "
        f"(BitsPerSample={bits}, SampleFormat={sfmt})"
    )
    offsets = tags[T_STRIP_OFFSETS]
    planar = tags.get(T_PLANAR, [1])[0]
    counts = tags.get(T_STRIP_COUNTS)
    if counts and len(counts) == len(offsets) and len(offsets) > 1:
        # GDAL default layout: many strips (RowsPerStrip rows each), not
        # necessarily contiguous in the file — assemble them explicitly
        data = b"".join(raw[o : o + sz] for o, sz in zip(offsets, counts))
        flat = np.frombuffer(data, np.float32, h * w * c)
    else:  # this writer's layout: one strip per band (planar=2) or one total
        n_per = h * w if planar == 2 and len(offsets) == c else h * w * c
        flat = np.concatenate(
            [np.frombuffer(raw, np.float32, n_per, off) for off in offsets]
        )
    if planar == 2:
        bands = flat.reshape(c, h, w)
    else:  # interleaved
        bands = flat.reshape(h, w, c).transpose(2, 0, 1)

    scale = tags.get(T_MODEL_PIXEL_SCALE, [1.0, 1.0, 0.0])
    tie = tags.get(T_MODEL_TIEPOINT, [0.0] * 6)
    gt = [tie[3], scale[0], 0.0, tie[4], 0.0, -scale[1]]

    epsg = 0
    geo = tags.get(T_GEO_KEYS)
    if geo:
        for k in range(4, len(geo), 4):
            if geo[k] == 3072:
                epsg = geo[k + 3]

    names: List[str] = []
    meta = tags.get(T_GDAL_METADATA, "")
    if meta:
        import re

        pairs = re.findall(r'sample="(\d+)"[^>]*>([^<]*)</Item>', meta)
        names = [v for _k, v in sorted(pairs, key=lambda p: int(p[0]))]

    return GeoTiff(bands=bands.copy(), geotransform=gt, epsg=epsg, band_names=names)
