"""Pure-numpy LAS point-cloud reader/writer (a copy of
`stratanet2_tpu/data/las.py`: files written by either read back on both).

Replaces the reference's `laspy` dependency (utils/load_data.py:11,149-184),
which is not available in this environment. Supports the point formats the
pipeline needs: 2/3 (LAS 1.2, RGB) and 7/8 (LAS 1.4, RGB / RGB+NIR).

Coordinates are returned in meters using the file's scale/offset (the
reference divides raw integer centimeter coordinates by 100, equivalent to
scale=0.01/offset=0; applying the header transform generalizes this).

The writer emits LAS 1.4 / point format 8 (RGB + NIR) and exists chiefly for
synthetic test fixtures and round-trip tests.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

_HEADER_FMT_COMMON = "<4sHHI HH 8sBB 32s32s HHH I I B H I 5I 3d 3d 3d 3d 3d 3d"

# field layout per point format: name -> (dtype, offset) computed per format
_CORE_LEGACY = 20  # formats 0-5 core size
_CORE_14 = 30  # formats 6-10 core size


@dataclass
class LasData:
    """Decoded LAS payload, feature arrays of shape (N,)."""

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    red: np.ndarray
    green: np.ndarray
    blue: np.ndarray
    nir: np.ndarray
    intensity: np.ndarray
    return_num: np.ndarray
    num_returns: np.ndarray


def read_las(path: str) -> LasData:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"LASF":
        raise ValueError(f"{path}: not a LAS file")
    ver_major, ver_minor = raw[24], raw[25]
    (offset_to_points,) = struct.unpack_from("<I", raw, 96)
    (n_vlrs,) = struct.unpack_from("<I", raw, 100)
    if raw[104] & 0x80:
        # LAZ sets bit 7 of the point-format byte; silently masking it
        # would reinterpret the compressed stream as fixed-size records
        # and decode garbage coordinates
        raise ValueError(
            f"{path}: LAZ-compressed point data is not supported — "
            "decompress to .las first (e.g. laszip/pdal)"
        )
    point_format = raw[104] & 0x3F  # mask the remaining laszip marker bits
    (record_len,) = struct.unpack_from("<H", raw, 105)
    (legacy_count,) = struct.unpack_from("<I", raw, 107)
    sx, sy, sz = struct.unpack_from("<3d", raw, 131)
    ox, oy, oz = struct.unpack_from("<3d", raw, 155)
    count = legacy_count
    if ver_major == 1 and ver_minor >= 4:
        (count64,) = struct.unpack_from("<Q", raw, 247)
        if count64:
            count = count64

    body = np.frombuffer(
        raw, dtype=np.uint8, count=count * record_len, offset=offset_to_points
    ).reshape(count, record_len)

    def _i32(col):
        return body[:, col : col + 4].copy().view("<i4").ravel()

    def _u16(col):
        return body[:, col : col + 2].copy().view("<u2").ravel()

    x = _i32(0) * sx + ox
    y = _i32(4) * sy + oy
    z = _i32(8) * sz + oz
    intensity = _u16(12)

    if point_format <= 5:
        flags = body[:, 14]
        return_num = flags & 0x07
        num_returns = (flags >> 3) & 0x07
        core = _CORE_LEGACY
        # gps time present in formats 1, 3, 4, 5
        rgb_off = core + (8 if point_format in (1, 3, 4, 5) else 0)
        has_rgb = point_format in (2, 3, 5)
        has_nir = False
    elif point_format <= 10:
        flags = body[:, 14]
        return_num = flags & 0x0F
        num_returns = (flags >> 4) & 0x0F
        core = _CORE_14
        rgb_off = core
        has_rgb = point_format in (7, 8, 10)
        has_nir = point_format in (8, 10)  # format 10 = RGB+NIR+waveform
    else:
        raise ValueError(f"{path}: unsupported point format {point_format}")

    zeros = np.zeros(count, np.uint16)
    if has_rgb and record_len >= rgb_off + 6:
        red, green, blue = (_u16(rgb_off), _u16(rgb_off + 2), _u16(rgb_off + 4))
    else:
        red = green = blue = zeros
    if has_nir and record_len >= rgb_off + 8:
        nir = _u16(rgb_off + 6)
    else:
        nir = zeros

    return LasData(
        x=x, y=y, z=z,
        red=red.astype(np.float64), green=green.astype(np.float64),
        blue=blue.astype(np.float64), nir=nir.astype(np.float64),
        intensity=intensity.astype(np.float64),
        return_num=return_num.astype(np.float64),
        num_returns=num_returns.astype(np.float64),
    )


def write_las(path: str, fields: Dict[str, np.ndarray], scale: float = 0.01) -> None:
    """Write a LAS 1.4 / point-format-8 file from a dict with keys
    x, y, z (meters) and optional red/green/blue/nir/intensity/
    return_num/num_returns."""
    x = np.asarray(fields["x"], np.float64)
    n = len(x)

    def _get(name, default=0):
        v = fields.get(name)
        if v is None:
            return np.full(n, default, np.float64)
        return np.asarray(v, np.float64)

    y, z = _get("y"), _get("z")
    header_size = 375
    record_len = 38  # format 8
    rec = np.zeros((n, record_len), np.uint8)

    def _put_i32(col, vals):
        rec[:, col : col + 4] = np.round(vals).astype("<i4")[:, None].view(np.uint8)

    def _put_u16(col, vals):
        rec[:, col : col + 2] = (
            np.clip(np.round(vals), 0, 65535).astype("<u2")[:, None].view(np.uint8)
        )

    _put_i32(0, x / scale)
    _put_i32(4, y / scale)
    _put_i32(8, z / scale)
    _put_u16(12, _get("intensity"))
    rn = np.clip(_get("return_num", 1), 0, 15).astype(np.uint8)
    nr = np.clip(_get("num_returns", 1), 0, 15).astype(np.uint8)
    rec[:, 14] = rn | (nr << 4)
    rec[:, 16] = 1  # classification: unclassified
    # gps time (f64) at 22 left zero
    _put_u16(30, _get("red"))
    _put_u16(32, _get("green"))
    _put_u16(34, _get("blue"))
    _put_u16(36, _get("nir"))

    hdr = bytearray(header_size)
    hdr[0:4] = b"LASF"
    hdr[24] = 1  # version major
    hdr[25] = 4  # version minor
    hdr[26 : 26 + 10] = b"stratanet2"[:10]
    hdr[58 : 58 + 14] = b"stratanet2_tpu"
    struct.pack_into("<H", hdr, 94, header_size)  # header size
    struct.pack_into("<I", hdr, 96, header_size)  # offset to points
    struct.pack_into("<I", hdr, 100, 0)  # vlr count
    hdr[104] = 8  # point format
    struct.pack_into("<H", hdr, 105, record_len)
    struct.pack_into("<I", hdr, 107, min(n, 0xFFFFFFFF))  # legacy count
    struct.pack_into("<3d", hdr, 131, scale, scale, scale)
    struct.pack_into("<3d", hdr, 155, 0.0, 0.0, 0.0)
    struct.pack_into("<d", hdr, 179, float(x.max()) if n else 0)  # max x
    struct.pack_into("<d", hdr, 187, float(x.min()) if n else 0)
    struct.pack_into("<d", hdr, 195, float(y.max()) if n else 0)
    struct.pack_into("<d", hdr, 203, float(y.min()) if n else 0)
    struct.pack_into("<d", hdr, 211, float(z.max()) if n else 0)
    struct.pack_into("<d", hdr, 219, float(z.min()) if n else 0)
    struct.pack_into("<Q", hdr, 247, n)  # 1.4 extended count

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(rec.tobytes())
