"""Pure-Python ESRI shapefile reader/writer (polygons + DBF attributes), a
copy of `stratanet2_tpu/inference/shapefile_io.py`.

Replaces the `pyshp` dependency (reference prepare.py:12, predict.py:47,
inference/predict_utils.py:149-177) for the operations the pipeline needs:
reading parcel polygons by their ID attribute, and writing a copy of the
shapefile with appended float prediction fields.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from stratanet2_tpu_torch.inference.polygons import Polygon

SHAPE_POLYGON = 5
SHAPE_NULL = 0


@dataclass
class FieldSpec:
    name: str
    ftype: str = "C"  # C=char, N=numeric, F=float
    length: int = 32
    decimals: int = 0


@dataclass
class ShapeRecord:
    shape: Optional[Polygon]
    record: Dict[str, object]


@dataclass
class Shapefile:
    fields: List[FieldSpec]
    shape_records: List[ShapeRecord]

    def get_shape(self, object_id: str, id_field: str = "ID") -> Polygon:
        """Polygon whose `id_field` attribute equals object_id
        (inference/prepare_utils.py:33-37)."""
        for sr in self.shape_records:
            if str(sr.record.get(id_field)) == str(object_id):
                assert sr.shape is not None, f"{object_id}: null shape"
                return sr.shape
        raise KeyError(f"no shape with {id_field}={object_id}")


def _rings_from_parts(pts: np.ndarray, parts: List[int]) -> List[np.ndarray]:
    bounds = list(parts) + [len(pts)]
    return [pts[bounds[i] : bounds[i + 1]] for i in range(len(parts))]


def read_shapefile(path: str) -> Shapefile:
    """Read .shp + .dbf (path may omit the extension)."""
    base = os.path.splitext(path)[0]
    with open(base + ".shp", "rb") as f:
        raw = f.read()
    (file_code,) = struct.unpack_from(">i", raw, 0)
    assert file_code == 9994, "not a shapefile"

    shapes: List[Optional[Polygon]] = []
    pos = 100
    while pos < len(raw):
        _recno, content_len = struct.unpack_from(">ii", raw, pos)
        pos += 8
        (stype,) = struct.unpack_from("<i", raw, pos)
        if stype == SHAPE_NULL:
            shapes.append(None)
        elif stype in (SHAPE_POLYGON, 3):  # polygon or polyline
            n_parts, n_points = struct.unpack_from("<ii", raw, pos + 36)
            parts = list(struct.unpack_from(f"<{n_parts}i", raw, pos + 44))
            pts = np.frombuffer(
                raw, "<f8", n_points * 2, pos + 44 + 4 * n_parts
            ).reshape(n_points, 2)
            shapes.append(Polygon(_rings_from_parts(pts, parts)))
        else:
            raise ValueError(f"unsupported shape type {stype}")
        pos += content_len * 2

    fields, records = _read_dbf(base + ".dbf")
    assert len(records) == len(shapes), "dbf/shp record mismatch"
    return Shapefile(
        fields=fields,
        # records read back as None were soft-deleted in the DBF: drop the
        # shape/record pair entirely (what GIS tools display)
        shape_records=[
            ShapeRecord(s, r) for s, r in zip(shapes, records) if r is not None
        ],
    )


def _read_dbf(path: str) -> Tuple[List[FieldSpec], List[Dict[str, object]]]:
    with open(path, "rb") as f:
        raw = f.read()
    n_records = struct.unpack_from("<i", raw, 4)[0]
    header_size, record_size = struct.unpack_from("<HH", raw, 8)
    fields: List[FieldSpec] = []
    pos = 32
    while raw[pos] != 0x0D:
        name = raw[pos : pos + 11].split(b"\0")[0].decode("ascii", "replace")
        ftype = chr(raw[pos + 11])
        length = raw[pos + 16]
        decimals = raw[pos + 17]
        fields.append(FieldSpec(name, ftype, length, decimals))
        pos += 32

    records: List[Dict[str, object]] = []
    for i in range(n_records):
        rpos = header_size + i * record_size
        if raw[rpos : rpos + 1] == b"*":
            # soft-deleted record (deletion flag '*'): pyshp — which this
            # replaces — skips these; returning them would desync the
            # record/shape pairing GIS tools display
            records.append(None)  # placeholder keeps shp/dbf indices aligned
            continue
        rec: Dict[str, object] = {}
        cpos = rpos + 1  # skip deletion flag
        for fs in fields:
            sval = raw[cpos : cpos + fs.length].decode("ascii", "replace").strip()
            if fs.ftype in ("N", "F"):
                try:
                    rec[fs.name] = float(sval) if (fs.decimals or fs.ftype == "F") else int(sval)
                except ValueError:
                    # other GIS tools store '715.0' in N/decimals=0 columns;
                    # pyshp (which this replaces) parses those via float
                    try:
                        rec[fs.name] = int(float(sval))
                    except ValueError:
                        rec[fs.name] = None
            else:
                rec[fs.name] = sval
            cpos += fs.length
        records.append(rec)
    return fields, records


def write_shapefile(path: str, shp: Shapefile) -> None:
    """Write .shp, .shx and .dbf."""
    base = os.path.splitext(path)[0]
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)

    rec_blobs: List[bytes] = []
    for sr in shp.shape_records:
        if sr.shape is None:
            rec_blobs.append(struct.pack("<i", SHAPE_NULL))
            continue
        rings = sr.shape.rings
        pts = np.concatenate(rings)
        parts, acc = [], 0
        for r in rings:
            parts.append(acc)
            acc += len(r)
        xmin, ymin, xmax, ymax = sr.shape.bounds()
        blob = struct.pack("<i4d", SHAPE_POLYGON, xmin, ymin, xmax, ymax)
        blob += struct.pack("<ii", len(rings), len(pts))
        blob += struct.pack(f"<{len(parts)}i", *parts)
        blob += np.ascontiguousarray(pts, "<f8").tobytes()
        rec_blobs.append(blob)

    polys = [sr.shape for sr in shp.shape_records if sr.shape is not None]
    if polys:
        bb = np.array([p.bounds() for p in polys])
        gxmin, gymin = bb[:, 0].min(), bb[:, 1].min()
        gxmax, gymax = bb[:, 2].max(), bb[:, 3].max()
    else:
        gxmin = gymin = gxmax = gymax = 0.0

    def _main_header(total_len_words: int) -> bytes:
        h = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0) + struct.pack(">i", total_len_words)
        h += struct.pack("<ii", 1000, SHAPE_POLYGON)
        h += struct.pack("<4d", gxmin, gymin, gxmax, gymax)
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    shp_len = 100 + sum(8 + len(b) for b in rec_blobs)
    with open(base + ".shp", "wb") as f:
        f.write(_main_header(shp_len // 2))
        for i, b in enumerate(rec_blobs):
            f.write(struct.pack(">ii", i + 1, len(b) // 2))
            f.write(b)

    shx_len = 100 + 8 * len(rec_blobs)
    with open(base + ".shx", "wb") as f:
        f.write(_main_header(shx_len // 2))
        off = 100
        for b in rec_blobs:
            f.write(struct.pack(">ii", off // 2, len(b) // 2))
            off += 8 + len(b)

    _write_dbf(base + ".dbf", shp.fields, [sr.record for sr in shp.shape_records])


def _format_numeric(v, length: int, decimals: int) -> str:
    """Render a numeric DBF value, shrinking decimals (never the integer
    part) to fit: silently chopping trailing digits would store a DIFFERENT
    number (123456789 in a 5-wide field read back as 12345)."""
    if v is None:
        return ""
    if decimals:
        s = f"{float(v):.{decimals}f}"
        dec = decimals
        while len(s) > length and dec > 0:
            dec -= 1
            s = f"{float(v):.{dec}f}".rstrip(".")
        return s
    return str(int(v))


def _write_dbf(path: str, fields: List[FieldSpec], records: List[Dict[str, object]]):
    # Auto-widen numeric fields whose integer part exceeds the declared
    # width: this writer also declares the widths, and a DBF write happens
    # at the very END of a full parcel-inference run — raising here on one
    # boundary value would discard hours of completed work. Widths are a
    # single byte in the DBF header, so 255 is the hard cap (beyond it the
    # value genuinely cannot be represented and we do raise).
    fields = list(fields)
    col_strings: Dict[str, List[str]] = {}
    for i, fs in enumerate(fields):
        if fs.ftype not in ("N", "F"):
            continue
        strs = [
            _format_numeric(r.get(fs.name), fs.length, fs.decimals)
            for r in records
        ]
        need = max((len(s) for s in strs), default=0)
        if need > fs.length:
            if need > 255:
                raise ValueError(
                    f"DBF field {fs.name} needs width {need} > 255 (value too wide)"
                )
            import logging

            logging.getLogger("stratanet2_tpu_torch").warning(
                "DBF field %s auto-widened %d -> %d to fit out-of-range value",
                fs.name, fs.length, need,
            )
            fields[i] = FieldSpec(fs.name, fs.ftype, need, fs.decimals)
            # re-format once against the final width (a wider field can
            # retain more decimals); unwidened columns reuse the first pass
            strs = [
                _format_numeric(r.get(fs.name), need, fs.decimals)
                for r in records
            ]
        col_strings[fs.name] = strs

    header_size = 32 + 32 * len(fields) + 1
    record_size = 1 + sum(f.length for f in fields)
    with open(path, "wb") as f:
        f.write(struct.pack("<4B", 0x03, 95, 7, 26))
        f.write(struct.pack("<iHH", len(records), header_size, record_size))
        f.write(b"\0" * 20)
        for fs in fields:
            f.write(fs.name.encode("ascii")[:11].ljust(11, b"\0"))
            f.write(fs.ftype.encode("ascii"))
            f.write(b"\0" * 4)
            f.write(struct.pack("<BB", fs.length, fs.decimals))
            f.write(b"\0" * 14)
        f.write(b"\x0d")
        for ri, rec in enumerate(records):
            f.write(b" ")
            for fs in fields:
                if fs.ftype in ("N", "F"):
                    s = col_strings[fs.name][ri]  # pre-formatted, fits
                    if len(s) > fs.length:  # unreachable after auto-widen
                        raise ValueError(
                            f"value {s!r} does not fit DBF field "
                            f"{fs.name} ({fs.ftype}, width {fs.length})"
                        )
                    f.write(s.rjust(fs.length).encode("ascii"))
                else:
                    v = rec.get(fs.name)
                    f.write(str(v if v is not None else "")[: fs.length].ljust(fs.length).encode("ascii", "replace"))
        f.write(b"\x1a")
