"""Self-contained GeoTIFF codec (read + write), no GDAL/rasterio.

The reference leans on rasterio/GDAL for every raster touch
(``server/app/wow_sr.py:59-75,138-151``, ``server/app/tiling.py``); this
image ships neither, so the framework carries its own small codec:

- Read: classic TIFF, little/big endian, strip or tile organisation,
  chunky or planar layout, compression none/LZW/Deflate/PackBits,
  horizontal predictor, uint8/16/32, int16/32, float32/64; GeoTIFF
  affine + EPSG extraction (ModelPixelScale/ModelTiepoint/ModelTransformation
  + GeoKeyDirectory).
- Write: uint8/uint16/float32, chunky strips, Deflate (zlib) or raw,
  horizontal predictor for integer data, GeoTIFF georeferencing and
  nodata. Output opens in GDAL/rasterio/QGIS.

Arrays are (H, W, C) uint-last layout (JAX/NHWC-friendly), with helpers
for band-first views.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from .affine import Affine
from .crs import CRS

# TIFF tag ids
T_IMAGE_WIDTH = 256
T_IMAGE_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PLANAR_CONFIG = 284
T_PREDICTOR = 317
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTE_COUNTS = 325
T_SAMPLE_FORMAT = 339
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_MODEL_TRANSFORMATION = 34264
T_GEO_KEY_DIRECTORY = 34735
T_GEO_DOUBLE_PARAMS = 34736
T_GEO_ASCII_PARAMS = 34737
T_GDAL_NODATA = 42113

# TIFF value types: (struct char, byte size)
_TYPES = {
    1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8),
}

_COMPRESSION_NONE = 1
_COMPRESSION_LZW = 5
_COMPRESSION_DEFLATE = 8
_COMPRESSION_DEFLATE_OLD = 32946
_COMPRESSION_PACKBITS = 32773

# GeoKey ids
_GK_MODEL_TYPE = 1024
_GK_RASTER_TYPE = 1025
_GK_GEOGRAPHIC_TYPE = 2048
_GK_PROJECTED_TYPE = 3072


@dataclass
class GeoTiff:
    """An in-memory georeferenced raster: (H, W, C) array + transform + CRS."""

    data: np.ndarray                      # (H, W, C)
    transform: Affine = field(default_factory=Affine.identity)
    crs: Optional[CRS] = None
    nodata: Optional[float] = None

    def __post_init__(self) -> None:
        if self.data.ndim == 2:
            self.data = self.data[:, :, None]
        assert self.data.ndim == 3, "GeoTiff.data must be (H, W, C)"

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def count(self) -> int:
        return self.data.shape[2]

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        return self.transform.bounds(self.width, self.height)

    def band(self, i: int) -> np.ndarray:
        """1-based band accessor (rasterio convention)."""
        return self.data[:, :, i - 1]

    def bands_first(self) -> np.ndarray:
        return np.moveaxis(self.data, -1, 0)


# ======================================================================
# Reading
# ======================================================================

def _read_ifd(f: BinaryIO, bo: str, offset: int) -> Dict[int, object]:
    f.seek(offset)
    (count,) = struct.unpack(bo + "H", f.read(2))
    raw_entries = [f.read(12) for _ in range(count)]
    tags: Dict[int, object] = {}
    for raw in raw_entries:
        tag, typ, n = struct.unpack(bo + "HHI", raw[:8])
        if typ not in _TYPES:
            continue
        fmt, size = _TYPES[typ]
        total = size * n
        if total <= 4:
            payload = raw[8:8 + total]
        else:
            (ptr,) = struct.unpack(bo + "I", raw[8:12])
            f.seek(ptr)
            payload = f.read(total)
        if typ == 2:  # ASCII
            tags[tag] = payload.rstrip(b"\0").decode("ascii", "replace")
        elif typ in (5, 10):  # rationals
            vals = struct.unpack(bo + fmt[0] * 2 * n, payload)
            tags[tag] = [vals[i] / (vals[i + 1] or 1) for i in range(0, 2 * n, 2)]
        else:
            tags[tag] = list(struct.unpack(bo + fmt * n, payload))
    return tags


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first bit order, early code-width change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset() -> None:
        table.clear()
        table.extend(bytes([i]) for i in range(256))
        table.extend((b"", b""))  # clear + EOI placeholders

    reset()
    width = 9
    buf = 0
    nbits = 0
    prev: Optional[bytes] = None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (buf >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == CLEAR:
                reset()
                width = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            # TIFF "early change": widen one code early
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decompress(chunk: bytes, compression: int) -> bytes:
    if compression == _COMPRESSION_NONE:
        return chunk
    if compression in (_COMPRESSION_DEFLATE, _COMPRESSION_DEFLATE_OLD):
        return zlib.decompress(chunk)
    if compression == _COMPRESSION_LZW:
        return _lzw_decode(chunk)
    if compression == _COMPRESSION_PACKBITS:
        return _packbits_decode(chunk)
    raise ValueError(f"unsupported TIFF compression {compression}")


def _dtype_from_tags(bits: int, sample_format: int, bo: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(sample_format, "u")
    return np.dtype(f"{'<' if bo == '<' else '>'}{kind}{bits // 8}")


def _undo_predictor(rows: np.ndarray) -> np.ndarray:
    # horizontal differencing along width, per-sample (rows: (h, w, spp))
    return np.cumsum(rows.astype(np.int64), axis=1).astype(rows.dtype)


def read_geotiff(path: Path | str) -> GeoTiff:
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise ValueError(f"{path} is not a TIFF file")
        magic, ifd_off = struct.unpack(bo + "HI", head[2:8])
        if magic == 43:
            raise ValueError("BigTIFF not supported")
        if magic != 42:
            raise ValueError(f"{path} is not a TIFF file")
        tags = _read_ifd(f, bo, ifd_off)

        width = int(tags[T_IMAGE_WIDTH][0])
        height = int(tags[T_IMAGE_LENGTH][0])
        spp = int(tags.get(T_SAMPLES_PER_PIXEL, [1])[0])
        bits_list = tags.get(T_BITS_PER_SAMPLE, [8])
        bits = int(bits_list[0])
        sample_format = int(tags.get(T_SAMPLE_FORMAT, [1])[0])
        compression = int(tags.get(T_COMPRESSION, [1])[0])
        planar = int(tags.get(T_PLANAR_CONFIG, [1])[0])
        predictor = int(tags.get(T_PREDICTOR, [1])[0])
        dtype = _dtype_from_tags(bits, sample_format, bo)

        tiled = T_TILE_OFFSETS in tags
        if tiled:
            tw = int(tags[T_TILE_WIDTH][0])
            th = int(tags[T_TILE_LENGTH][0])
            offsets = tags[T_TILE_OFFSETS]
            counts = tags[T_TILE_BYTE_COUNTS]
        else:
            tw, th = width, int(tags.get(T_ROWS_PER_STRIP, [height])[0])
            offsets = tags[T_STRIP_OFFSETS]
            counts = tags[T_STRIP_BYTE_COUNTS]

        chunk_spp = spp if planar == 1 else 1
        planes = 1 if planar == 1 else spp
        tiles_x = (width + tw - 1) // tw
        tiles_y = (height + th - 1) // th

        out = np.zeros((height, width, spp), dtype=dtype.newbyteorder("="))
        idx = 0
        for plane in range(planes):
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    raw = None
                    off, cnt = int(offsets[idx]), int(counts[idx])
                    idx += 1
                    f.seek(off)
                    raw = _decompress(f.read(cnt), compression)
                    rows = min(th, height - ty * th) if not tiled else th
                    cols = tw if tiled else width
                    arr = np.frombuffer(raw, dtype=dtype,
                                        count=rows * cols * chunk_spp)
                    arr = arr.reshape(rows, cols, chunk_spp)
                    if predictor == 2:
                        arr = _undo_predictor(arr)
                    elif predictor != 1:
                        raise ValueError(
                            f"unsupported TIFF predictor {predictor} "
                            "(only 1=none, 2=horizontal differencing)")
                    y0, x0 = ty * th, tx * tw
                    vy = min(rows, height - y0)
                    vx = min(cols, width - x0)
                    if planar == 1:
                        out[y0:y0 + vy, x0:x0 + vx, :] = arr[:vy, :vx, :]
                    else:
                        out[y0:y0 + vy, x0:x0 + vx, plane] = arr[:vy, :vx, 0]

        transform = _parse_geotransform(tags)
        crs = _parse_crs(tags)
        nodata = None
        if T_GDAL_NODATA in tags:
            try:
                nodata = float(str(tags[T_GDAL_NODATA]).strip())
            except ValueError:
                nodata = None
        return GeoTiff(out, transform=transform, crs=crs, nodata=nodata)


def _parse_geotransform(tags: Dict[int, object]) -> Affine:
    if T_MODEL_TRANSFORMATION in tags:
        m = tags[T_MODEL_TRANSFORMATION]
        return Affine(m[0], m[1], m[3], m[4], m[5], m[7])
    if T_MODEL_PIXEL_SCALE in tags and T_MODEL_TIEPOINT in tags:
        sx, sy = tags[T_MODEL_PIXEL_SCALE][:2]
        i, j, _k, x, y, _z = tags[T_MODEL_TIEPOINT][:6]
        west = x - i * sx
        north = y + j * sy
        return Affine.from_origin(west, north, sx, sy)
    return Affine.identity()


def _parse_crs(tags: Dict[int, object]) -> Optional[CRS]:
    gkd = tags.get(T_GEO_KEY_DIRECTORY)
    if not gkd:
        return None
    keys = {}
    for i in range(4, len(gkd), 4):
        key_id, loc, _cnt, value = gkd[i:i + 4]
        if loc == 0:
            keys[key_id] = value
    if keys.get(_GK_PROJECTED_TYPE) not in (None, 32767, 0):
        return CRS(int(keys[_GK_PROJECTED_TYPE]))
    if keys.get(_GK_GEOGRAPHIC_TYPE) not in (None, 32767, 0):
        return CRS(int(keys[_GK_GEOGRAPHIC_TYPE]))
    return None


# ======================================================================
# Writing
# ======================================================================

def _apply_predictor(arr: np.ndarray) -> np.ndarray:
    out = arr.copy()
    out[:, 1:, :] = (arr[:, 1:, :].astype(np.int64)
                     - arr[:, :-1, :].astype(np.int64)).astype(arr.dtype)
    return out


def write_geotiff(
    raster: GeoTiff,
    path: Path | str,
    compress: str = "deflate",
    predictor: bool = True,
    rows_per_strip: Optional[int] = None,
) -> Path:
    """Write *raster* as a chunky-strip GeoTIFF (deflate by default —
    the writable analogue of the reference's ``compress="lzw"`` GTiff
    outputs, ``server/app/wow_sr.py:148``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = np.ascontiguousarray(raster.data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in (np.uint8, np.uint16, np.int16, np.uint32,
                          np.int32, np.float32, np.float64):
        raise ValueError(f"unsupported write dtype {data.dtype}")
    h, w, spp = data.shape
    itemsize = data.dtype.itemsize
    sample_format = {"u": 1, "i": 2, "f": 3}[data.dtype.kind]
    use_predictor = predictor and data.dtype.kind in ("u", "i")

    if rows_per_strip is None:
        rows_per_strip = max(1, min(h, (1 << 20) // max(1, w * spp * itemsize)))
    n_strips = (h + rows_per_strip - 1) // rows_per_strip

    comp_id = {"deflate": _COMPRESSION_DEFLATE, "none": _COMPRESSION_NONE}[compress]
    strips: List[bytes] = []
    for s in range(n_strips):
        rows = data[s * rows_per_strip:(s + 1) * rows_per_strip]
        if use_predictor:
            rows = _apply_predictor(rows)
        payload = rows.astype(rows.dtype.newbyteorder("<")).tobytes()
        if comp_id == _COMPRESSION_DEFLATE:
            payload = zlib.compress(payload, 6)
        strips.append(payload)

    # --- assemble tags ------------------------------------------------
    entries: List[Tuple[int, int, int, bytes | int]] = []
    extra = bytearray()
    header_size = 8

    def add(tag: int, typ: int, values) -> None:
        fmt, size = _TYPES[typ]
        if typ == 2:
            payload = values.encode("ascii") + b"\0"
            n = len(payload)
        else:
            if not isinstance(values, (list, tuple)):
                values = [values]
            n = len(values)
            payload = struct.pack("<" + fmt * n, *values)
        entries.append((tag, typ, n, payload))

    add(T_IMAGE_WIDTH, 4, w)
    add(T_IMAGE_LENGTH, 4, h)
    add(T_BITS_PER_SAMPLE, 3, [itemsize * 8] * spp)
    add(T_COMPRESSION, 3, comp_id)
    add(T_PHOTOMETRIC, 3, 2 if spp >= 3 else 1)
    add(T_SAMPLES_PER_PIXEL, 3, spp)
    add(T_ROWS_PER_STRIP, 4, rows_per_strip)
    add(T_PLANAR_CONFIG, 3, 1)
    if use_predictor:
        add(T_PREDICTOR, 3, 2)
    add(T_SAMPLE_FORMAT, 3, [sample_format] * spp)

    tr = raster.transform
    if tr != Affine.identity():
        # ModelPixelScale + tiepoint encodes ONLY the north-up, east-
        # right convention (a>0, e<0); anything else (incl. south-up
        # e>0) must use the full ModelTransformation or the sign flips
        # silently on read-back
        if tr.b == 0.0 and tr.d == 0.0 and tr.a > 0.0 and tr.e < 0.0:
            add(T_MODEL_PIXEL_SCALE, 12, [tr.a, -tr.e, 0.0])
            add(T_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, tr.c, tr.f, 0.0])
        else:
            add(T_MODEL_TRANSFORMATION, 12, [
                tr.a, tr.b, 0.0, tr.c,
                tr.d, tr.e, 0.0, tr.f,
                0.0, 0.0, 0.0, 0.0,
                0.0, 0.0, 0.0, 1.0,
            ])
    if raster.crs is not None:
        epsg = raster.crs.epsg
        geographic = raster.crs.is_geographic
        gk = [1, 1, 0, 3,
              _GK_MODEL_TYPE, 0, 1, 2 if geographic else 1,
              _GK_RASTER_TYPE, 0, 1, 1]
        if geographic:
            gk += [_GK_GEOGRAPHIC_TYPE, 0, 1, epsg]
        else:
            gk += [_GK_PROJECTED_TYPE, 0, 1, epsg]
        add(T_GEO_KEY_DIRECTORY, 3, gk)
        add(T_GEO_ASCII_PARAMS, 2, f"EPSG:{epsg}|")
    if raster.nodata is not None:
        add(T_GDAL_NODATA, 2, repr(raster.nodata))

    # strip offsets filled after layout
    add(T_STRIP_BYTE_COUNTS, 4, [len(s) for s in strips])
    add(T_STRIP_OFFSETS, 4, [0] * n_strips)
    entries.sort(key=lambda e: e[0])

    ifd_offset = header_size
    ifd_size = 2 + 12 * len(entries) + 4
    extra_offset = ifd_offset + ifd_size
    # place out-of-line payloads
    placed: Dict[int, int] = {}
    for tag, typ, n, payload in entries:
        size = len(payload)
        if size > 4:
            if len(extra) % 2:
                extra += b"\0"
            placed[tag] = extra_offset + len(extra)
            extra += payload
    data_offset = extra_offset + len(extra)
    if data_offset % 2:
        data_offset += 1

    # now fix strip offsets and re-place the payload
    offsets = []
    pos = data_offset
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    for i, (tag, typ, n, payload) in enumerate(entries):
        if tag == T_STRIP_OFFSETS:
            payload = struct.pack("<" + "I" * n_strips, *offsets)
            entries[i] = (tag, typ, n, payload)
            if len(payload) > 4:
                start = placed[tag] - extra_offset
                extra[start:start + len(payload)] = payload

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
        f.write(struct.pack("<H", len(entries)))
        for tag, typ, n, payload in entries:
            if len(payload) <= 4:
                f.write(struct.pack("<HHI", tag, typ, n)
                        + payload.ljust(4, b"\0"))
            else:
                f.write(struct.pack("<HHII", tag, typ, n, placed[tag]))
        f.write(struct.pack("<I", 0))  # no next IFD
        f.write(bytes(extra))
        f.seek(data_offset)
        for s in strips:
            f.write(s)
    return path
