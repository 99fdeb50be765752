"""TIFF uploads decoded by content, to the RGB bytes PIL gives.

A TIFF upload whose name has no ``.tif``/``.tiff`` suffix is opened by
the JAX package with ``PIL.Image.open(path).convert("RGB")``, not by its
GeoTIFF reader, so it gets PIL's mode conversion, not ``load_rgb``'s
min-max scaling. The strips and tiles are read with the port's reader
(``geo/geotiff.py``: none, LZW, Deflate or PackBits, and libtiff's
LZMA through the standard library and ZSTD through ``tiles/zstd.py``;
horizontal predictor; chunky or planar; strips or tiles); CCITT fax
strips (compressions 2, 3, 4; FillOrder 2 too) through
``tiles/ccitt.py``; JPEG-compressed ones (compression 7) through
``tiles/jpeg.py`` with the file's ``JPEGTables``, in libtiff's colour
handling (YCbCr converted to RGB, anything else taken as stored). Then
PIL's conversion of the mode PIL gives the layout, as asked of Pillow
12.1:

- ``1`` (1-bit, photometric 0 or 1; fax too): 0 or 255;
- ``L`` (8-bit gray, alone or with an extra sample, which is dropped;
  photometric 0 inverted): the value;
- ``I;16`` (16-bit unsigned gray) and ``I`` (32-bit signed gray): the
  value clipped to 0..255;
- ``F`` (32-bit float gray): ≤ 0 → 0, ≥ 255 → 255, else truncated;
  NaN → 0;
- ``P`` (1-, 2-, 4-, 8-bit palette, photometric 3): the colour map's
  16-bit entries divided by 256;
- ``RGB`` (8-bit, and 8-bit with an extra sample, alpha or not: the
  extra sample is dropped; 16-bit samples keep their high byte);
- ``CMYK`` (8-bit, photometric 5): PIL's ``cmyk2rgb``;
- ``LAB`` (8-bit CIELab, photometric 8): LittleCMS's Lab → sRGB
  transform (``tiles/lab.py``).

Other layouts (YCbCr without JPEG, ICC and ITU Lab, other widths)
raise ``ValueError`` naming them, as PIL refuses them.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..geo.geotiff import _decompress, _read_ifd
from .jpeg import cmyk_to_rgb, decode_jpeg
from . import zstd
from .ccitt import decode_fax
from .lab import lab_to_rgb
from .png import check_image_size

_JPEG = 7
_LZMA = 34925
_ZSTD = 50000
_JPEG_TABLES = 347
_COLORMAP = 320
_EXTRA_SAMPLES = 338
_FILL_ORDER = 266
_T4_OPTIONS = 292
_FAX = (2, 3, 4)


def _chunks(f, tags: dict, height: int, width: int) -> list:
    """(y0, x0, rows, cols, plane, bytes) of every strip or tile."""
    planar = int(tags.get(284, [1])[0])
    spp = int(tags.get(277, [1])[0])
    if 324 in tags:
        tw, th = int(tags[322][0]), int(tags[323][0])
        offsets, counts = tags[324], tags[325]
    else:
        tw, th = width, int(tags.get(278, [height])[0])
        th = min(th, height) or height
        offsets, counts = tags[273], tags[279]
    planes = spp if planar == 2 else 1
    per_plane = -(-height // th) * -(-width // tw)
    if len(offsets) < planes * per_plane:
        raise ValueError("TIFF strip table is short")
    out = []
    k = 0
    for plane in range(planes):
        for y0 in range(0, height, th):
            for x0 in range(0, width, tw):
                f.seek(int(offsets[k]))
                raw = f.read(int(counts[k]))
                k += 1
                rows = th if 324 in tags else min(th, height - y0)
                out.append((y0, x0, rows, tw, plane, raw))
    return out


def _inflate(raw: bytes, compression: int) -> bytes:
    """A strip or tile decompressed: the GeoTIFF reader's codecs,
    libtiff's LZMA (an xz stream) through the standard library, and
    libtiff's ZSTD (one Zstandard frame) through ``tiles/zstd.py``."""
    if compression == _ZSTD:
        return zstd.decompress(raw)
    if compression == _LZMA:
        import lzma

        try:
            return lzma.decompress(raw)
        except lzma.LZMAError as exc:
            raise ValueError(f"TIFF LZMA strip is corrupt: {exc}") from None
    return _decompress(raw, compression)


def _jpeg_chunk(raw: bytes, tables: bytes, photometric: int) -> np.ndarray:
    """One JPEG-compressed strip or tile as libtiff decodes it."""
    stream = raw
    if tables and tables[-2:] == b"\xff\xd9" and raw[:2] == b"\xff\xd8":
        stream = tables[:-2] + raw[2:]
    return decode_jpeg(stream, colour="ycc" if photometric == 6 else "none")


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int,
             dtype: np.dtype) -> np.ndarray:
    """Decompressed chunk bytes → (rows, cols, spp) samples."""
    if bits < 8:
        stride = -(-cols * spp * bits // 8)
        need = stride * rows
        if len(raw) < need:
            raise ValueError("image file is truncated")
        b = np.frombuffer(raw[:need], np.uint8).reshape(rows, stride)
        vals = np.unpackbits(b, axis=1).reshape(rows, stride * 8 // bits, bits)
        vals = (vals * (1 << np.arange(bits - 1, -1, -1))).sum(-1)
        return vals[:, :cols * spp].reshape(rows, cols, spp).astype(np.uint8)
    need = rows * cols * spp * dtype.itemsize
    if len(raw) < need:
        raise ValueError("image file is truncated")
    return np.frombuffer(raw[:need], dtype).reshape(rows, cols, spp)


def decode_tiff(data: bytes) -> np.ndarray:
    """Decode the first page of a TIFF → (H, W, 3) uint8: the bytes of
    PIL's ``Image.open(...).convert("RGB")`` for the layouts above."""
    bo = {b"II": "<", b"MM": ">"}.get(data[:2])
    if bo is None or len(data) < 8:
        raise ValueError("not a TIFF file")
    magic, ifd = struct.unpack(bo + "HI", data[2:8])
    if magic != 42:
        raise ValueError("BigTIFF and other TIFF variants are not decoded")
    f = io.BytesIO(data)
    try:
        tags = _read_ifd(f, bo, ifd)
        width, height = int(tags[256][0]), int(tags[257][0])
    except (KeyError, IndexError, struct.error):
        raise ValueError("TIFF directory is truncated or incomplete") from None
    check_image_size(width, height)
    spp = int(tags.get(277, [1])[0])
    bits_all = [int(b) for b in tags.get(258, [1])]
    bits = bits_all[0]
    fmt = int(tags.get(339, [1])[0])
    compression = int(tags.get(259, [1])[0])
    photometric = int(tags.get(262, [1 if spp < 3 else 2])[0])
    predictor = int(tags.get(317, [1])[0])
    extra = [int(v) for v in tags.get(_EXTRA_SAMPLES, [])]
    fill_order = int(tags.get(_FILL_ORDER, [1])[0])
    if fill_order != 1 and compression not in _FAX:
        raise ValueError("TIFF fill order 2 is not decoded")
    if len(set(bits_all)) != 1:
        raise ValueError(f"TIFF with mixed sample widths {bits_all}")
    gray = photometric in (0, 1) and spp - len(extra) == 1
    if compression in _FAX:
        if not (gray and spp == 1 and bits == 1):
            raise ValueError("CCITT fax TIFF of this layout is not decoded")
        layout = "1"
    elif compression == _JPEG:
        layout = "jpeg"
        if photometric not in (1, 2, 6) or bits != 8 or spp not in (1, 3):
            raise ValueError("JPEG-compressed TIFF of this layout is not "
                             "decoded")
    elif gray and spp == 1 and fmt == 1 and bits in (1, 8, 16):
        layout = {1: "1", 8: "L", 16: "I;16"}[bits]
    elif gray and spp == 2 and fmt == 1 and bits == 8:
        layout = "L"                               # LA: alpha dropped
    elif gray and spp == 1 and fmt == 2 and bits == 32:
        layout = "I"
    elif photometric == 5 and spp == 4 and fmt == 1 and bits == 8:
        layout = "CMYK"
    elif gray and spp == 1 and fmt == 3 and bits == 32:
        layout = "F"
    elif photometric == 3 and spp == 1 and bits in (1, 2, 4, 8) and fmt == 1:
        layout = "P"
    elif photometric == 8 and spp == 3 and fmt == 1 and bits == 8:
        layout = "LAB"
    elif photometric == 2 and fmt == 1 and bits in (8, 16) and (
            spp == 3 or (spp == 4 and len(extra) == 1)):
        layout = "RGB"
    else:
        raise ValueError(f"TIFF layout photometric {photometric}, "
                         f"{spp} samples of {bits} bits (format {fmt}) is "
                         "not decoded")
    if layout == "P" and photometric == 3 and _COLORMAP not in tags:
        raise ValueError("TIFF palette image without a colour map")
    dtype = np.dtype({8: "u1", 16: "u2", 32: {2: "i4", 3: "f4"}.get(fmt, "u4")}
                     .get(bits, "u1")).newbyteorder(bo)
    planar = int(tags.get(284, [1])[0])
    cspp = 1 if planar == 2 else spp
    out = np.zeros((height, width, spp if layout != "jpeg" else 3),
                   dtype.newbyteorder("=") if bits >= 8 else np.uint8)
    tables = bytes(tags.get(_JPEG_TABLES, []))
    t4_options = int(tags.get(_T4_OPTIONS, [0])[0])
    for y0, x0, rows, cols, plane, raw in _chunks(f, tags, height, width):
        if compression in _FAX:
            arr = decode_fax(raw, compression, cols, rows, t4_options,
                             fill_order)[:, :, None]
        elif layout == "jpeg":
            arr = _jpeg_chunk(raw, tables, photometric)
            if arr.shape[2] == 1:
                arr = np.repeat(arr, 3, axis=2)
        else:
            arr = _samples(_inflate(raw, compression), rows, cols, cspp,
                           bits, dtype)
            if predictor == 2:
                arr = np.cumsum(arr.astype(np.int64), axis=1).astype(arr.dtype)
            elif predictor != 1:
                raise ValueError(f"TIFF predictor {predictor} is not decoded")
        vy, vx = min(arr.shape[0], height - y0), min(arr.shape[1], width - x0)
        if planar == 2 and layout != "jpeg":
            out[y0:y0 + vy, x0:x0 + vx, plane] = arr[:vy, :vx, 0]
        else:
            out[y0:y0 + vy, x0:x0 + vx] = arr[:vy, :vx]
    return _to_rgb(out, layout, photometric, bits, tags)


def _to_rgb(px: np.ndarray, layout: str, photometric: int, bits: int,
            tags: dict) -> np.ndarray:
    if layout == "CMYK":
        return cmyk_to_rgb(px)
    if layout == "LAB":
        return lab_to_rgb(px)
    if layout in ("jpeg", "RGB"):
        rgb = px[:, :, :3]
        if bits == 16:
            rgb = rgb >> 8
        return np.ascontiguousarray(rgb.astype(np.uint8))
    v = px[:, :, 0]
    if layout == "P":
        cmap = np.asarray(tags[_COLORMAP], np.int64) // 256
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(n, 256)] = cmap.reshape(3, n).T[:256]
        return pal[v.astype(np.int64)]
    if layout == "1":
        g = np.where(v > 0, 255, 0)
        if photometric == 0:
            g = 255 - g
    elif layout == "L":
        g = 255 - v if photometric == 0 else v
    elif layout in ("I;16", "I"):
        g = np.clip(v, 0, 255)
    else:                                          # F
        with np.errstate(invalid="ignore"):
            g = np.where(v >= 255, 255, np.where(v > 0, v, 0))
            g = np.nan_to_num(g, nan=0.0).astype(np.int64)
    g = g.astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)
