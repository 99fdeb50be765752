"""Pure-Python PNG codec (numpy filtering + stdlib zlib).

The port's copy of the JAX package's pure encoder and decoder, so the
PNG twin of an SR output needs neither PIL nor a native library.
"""

from __future__ import annotations

import struct
import zlib

from typing import Optional

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 3, filter_sub: bool = True) -> bytes:
    """Encode (H, W), (H, W, 3) or (H, W, 4) uint8 → PNG bytes."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    img = np.ascontiguousarray(img)

    if filter_sub:
        # filter type 1 (Sub): left-difference, cheap and effective on imagery
        left = np.zeros_like(img)
        left[:, 1:, :] = img[:, :-1, :]
        filtered = (img.astype(np.int16) - left.astype(np.int16)) % 256
        rows = np.concatenate(
            [np.full((h, 1), 1, np.uint8),
             filtered.reshape(h, w * c).astype(np.uint8)], axis=1)
    else:
        rows = np.concatenate(
            [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    idat = zlib.compress(rows.tobytes(), level)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """Decode 8-bit non-interlaced PNG → (H, W, C) uint8."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    width = height = 0
    color_type = 0
    idat = bytearray()
    palette: Optional[np.ndarray] = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, color_type, comp, filt, interlace = \
                struct.unpack(">IIBBBBB", payload)
            if depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    stride = width * channels
    raw = raw.reshape(height, stride + 1)
    ftypes = raw[:, 0]
    rows = raw[:, 1:].astype(np.int32)

    out = np.zeros((height, stride), np.int32)
    bpp = channels
    for y in range(height):
        row = rows[y].copy()
        ft = ftypes[y]
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            out[y] = row
        elif ft == 1:  # Sub: a running sum per channel along the row
            out[y] = np.cumsum(row.reshape(width, bpp), axis=0).reshape(-1) % 256
        elif ft == 2:  # Up
            out[y] = (row + prev) % 256
        elif ft == 3:  # Average
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + (a + prev[x]) // 2) % 256
            out[y] = row
        elif ft == 4:  # Paeth
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                cc = prev[x - bpp] if x >= bpp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                row[x] = (row[x] + pred) % 256
            out[y] = row
        else:
            raise ValueError(f"bad filter {ft}")

    img = out.astype(np.uint8).reshape(height, width, channels)
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        img = palette[img[:, :, 0]]
    return img
