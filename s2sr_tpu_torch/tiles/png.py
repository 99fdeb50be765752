"""PNG codec: the native encoder when it builds, else numpy filtering +
stdlib zlib.

The port's copy of the JAX package's encoder and pure decoder:
:func:`encode_png` takes the native (C++, libpng) encoder of
``s2sr_tpu_torch/native`` when it loads and falls back to the
pure-Python one otherwise, as the JAX package does, so neither PIL nor
a native library is needed. ``native.png_encoder()`` says which runs.
"""

from __future__ import annotations

import struct
import zlib

from typing import Optional

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# PIL refuses an image above twice its MAX_IMAGE_PIXELS (89,478,485) as a
# decompression bomb; the decoders here refuse the same sizes
MAX_PIXELS = 2 * 89_478_485


def check_image_size(width: int, height: int) -> None:
    """Raise ``ValueError`` for an image PIL would refuse as a
    decompression bomb, before anything of its size is allocated."""
    pixels = max(1, width) * max(1, height)
    if pixels > MAX_PIXELS:
        raise ValueError(f"Image size ({pixels} pixels) exceeds limit of "
                         f"{MAX_PIXELS} pixels, could be decompression bomb "
                         "DOS attack.")


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 3, filter_sub: bool = True) -> bytes:
    """Encode (H, W), (H, W, 3) or (H, W, 4) uint8 → PNG bytes.

    Uses the native encoder (``s2sr_tpu_torch/native``; the Sub filter
    on every row) when it loads, else the pure-Python path, as the JAX
    package's ``encode_png`` does."""
    native = _native_encode(img, level)
    if native is not None:
        return native
    return _encode_png_py(img, level, filter_sub)


def _native_encode(img: np.ndarray, level: int) -> Optional[bytes]:
    """The native encoder's bytes, or None where it is not built or
    fails (an output over ``h·w·c + 4096`` bytes: the caller then takes
    the pure path)."""
    import ctypes

    from ..native import load

    lib = load()
    if lib is None:
        return None
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in (1, 2, 3, 4) or img.dtype != np.uint8:
        return None
    img = np.ascontiguousarray(img)
    cap = h * w * c + (1 << 12)
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(0)
    rc = lib.s2sr_png_encode(
        img.ctypes.data_as(ctypes.c_char_p), h, w, c, level,
        out, cap, ctypes.byref(out_len))
    if rc != 0:
        return None
    return ctypes.string_at(out, out_len.value)


def _encode_png_py(img: np.ndarray, level: int = 3,
                   filter_sub: bool = True) -> bytes:
    """Pure-Python encoder (always available)."""
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


# channels per colour type, and the bit depths the standard allows each
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the five PNG filters: ``raw`` (rows, 1 + stride) uint8, each
    row led by its filter type, → (rows, stride) uint8.

    A byte depends on the byte ``bpp`` to its left and the two above it,
    so every pixel of one anti-diagonal (row y, pixel t − y) depends only
    on the two diagonals before it: where any row uses Average or Paeth,
    the loop runs over the rows + pixels − 1 diagonals, each at once over
    its pixels and their ``bpp`` bytes, whatever filter each row uses."""
    rows, stride = raw.shape[0], raw.shape[1] - 1
    ftypes = raw[:, 0].astype(np.int64)
    if ftypes.size and ftypes.max() > 4:
        raise ValueError(f"bad PNG filter type {int(ftypes.max())}")
    px = stride // bpp
    data = raw[:, 1:].reshape(rows, px, bpp).astype(np.int32)
    if not np.isin(ftypes, (3, 4)).any():
        # None, Sub and Up only (this module's encoder writes Sub): each
        # row at once, in one step a row
        out = np.zeros((rows + 1, px, bpp), np.int32)
        for y in range(rows):
            ft = ftypes[y]
            if ft == 1:
                out[y + 1] = np.cumsum(data[y], axis=0) & 255
            else:
                out[y + 1] = (data[y] + (out[y] if ft == 2 else 0)) & 255
        return out[1:].reshape(rows, stride).astype(np.uint8)
    # out[y, x] at pad[y + 1, x + 1]; row 0 and column 0 of pad are the
    # zeros the filters see above the first row and left of the first pixel
    pad = np.zeros((rows + 1, px + 1, bpp), np.int32)
    for t in range(rows + px - 1):
        y = np.arange(max(0, t - px + 1), min(rows, t + 1))
        x = t - y
        a, b, c = pad[y + 1, x], pad[y, x + 1], pad[y, x]
        f = ftypes[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        pad[y + 1, x + 1] = (data[y, x] + pred) & 255
    return pad[1:, 1:].reshape(rows, stride).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) → samples (h, width, channels), as
    uint8 for depths ≤ 8 and uint16 for 16 (big-endian in the file)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, width, channels).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits.reshape(h, width, depth) * weights).sum(-1)
    return vals.astype(np.uint8).reshape(h, width, 1)


def decode_png(data: bytes) -> np.ndarray:
    """Decode a PNG → (H, W, C) uint8 with the file's own channels (gray,
    gray + alpha, RGB, RGBA; palette images as their RGB colours).

    Every colour type and bit depth the standard allows, non-interlaced or
    Adam7, all five filters. Samples become bytes as PIL's
    ``Image.convert("RGB")`` makes them: 1-, 2- and 4-bit gray scaled to
    0..255; 16-bit gray clipped to 255; 16-bit colour and alpha take their
    high byte. A ``tRNS`` transparency is read and not applied (the RGB
    conversion drops it); a palette index past the palette is black."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    header = None
    idat = bytearray()
    palette: Optional[np.ndarray] = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload[:len(payload) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color_type, _, _, interlace = header
    if depth not in _DEPTHS.get(color_type, ()) or interlace > 1:
        raise ValueError(f"bad PNG header: colour type {color_type}, "
                         f"depth {depth}, interlace {interlace}")
    check_image_size(width, height)
    channels = _CHANNELS[color_type]
    bits = channels * depth
    bpp = max(1, bits // 8)
    passes = []                       # (x0, y0, dx, dy, width, height, stride)
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            passes.append((x0, y0, dx, dy, pw, ph, -(-pw * bits // 8)))
    # inflate no more than the image needs, and check it is all there
    # before the samples are allocated
    need = sum(ph * (stride + 1) for *_, ph, stride in passes)
    try:
        raw = (zlib.decompressobj().decompress(bytes(idat), need) if need
               else b"")
    except zlib.error as e:
        raise ValueError(f"bad PNG image data: {e}") from None
    if len(raw) < need:
        raise ValueError("PNG image data is truncated")
    raw = np.frombuffer(raw, np.uint8)
    dtype = np.uint16 if depth == 16 else np.uint8
    samples = np.zeros((height, width, channels), dtype)
    off = 0
    for x0, y0, dx, dy, pw, ph, stride in passes:
        n = ph * (stride + 1)
        rows = _unfilter(raw[off:off + n].reshape(ph, stride + 1), bpp)
        samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        off += n

    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[samples[:, :, 0]]
    if depth == 16:
        if color_type == 0:
            return np.minimum(samples, 255).astype(np.uint8)
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples
