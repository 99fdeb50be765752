"""BMP decoder in numpy that gives PIL's RGB bytes exactly.

The JAX package opens uploads with ``PIL.Image.open(path).convert("RGB")``;
PIL's BMP reader is its own Python plugin (``BmpImagePlugin.py``) over
its raw unpackers, and its behaviour is the specification here:

- headers: OS/2 1.x (12 bytes: 16-bit sizes, 3-byte palette entries,
  bottom-up) and BITMAPINFOHEADER with its V2–V5 and OS/2 2.x
  extensions (40, 52, 56, 64, 108, 124 bytes; a negative height is
  top-down);
- 1-, 4- and 8-bit palettes (a palette of grays in index order is read
  as gray values, as PIL drops it; indices past the palette are black),
  16-bit 5-5-5, 24- and 32-bit BGR;
- ``BI_BITFIELDS`` with the masks PIL accepts (16-bit 5-6-5 and 5-5-5,
  24-bit BGR, the eight 32-bit layouts); 5- and 6-bit channels widened
  as ``v * 255 // 31`` (``// 63``);
- ``BI_RLE8`` and ``BI_RLE4`` as PIL's ``BmpRleDecoder`` runs them: an
  end of line pads the row with index 0, a delta reads two bytes past
  its two (PIL's reading), an absolute RLE4 run of n pixels reads n // 2
  bytes, a run is padded to the next even file offset, and fewer pixels
  than the image holds refuse the file, as PIL does;
- a data offset that points just past the header, with a palette
  there, skips the palette (PIL's fix-up).

Whatever PIL refuses (other depths, compressions, bitfield layouts,
headers; truncated pixel data) raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .png import check_image_size

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3

# (bits, masks) → the byte order of one pixel, as PIL names the raw mode
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BIT_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """PIL's ``BmpRleDecoder.decode`` over the file from ``pos``: the
    palette indices in the order written (bottom row first)."""
    out = bytearray()
    x = 0
    dest = width * height
    n = len(data)
    while len(out) < dest:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 15))
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:                       # end of line
            out += bytes((-len(out)) % width)
            x = 0
        elif byte == 1:                       # end of bitmap
            break
        elif byte == 2:                       # delta, as PIL reads it
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("BMP RLE delta is truncated")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:                                 # absolute run
            want = byte // 2 if rle4 else byte
            chunk = data[pos:pos + want]
            pos += len(chunk)
            if rle4:
                for v in chunk:
                    out += bytes((v >> 4, v & 15))
            else:
                out += chunk
            if len(chunk) < want:
                break
            x += byte
            pos += pos % 2                    # to an even file offset
    if len(out) < dest:
        raise ValueError("not enough image data")
    return np.frombuffer(bytes(out[:dest]), np.uint8).reshape(height, width)


def _unpack(rows: np.ndarray, mode: str, width: int) -> np.ndarray:
    """(h, stride) row bytes in raw ``mode`` → (h, w) indices or
    (h, w, 3) RGB."""
    if mode == "P;1":
        return np.unpackbits(rows, axis=1)[:, :width]
    if mode == "P;4":
        return np.stack([rows >> 4, rows & 15], -1).reshape(len(rows), -1)[:, :width]
    if mode == "P":
        return rows[:, :width]
    if mode in ("BGR;15", "BGR;16"):
        px = rows[:, :2 * width].reshape(len(rows), width, 2).astype(np.int32)
        v = px[..., 0] | (px[..., 1] << 8)
        if mode == "BGR;15":
            r, g = (v >> 10) & 31, ((v >> 5) & 31) * 255 // 31
        else:
            r, g = (v >> 11) & 31, ((v >> 5) & 63) * 255 // 63
        b = v & 31
        return np.stack([r * 255 // 31, g, b * 255 // 31], -1).astype(np.uint8)
    step = len(mode)
    px = rows[:, :step * width].reshape(len(rows), width, step)
    return px[..., [mode.index(c) for c in "RGB"]]


def decode_bmp(data: bytes) -> np.ndarray:
    """Decode a BMP → (H, W, 3) uint8: the bytes of PIL's
    ``Image.open(...).convert("RGB")``."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError("not a BMP file")
    offset = _i32(data, 10)
    size = _i32(data, 14)
    head = data[18:14 + size]
    if len(head) < size - 4:
        raise ValueError("BMP header is truncated")
    pos = 14 + size                          # the file position after it
    masks = None
    direction = -1
    if size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", head)
        compression, colors, pal_pad = _RAW, 0, 3
    elif size in (40, 52, 56, 64, 108, 124):
        width = _i32(head, 0)
        if head[7] == 0xFF:
            direction, height = 1, 2 ** 32 - _i32(head, 4)
        else:
            height = _i32(head, 4)
        bits, compression = _i16(head, 10), _i32(head, 12)
        colors, pal_pad = _i32(head, 28), 4
        if compression == _BITFIELDS:
            if len(head) >= 48:
                n = 4 if len(head) >= 52 else 3
                masks = struct.unpack_from(f"<{n}I", head, 36)
            else:
                masks = struct.unpack_from("<3I", data, pos)
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise ValueError(f"Unsupported BMP header type ({size})")
    check_image_size(width, height)
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT_MODES:
        raise ValueError(f"Unsupported BMP pixel depth ({bits})")
    raw = _BIT_MODES[bits]
    paletted = bits <= 8
    if compression == _BITFIELDS:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise ValueError("Unsupported BMP bitfields layout")
        raw = _MASK_MODES[key]
    elif compression not in (_RAW, _RLE8, _RLE4):
        raise ValueError(f"Unsupported BMP compression ({compression})")

    palette = None
    if paletted:
        if not 0 < colors <= 65536:
            raise ValueError(f"Unsupported BMP Palette size ({colors})")
        pal = data[pos:pos + pal_pad * colors]
        entries = np.frombuffer(pal[:len(pal) // pal_pad * pal_pad],
                                np.uint8).reshape(-1, pal_pad)[:, 2::-1]
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = len(entries) >= len(ramp) and all(
            (entries[i] == v).all() for i, v in enumerate(ramp))
        if gray and bits == 4:
            # PIL reads a 4-bit gray palette's indices as 8-bit L, which
            # its raw decoder refuses
            raise ValueError("codec configuration error when reading "
                             "image file")
        if not gray:
            palette = np.zeros((256, 3), np.uint8)   # past it: black
            palette[:min(len(entries), 256)] = entries[:256]

    if compression in (_RLE8, _RLE4):
        img = _rle(data, offset, width, height, compression == _RLE4)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = stride * height
        px = data[offset:offset + need]
        if len(px) < need:
            raise ValueError("image file is truncated")
        rows = np.frombuffer(px, np.uint8).reshape(height, stride)
        img = _unpack(rows, raw, width)
    if direction == -1:
        img = img[::-1]
    if img.ndim == 3:
        return np.ascontiguousarray(img)
    if paletted and palette is None:
        if colors == 2:                       # PIL's mode "1"
            img = np.where(img > 0, 255, 0).astype(np.uint8)
        return np.repeat(img[:, :, None], 3, axis=2)
    return palette[img]
