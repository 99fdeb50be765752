"""GIF decoder in numpy that gives PIL's RGB bytes exactly.

The JAX package opens uploads with ``PIL.Image.open(path).convert("RGB")``,
which for a GIF is its first frame as PIL's plugin (``GifImagePlugin.py``)
loads it, whatever the file's frame count:

- the canvas is the logical screen, grown to hold the first frame's
  rectangle; it starts as index 0, or as the frame's transparent index
  when its graphic control extension sets one;
- the frame's LZW data (variable code width from the minimum code size
  + 1 up to 12 bits, clear and end codes, no table growth past 4,096
  codes) fills its rectangle, rows in interlaced order when flagged;
  the transparent index is written as any other on the first frame;
- the local colour table, else the global one, maps indices to RGB,
  indices past the table black; a table that is the identity gray ramp
  (entry i = (i, i, i)) makes the frame ``L`` (the index is the gray
  value), as PIL drops it; no table at all is ``L`` too.
  ``convert("RGB")`` ignores transparency.

A file PIL cannot open (no image, data that ends early) raises
``ValueError``.
"""

from __future__ import annotations

import numpy as np

from .png import check_image_size


def _i16(b: bytes, o: int) -> int:
    return b[o] | (b[o + 1] << 8)


def _blocks(data: bytes, pos: int) -> tuple:
    """The data sub-blocks from ``pos`` joined, and the position after
    their terminator."""
    out = bytearray()
    n = len(data)
    while pos < n:
        size = data[pos]
        pos += 1
        if size == 0:
            return bytes(out), pos
        out += data[pos:pos + size]
        pos += size
    return bytes(out), pos


def _lzw(data: bytes, min_size: int, count: int) -> bytes:
    """The first ``count`` indices of a GIF LZW stream."""
    if not 0 <= min_size <= 11:
        raise ValueError("GIF LZW minimum code size is out of range")
    clear = 1 << min_size
    end = clear + 1
    out = bytearray()
    table = [bytes((i,)) for i in range(clear)] + [b"", b""]
    size = min_size + 1
    mask = (1 << size) - 1
    prev = None
    acc = nbits = 0
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= size:
            code = acc & mask
            acc >>= size
            nbits -= size
            if code == clear:
                del table[end + 1:]
                size = min_size + 1
                mask = (1 << size) - 1
                prev = None
                continue
            if code == end:
                return bytes(out[:count])
            if prev is None:
                if code >= len(table):
                    raise ValueError("GIF LZW code is out of range")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
            elif code == len(table) and len(table) < 4096:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("GIF LZW code is out of range")
            out += entry
            prev = entry
            if len(table) == mask + 1 and size < 12:
                size += 1
                mask = (1 << size) - 1
            if len(out) >= count:
                return bytes(out[:count])
    return bytes(out)


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def _table(data: bytes, pos: int, flags: int):
    """A colour table of 2^((flags & 7) + 1) entries at ``pos`` → (None if
    it is the identity gray ramp, else (256, 3) uint8 padded black), and
    the position after it."""
    n = 2 << (flags & 7)
    raw = data[pos:pos + 3 * n]
    pos += 3 * n
    entries = np.frombuffer(raw[:len(raw) // 3 * 3], np.uint8).reshape(-1, 3)
    ramp = np.arange(len(entries))
    if len(raw) == 3 * n and (entries == ramp[:, None]).all():
        return None, pos
    table = np.zeros((max(256, len(entries)), 3), np.uint8)
    table[:len(entries)] = entries
    return table, pos


def decode_gif(data: bytes) -> np.ndarray:
    """Decode a GIF's first frame → (H, W, 3) uint8: the bytes of PIL's
    ``Image.open(...).convert("RGB")``."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height = _i16(data, 6), _i16(data, 8)
    flags = data[10]
    pos = 13
    palette = None
    if flags & 128:
        palette, pos = _table(data, pos, flags)
    transparency = None
    n = len(data)
    while True:
        if pos >= n or data[pos] == 0x3B:
            raise ValueError("image not found in GIF frame")
        tag = data[pos]
        pos += 1
        if tag == 0x21:                                    # extension
            label = data[pos] if pos < n else 0
            pos += 1
            size = data[pos] if pos < n else 0
            if label == 0xF9 and size >= 4 and data[pos + 1] & 1:
                transparency = data[pos + 4]
            _, pos = _blocks(data, pos)
        elif tag == 0x2C:                                  # image
            x0, y0, fw, fh = (_i16(data, pos + k) for k in (0, 2, 4, 6))
            iflags = data[pos + 8]
            pos += 9
            break
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    check_image_size(width, height)
    if iflags & 128:
        palette, pos = _table(data, pos, iflags)
    if pos >= n:
        raise ValueError("image file is truncated")
    min_size = data[pos]
    lzw, _ = _blocks(data, pos + 1)
    idx = _lzw(lzw, min_size, fw * fh)
    if len(idx) < fw * fh:
        raise ValueError("image file is truncated")
    frame = np.frombuffer(idx, np.uint8).reshape(fh, fw)
    canvas = np.full((height, width), transparency or 0, np.uint8)
    if iflags & 64:
        rows = np.empty_like(frame)
        rows[_interlaced_rows(fh)] = frame
        frame = rows
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return np.repeat(canvas[:, :, None], 3, axis=2)
    return palette[canvas]
