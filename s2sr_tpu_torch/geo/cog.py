"""Windowed (cloud-optimised) GeoTIFF reads — the ``/vsicurl``
equivalent (the port of ``s2sr_tpu/geo/cog.py``).

A buffered HTTP range-request file object over ``urllib`` (the card's
machine has no ``requests``) and a tile/strip-granular window reader on
top of the in-repo TIFF codec: only the header and the chunks
intersecting the requested window are fetched.
"""

from __future__ import annotations

import io
import struct
import urllib.request
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from .affine import Affine
from .geotiff import (
    GeoTiff,
    T_BITS_PER_SAMPLE,
    T_COMPRESSION,
    T_IMAGE_LENGTH,
    T_IMAGE_WIDTH,
    T_PLANAR_CONFIG,
    T_PREDICTOR,
    T_ROWS_PER_STRIP,
    T_SAMPLE_FORMAT,
    T_SAMPLES_PER_PIXEL,
    T_STRIP_BYTE_COUNTS,
    T_STRIP_OFFSETS,
    T_TILE_BYTE_COUNTS,
    T_TILE_LENGTH,
    T_TILE_OFFSETS,
    T_TILE_WIDTH,
    _decompress,
    _dtype_from_tags,
    _parse_crs,
    _parse_geotransform,
    _read_ifd,
    _undo_predictor,
)


class HttpRangeFile(io.RawIOBase):
    """Seekable read-only file over HTTP range requests, block-cached.

    Blocks of ``block_size`` bytes are fetched on demand and cached, so
    header walks (many tiny reads) cost one request and pixel reads
    fetch only the chunks they cover. ``requests_made`` counts the range
    requests, ``bytes_fetched`` the bytes they returned.
    """

    def __init__(self, url: str, block_size: int = 256 * 1024,
                 timeout: float = 60.0):
        super().__init__()
        self.url = url
        self.block_size = block_size
        self.timeout = timeout
        self._pos = 0
        self._size: Optional[int] = None
        self._blocks: Dict[int, bytes] = {}
        self.requests_made = 0
        self.bytes_fetched = 0

    def _fetch(self, start: int, end: int) -> bytes:
        """Bytes ``start:end`` of the file; raises ``HTTPError`` on a 4xx
        or 5xx reply (``urlopen`` raises where ``requests`` needs
        ``raise_for_status``)."""
        self.requests_made += 1
        req = urllib.request.Request(
            self.url, headers={"Range": f"bytes={start}-{end - 1}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            status = r.status
            content_range = r.headers.get("Content-Range", "")
            content = r.read()
        self.bytes_fetched += len(content)
        if self._size is None:
            if "/" in content_range:
                try:
                    self._size = int(content_range.rsplit("/", 1)[1])
                except ValueError:
                    pass
            elif status == 200:
                self._size = len(content)
        if status == 200:
            # server ignored the Range header (HTTP/1.0, some proxies)
            # and sent the whole file: slice the requested span instead
            # of caching the full body at a nonzero block index
            return content[start:end]
        return content

    def _block(self, index: int) -> bytes:
        if index not in self._blocks:
            start = index * self.block_size
            self._blocks[index] = self._fetch(start, start + self.block_size)
        return self._blocks[index]

    def size(self) -> int:
        if self._size is None:
            self._block(0)
        return self._size or 0

    # --- file protocol -------------------------------------------------
    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = self.size() + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.size() - self._pos
        out = bytearray()
        pos = self._pos
        while n > 0:
            block_index = pos // self.block_size
            block = self._block(block_index)
            inner = pos - block_index * self.block_size
            take = min(n, len(block) - inner)
            if take <= 0:
                break
            out += block[inner:inner + take]
            pos += take
            n -= take
        self._pos = pos
        return bytes(out)


class CogReader:
    """Lazy windowed reader over a local path, URL, or file object."""

    def __init__(self, source: Union[str, Path, io.IOBase]):
        if isinstance(source, (str, Path)) and str(source).startswith(
                ("http://", "https://")):
            self._f: io.IOBase = HttpRangeFile(str(source))
        elif isinstance(source, (str, Path)):
            self._f = open(source, "rb")
        else:
            self._f = source
        self._owns_f = isinstance(source, (str, Path))
        try:
            head = _read_exact(self._f, 0, 8)
            if head[:2] == b"II":
                self._bo = "<"
            elif head[:2] == b"MM":
                self._bo = ">"
            else:
                raise ValueError("not a TIFF")
            magic, ifd_off = struct.unpack(self._bo + "HI", head[2:8])
            if magic != 42:
                raise ValueError("only classic TIFF supported")
            self.tags = _read_ifd(self._f, self._bo, ifd_off)
        except Exception:
            if self._owns_f:
                self._f.close()   # don't leak the fd we opened
            raise

        t = self.tags
        self.width = int(t[T_IMAGE_WIDTH][0])
        self.height = int(t[T_IMAGE_LENGTH][0])
        self.count = int(t.get(T_SAMPLES_PER_PIXEL, [1])[0])
        bits = int(t.get(T_BITS_PER_SAMPLE, [8])[0])
        fmt = int(t.get(T_SAMPLE_FORMAT, [1])[0])
        self.dtype = _dtype_from_tags(bits, fmt, self._bo)
        self._compression = int(t.get(T_COMPRESSION, [1])[0])
        self._planar = int(t.get(T_PLANAR_CONFIG, [1])[0])
        self._predictor = int(t.get(T_PREDICTOR, [1])[0])
        self.tiled = T_TILE_OFFSETS in t
        if self.tiled:
            self.chunk_w = int(t[T_TILE_WIDTH][0])
            self.chunk_h = int(t[T_TILE_LENGTH][0])
            self._offsets = t[T_TILE_OFFSETS]
            self._counts = t[T_TILE_BYTE_COUNTS]
        else:
            self.chunk_w = self.width
            self.chunk_h = int(t.get(T_ROWS_PER_STRIP, [self.height])[0])
            self._offsets = t[T_STRIP_OFFSETS]
            self._counts = t[T_STRIP_BYTE_COUNTS]
        self.transform = _parse_geotransform(t)
        self.crs = _parse_crs(t)

    @property
    def chunks_x(self) -> int:
        return -(-self.width // self.chunk_w)

    @property
    def chunks_y(self) -> int:
        return -(-self.height // self.chunk_h)

    def _read_chunk(self, cy: int, cx: int, plane: int = 0) -> np.ndarray:
        spp = self.count if self._planar == 1 else 1
        idx = (plane * self.chunks_y * self.chunks_x
               + cy * self.chunks_x + cx)
        raw = _read_exact(self._f, int(self._offsets[idx]),
                          int(self._counts[idx]))
        data = _decompress(raw, self._compression)
        rows = self.chunk_h if self.tiled else min(
            self.chunk_h, self.height - cy * self.chunk_h)
        cols = self.chunk_w
        arr = np.frombuffer(data, dtype=self.dtype,
                            count=rows * cols * spp).reshape(rows, cols, spp)
        if self._predictor == 2:
            arr = _undo_predictor(arr)
        elif self._predictor != 1:
            raise ValueError(
                f"unsupported TIFF predictor {self._predictor} "
                "(only 1=none, 2=horizontal differencing)")
        return arr

    def read_window(self, row_off: int, col_off: int,
                    height: int, width: int) -> np.ndarray:
        """(height, width, count) window; out-of-raster area is zero."""
        out = np.zeros((height, width, self.count),
                       self.dtype.newbyteorder("="))
        r0 = max(row_off, 0)
        c0 = max(col_off, 0)
        r1 = min(row_off + height, self.height)
        c1 = min(col_off + width, self.width)
        if r1 <= r0 or c1 <= c0:
            return out
        planes = 1 if self._planar == 1 else self.count
        for plane in range(planes):
            for cy in range(r0 // self.chunk_h, (r1 - 1) // self.chunk_h + 1):
                for cx in range(c0 // self.chunk_w, (c1 - 1) // self.chunk_w + 1):
                    chunk = self._read_chunk(cy, cx, plane)
                    gy0 = cy * self.chunk_h
                    gx0 = cx * self.chunk_w
                    sy0 = max(r0 - gy0, 0)
                    sx0 = max(c0 - gx0, 0)
                    sy1 = min(r1 - gy0, chunk.shape[0])
                    sx1 = min(c1 - gx0, chunk.shape[1])
                    if sy1 <= sy0 or sx1 <= sx0:
                        continue
                    dy0 = gy0 + sy0 - row_off
                    dx0 = gx0 + sx0 - col_off
                    piece = chunk[sy0:sy1, sx0:sx1]
                    if self._planar == 1:
                        out[dy0:dy0 + sy1 - sy0, dx0:dx0 + sx1 - sx0] = piece
                    else:
                        out[dy0:dy0 + sy1 - sy0,
                            dx0:dx0 + sx1 - sx0, plane] = piece[:, :, 0]
        return out

    def window_geotiff(self, row_off: int, col_off: int,
                       height: int, width: int) -> GeoTiff:
        data = self.read_window(row_off, col_off, height, width)
        transform = self.transform * Affine.translation(col_off, row_off)
        return GeoTiff(data, transform=transform, crs=self.crs)

    def close(self) -> None:
        self._f.close()


def _read_exact(f: io.IOBase, offset: int, length: int) -> bytes:
    f.seek(offset)
    data = f.read(length)
    if len(data) != length:
        raise EOFError(f"short read at {offset} (+{length})")
    return data
