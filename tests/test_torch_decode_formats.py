"""The port's BMP, GIF, TIFF and WebP upload decoders
(``s2sr_tpu_torch/tiles/{bmp,gif,tiff,webp}.py``, through
``pipelines/io.py::decode_upload``) against PIL, which the JAX package
opens every non-GeoTIFF upload with (``Image.open(path).convert("RGB")``).

Tolerance: byte-equal to PIL, or PIL and the port both refusing the same
bytes. PIL writes the BMP, GIF, TIFF and WebP files it can (every mode,
compression and codec option it exposes); a small writer below makes the
BMP variants PIL cannot write (OS/2 and V4/V5 headers, 16-bit and
bitfield layouts, RLE8/RLE4 with deltas, top-down rows).
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from s2sr_tpu_torch.pipelines.io import decode_upload, load_rgb

from test_torch_decode import photo, pil_rgb


def _same_as_pil(data: bytes) -> None:
    want = pil_rgb(data)
    got = decode_upload(data)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert got.shape == want.shape and np.array_equal(got, want)


def _both_refuse(data: bytes) -> None:
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError):
        decode_upload(data)


def _pil_file(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _noise(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# --- BMP ------------------------------------------------------------------------

def bmp_file(width, height, bits, pixels, compression=0, header=40,
             palette=None, masks=None, topdown=False, colors=0,
             offset=None) -> bytes:
    """A BMP of ``pixels`` (the stored pixel bytes) with the given header
    (12, 40, 52, 56, 108, 124), palette (RGB entries), bitfield masks
    (in the V2+ header, or after a 40-byte one) and data offset."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        pad = 3
    else:
        h = 2 ** 32 - height if topdown else height
        info = struct.pack("<IIIHHIIiiII", header, width, h, 1, bits,
                           compression, len(pixels), 2835, 2835, colors, 0)
        if header >= 52 and masks is not None:
            m = list(masks) + [0] * (4 - len(masks))
            info += struct.pack("<4I", *m)[:header - 40]
        info += bytes(header - len(info))
        pad = 4
    extra = struct.pack("<3I", *masks[:3]) if header == 40 and masks else b""
    pal = b"".join(bytes((b, g, r)) + bytes(pad - 3)
                   for r, g, b in (palette if palette is not None else []))
    body = info + extra + pal
    off = 14 + len(body) if offset is None else offset
    body += bytes(max(0, off - 14 - len(body)))
    return (b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pixels), 0, 0,
                                off) + body + pixels)


def _rows(rows: np.ndarray, stride: int) -> bytes:
    return b"".join(r.tobytes() + bytes(stride - len(r.tobytes())) for r in rows)


W, H = 13, 7
PAL = [tuple(int(v) for v in c) for c in _noise((16, 3), 1)]


def _indices(bits: int, gray=False) -> bytes:
    idx = np.random.default_rng(bits).integers(0, min(1 << bits, 16), (H, W))
    if bits == 8:
        idx[0, 0] = 200                           # past the 16-entry palette
    if bits == 1:
        packed = np.packbits(idx.astype(np.uint8), axis=1)
    elif bits == 4:
        p = np.zeros((H, W + 1), np.uint8)
        p[:, :W] = idx
        packed = (p[:, 0::2] << 4) | p[:, 1::2]
    else:
        packed = idx.astype(np.uint8)
    return packed


def _paletted(bits, header=40, topdown=False, gray=False):
    packed = _indices(bits)
    stride = ((W * bits + 31) >> 3) & ~3
    rows = packed if topdown else packed[::-1]
    n = min(1 << bits, 16)
    pal = ([(0, 0, 0), (255, 255, 255)] if bits == 1 else
           [(i, i, i) for i in range(n)]) if gray else PAL[:n]
    return bmp_file(W, H, bits, _rows(rows, stride), header=header,
                    palette=pal, colors=0 if header == 12 else len(pal),
                    topdown=topdown)


def _packed16():
    px = np.random.default_rng(16).integers(0, 65536, (H, W)).astype("<u2")
    return _rows(px[::-1], ((W * 16 + 31) >> 3) & ~3)


def _packed32():
    return _noise((H, W, 4), 32)[::-1].tobytes()


def _rle8():
    data = bytearray()
    for _ in range(H):
        data += bytes([3, 5, 0, 4, 1, 2, 3, 4, 2, 7, 0, 0])
    return bytes(data + bytes([0, 1]))


def _rle8_delta():
    # a run, a delta (PIL reads two bytes past the escape's two), an
    # absolute run of odd length (padded), end of line and a final run
    data = bytes([5, 1, 0, 2, 9, 9, 2, 0, 0, 3, 4, 5, 6, 0, 0, 0])
    data += bytes([W, 7, 0, 0]) * (H - 1)
    return data + bytes([0, 1])


def _rle4():
    data = bytearray()
    for _ in range(H):
        data += bytes([5, 0x12, 0, 5, 0x34, 0x56, 0x70, 0, 3, 0x89, 0, 0])
    return bytes(data)


M32 = {"bgrx": (0xFF0000, 0xFF00, 0xFF, 0x0),
       "xbgr": (0xFF000000, 0xFF0000, 0xFF00, 0x0),
       "abgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
       "rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
       "bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
       "zero_masks": (0, 0, 0, 0)}

BMP_CASES = {
    **{f"pil_{m}": (lambda m=m: _pil_file(
        Image.fromarray(photo(13, 17, seed=4)).convert(m), "BMP"))
       for m in ("1", "L", "RGB", "RGBA")},
    "pil_P": lambda: _pil_file(Image.fromarray(photo(13, 17)).quantize(37),
                               "BMP"),
    **{f"pal{b}_h{h}": (lambda b=b, h=h: _paletted(b, h))
       for b in (1, 4, 8) for h in (40, 12, 124)},
    **{f"pal{b}_topdown": (lambda b=b: _paletted(b, topdown=True))
       for b in (1, 4, 8)},
    "pal1_black_white": lambda: _paletted(1, gray=True),
    "pal8_gray_ramp": lambda: _paletted(8, gray=True),
    "rgb555": lambda: bmp_file(W, H, 16, _packed16()),
    "bitfields_565_h40": lambda: bmp_file(W, H, 16, _packed16(), 3,
                                          masks=(0xF800, 0x7E0, 0x1F)),
    "bitfields_555_h56": lambda: bmp_file(W, H, 16, _packed16(), 3, header=56,
                                          masks=(0x7C00, 0x3E0, 0x1F, 0)),
    "raw32": lambda: bmp_file(W, H, 32, _packed32()),
    **{f"bitfields32_{k}": (lambda m=m: bmp_file(W, H, 32, _packed32(), 3,
                                                  header=108, masks=m))
       for k, m in M32.items()},
    "bitfields32_h40": lambda: bmp_file(W, H, 32, _packed32(), 3,
                                        masks=(0xFF0000, 0xFF00, 0xFF)),
    "raw24_v5": lambda: bmp_file(W, H, 24, _rows(
        _noise((H, W * 3), 24)[::-1], 40), header=124),
    "os2_24": lambda: bmp_file(W, H, 24, _rows(_noise((H, W * 3), 24)[::-1],
                                               40), header=12),
    "rle8": lambda: bmp_file(W, H, 8, _rle8(), 1, palette=PAL, colors=16),
    "rle8_delta": lambda: bmp_file(W, H, 8, _rle8_delta(), 1, palette=PAL,
                                   colors=16),
    "rle4": lambda: bmp_file(W, H, 4, _rle4(), 2, palette=PAL, colors=16),
    "offset_past_header": lambda: bmp_file(
        W, H, 8, _rows(_indices(8)[::-1], 16), palette=PAL, colors=16,
        offset=14 + 40),
}


@pytest.mark.parametrize("name", list(BMP_CASES))
def test_bmp_matches_pil(name):
    """Every header, depth, bitfield layout, RLE and row order PIL reads:
    byte-equal (indices past the palette black, a gray palette read as
    gray values, as PIL does)."""
    _same_as_pil(BMP_CASES[name]())


BMP_REFUSED = {
    "truncated": lambda: bmp_file(W, H, 24, _rows(
        _noise((H, W * 3), 24)[::-1], 40)[:-5]),
    "depth_2": lambda: bmp_file(W, H, 2, bytes(64)),
    "compression_jpeg": lambda: bmp_file(W, H, 24, bytes(320), 4),
    "bitfields_odd_masks": lambda: bmp_file(W, H, 16, _packed16(), 3,
                                            masks=(0xF00, 0xF0, 0xF)),
    "rle_short_of_pixels": lambda: bmp_file(W, H, 8, bytes([3, 5, 0, 1]), 1,
                                            palette=PAL, colors=16),
    "pal4_gray": lambda: _paletted(4, gray=True),
    "header_size_20": lambda: b"BM" + bytes(8) + struct.pack("<II", 30, 20)
    + bytes(30),
}


@pytest.mark.parametrize("name", list(BMP_REFUSED))
def test_bmp_refused_as_pil_refuses(name):
    _both_refuse(BMP_REFUSED[name]())


# --- GIF ------------------------------------------------------------------------

def _gif_frames(n, **kw):
    frames = [Image.fromarray(photo(40, 50, seed=s)) for s in range(n)]
    return _pil_file(frames[0], "GIF", save_all=True, append_images=frames[1:],
                     **kw)


def _gif_offset_frame():
    """A 20×30 frame at (7, 5) on a 40×50 screen: PIL's canvas grows to
    neither side and fills the rest with index 0."""
    data = bytearray(_pil_file(Image.fromarray(photo(20, 30, 6)), "GIF"))
    data[6:10] = struct.pack("<HH", 50, 40)
    at = data.index(b"\x2c")
    data[at + 1:at + 5] = struct.pack("<HH", 7, 5)
    return bytes(data)


def _gif_bigger_frame():
    data = bytearray(_pil_file(Image.fromarray(photo(20, 30, 7)), "GIF"))
    at = data.index(b"\x2c")
    data[at + 1:at + 5] = struct.pack("<HH", 3, 2)    # canvas grows
    return bytes(data)


GIF_CASES = {
    "rgb": lambda: _pil_file(Image.fromarray(photo(37, 53)), "GIF"),
    "rgb_interlaced": lambda: _pil_file(Image.fromarray(photo(37, 53)), "GIF",
                                        interlace=True),
    "rgb_not_interlaced": lambda: _pil_file(Image.fromarray(photo(37, 53)),
                                            "GIF", interlace=False),
    "gray": lambda: _pil_file(Image.fromarray(photo(37, 53)).convert("L"),
                              "GIF"),
    "palette_transparency": lambda: _pil_file(
        Image.fromarray(photo(37, 53)).quantize(7), "GIF", transparency=3),
    "tiny": lambda: _pil_file(Image.fromarray(_noise((3, 5, 3))), "GIF"),
    "large_lzw_table": lambda: _pil_file(Image.fromarray(_noise((120, 160, 3))),
                                         "GIF"),
    "animated_disposal_2": lambda: _gif_frames(3, duration=100, loop=0,
                                               disposal=2),
    "animated_transparency": lambda: _gif_frames(3, transparency=0),
    "frame_offset": _gif_offset_frame,
    "frame_past_screen": _gif_bigger_frame,
}


@pytest.mark.parametrize("name", list(GIF_CASES))
def test_gif_matches_pil(name):
    """The first frame, interlaced or not, global or local table, with a
    transparent index (written as any other), on a canvas that the frame
    may not fill or may grow: byte-equal."""
    _same_as_pil(GIF_CASES[name]())


@pytest.mark.parametrize("cut", [100, 30])
def test_gif_refused_as_pil_refuses(cut):
    _both_refuse(_pil_file(Image.fromarray(photo(40, 50)), "GIF")[:cut])


# --- TIFF by content ------------------------------------------------------------

def _tiff_images():
    rgb = Image.fromarray(photo(29, 37, seed=5))
    gray = np.asarray(rgb.convert("L"))
    return {
        "RGB": rgb, "L": rgb.convert("L"), "1": rgb.convert("1"),
        "P": rgb.quantize(19), "RGBA": rgb.convert("RGBA"),
        "LA": rgb.convert("LA"), "CMYK": rgb.convert("CMYK"),
        "I;16": Image.fromarray(gray.astype(np.uint16) * 7),
        "I": Image.fromarray(gray.astype(np.int32) * 3 - 100),
        "F": Image.fromarray(gray.astype(np.float32) * 1.3 - 20),
    }


TIFF_CASES = [(m, c) for m in ("RGB", "L", "1", "P", "RGBA", "LA", "CMYK",
                                "I;16", "I", "F")
              for c in (None, "tiff_lzw", "tiff_deflate", "packbits")]
TIFF_CASES += [("RGB", "jpeg"), ("L", "jpeg"), ("RGB", "lzma"),
               ("I;16", "lzma")]
TIFF_CASES += [(m, "zstd") for m in ("RGB", "L", "1", "P", "RGBA", "LA", "CMYK",
                                     "I;16", "I", "F")]
TIFF_CASES += [("1", c) for c in ("group3", "group4", "tiff_ccitt")]


@pytest.mark.parametrize("mode, compression", TIFF_CASES)
def test_tiff_by_content_matches_pil(mode, compression):
    """A TIFF upload decodes to PIL's convert("RGB") of the mode PIL gives
    it (16-bit and 32-bit gray clipped, float truncated, palette through
    the colour map, CMYK through cmyk2rgb), every compression PIL
    writes (LZMA through the standard library, ZSTD through
    ``tiles/zstd.py``, CCITT fax through ``tiles/ccitt.py``),
    JPEG-compressed strips through the JPEG decoder: byte-equal."""
    _same_as_pil(_pil_file(_tiff_images()[mode], "TIFF",
                           compression=compression))


def test_tiff_predictor_and_suffix(tmp_path):
    """Horizontal differencing; and a TIFF named without a .tif suffix gets
    PIL's conversion, not load_rgb's GeoTIFF min-max scaling (the same
    16-bit file by its .tif name is scaled)."""
    _same_as_pil(_pil_file(_tiff_images()["RGB"], "TIFF",
                           compression="tiff_lzw", tiffinfo={317: 2}))
    data = _pil_file(_tiff_images()["I;16"], "TIFF")
    (tmp_path / "upload").write_bytes(data)
    (tmp_path / "scene.tif").write_bytes(data)
    by_content, _, _ = load_rgb(tmp_path / "upload")
    by_suffix, _, _ = load_rgb(tmp_path / "scene.tif")
    assert np.array_equal(by_content, pil_rgb(data))
    assert not np.array_equal(by_suffix, by_content)


def test_tiff_refused_as_pil_refuses():
    """A TIFF whose first directory lies past the end of the file."""
    _both_refuse(b"II*\x00" + struct.pack("<I", 4096) + bytes(32))


def test_tiff_large_lzw_and_lossless_webp_match_pil():
    """A 384×512 LZW TIFF and lossless WebP: the readers' bit windows stay
    bounded (a reader that shifted one big integer of the whole stream
    took minutes on photo-sized files)."""
    img = Image.fromarray(photo(384, 512, seed=21))
    _same_as_pil(_pil_file(img, "TIFF", compression="tiff_lzw"))
    _same_as_pil(_pil_file(img, "WEBP", lossless=True))


# --- TIFF: CCITT fax, ZSTD, CIELab ---------------------------------------------------

def _ifd(data: bytes) -> dict:
    """tag → (type, count, value bytes) of a little-endian TIFF's first
    directory."""
    off = struct.unpack("<I", data[4:8])[0]
    out = {}
    size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8}
    for i in range(struct.unpack("<H", data[off:off + 2])[0]):
        tag, typ, cnt, val = struct.unpack("<HHI4s", data[off + 2 + 12 * i:
                                                         off + 14 + 12 * i])
        n = size.get(typ, 1) * cnt
        if n > 4:
            at = struct.unpack("<I", val)[0]
            val = data[at:at + n]
        out[tag] = (typ, cnt, val[:n])
    return out


def _rewrite_tiff(data: bytes, strip: bytes | None = None, **tags) -> bytes:
    """``data`` (one strip) written again with its strip replaced and
    tags set (``t262=0``), other tags kept: a minimal writer for the
    variants PIL will not write (photometric 0 fax, FillOrder 2)."""
    ifd = _ifd(data)
    vals = {t: (typ, cnt, raw) for t, (typ, cnt, raw) in ifd.items()}
    offs = struct.unpack("<I", ifd[273][2][:4])[0]
    if strip is None:
        strip = data[offs:offs + struct.unpack("<I", ifd[279][2][:4])[0]]
    for name, v in tags.items():
        vals[int(name[1:])] = (3, 1, struct.pack("<H", v))
    vals[279] = (4, 1, struct.pack("<I", len(strip)))
    entries = sorted(vals.items())
    head = 8
    ifd_size = 2 + 12 * len(entries) + 4
    extra = bytearray()
    strip_at = head + ifd_size
    body = bytearray()
    blob_at = strip_at + len(strip)
    for tag, (typ, cnt, raw) in entries:
        if tag == 273:
            raw = struct.pack("<I", strip_at)
            typ, cnt = 4, 1
        if len(raw) > 4:
            ptr = blob_at + len(extra)
            extra += raw + (b"\0" if len(raw) % 2 else b"")
            raw = struct.pack("<I", ptr)
        body += struct.pack("<HHI", tag, typ, cnt) + raw.ljust(4, b"\0")
    return (b"II*\x00" + struct.pack("<I", head) + struct.pack("<H", len(entries))
            + bytes(body) + b"\0\0\0\0" + strip + bytes(extra))


_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def _fax_image():
    rng = np.random.default_rng(3)
    runs = np.repeat(rng.random((24, 40)) > 0.5, 9, axis=1)
    page = np.asarray(Image.fromarray(photo(24, 360, seed=4)).convert("1"))
    return Image.fromarray(np.concatenate([runs, page], 0).astype(np.uint8) * 255
                           ).convert("1")


FAX_CASES = {
    # name: (compression, save options, rewrite: photometric, fill order)
    "t4_1d_photometric_1": ("group3", {}, None, None),
    "t4_2d": ("group3", {"tiffinfo": {292: 1}}, None, None),
    "t4_2d_fill_bits": ("group3", {"tiffinfo": {292: 5}}, None, None),
    "t4_1d_fill_bits": ("group3", {"tiffinfo": {292: 4}}, None, None),
    "t4_photometric_0": ("group3", {}, 0, None),
    "t4_2d_fill_order_2": ("group3", {"tiffinfo": {292: 1}}, None, 2),
    "t6_photometric_1": ("group4", {}, None, None),
    "t6_photometric_0": ("group4", {}, 0, None),
    "t6_fill_order_2": ("group4", {}, 0, 2),
    "mh_photometric_1": ("tiff_ccitt", {}, None, None),
    "mh_photometric_0": ("tiff_ccitt", {}, 0, None),
    "mh_fill_order_2": ("tiff_ccitt", {}, None, 2),
}


def fax_file(name: str) -> bytes:
    """A 1-bit page (runs and a dithered photo, 360 wide) as PIL writes
    it under ``name``'s compression and options (one strip), rewritten
    with photometric 0 (PIL writes 1) or FillOrder 2 (the strip's bits
    reversed, as libtiff reads them back) where the case asks."""
    comp, kw, photometric, fill = FAX_CASES[name]
    data = _pil_file(_fax_image(), "TIFF", compression=comp,
                     strip_size=1 << 20, **kw)
    tags = {}
    if photometric is not None:
        tags["t262"] = photometric
    if fill is None:
        return _rewrite_tiff(data, **tags) if tags else data
    ifd = _ifd(data)
    at = struct.unpack("<I", ifd[273][2][:4])[0]
    strip = data[at:at + struct.unpack("<I", ifd[279][2][:4])[0]]
    return _rewrite_tiff(data, strip.translate(_REVERSED), t266=fill, **tags)


@pytest.mark.parametrize("name", list(FAX_CASES))
def test_tiff_fax_matches_pil(name):
    """CCITT fax strips (Modified Huffman, T.4 1-D and 2-D with and
    without fill bits, T.6) under photometric 0 and 1 and FillOrder 2
    decode to PIL's bytes."""
    data = fax_file(name)
    if FAX_CASES[name][2] == 0:
        assert np.asarray(Image.open(io.BytesIO(data))).mean() != \
            np.asarray(_fax_image()).mean()
    _same_as_pil(data)


@pytest.mark.parametrize("name", ["t4_2d", "mh_photometric_1",
                                  "t6_photometric_1"])
def test_tiff_fax_refused_as_pil_refuses(name):
    """A T.4 or Modified Huffman strip cut to a third, and any fax strip
    under an 8-bit layout: PIL refuses them, and so does the port. (A T.6
    strip cut short PIL decodes in part, as libtiff fills what it read:
    ``test_tiff_fax_t6_cut_short_matches_pil``.)"""
    data = fax_file(name)
    ifd = _ifd(data)
    at = struct.unpack("<I", ifd[273][2][:4])[0]
    cut = data[at:at + struct.unpack("<I", ifd[279][2][:4])[0] // 3]
    if not name.startswith("t6"):
        _both_refuse(_rewrite_tiff(data, cut))
    _both_refuse(_rewrite_tiff(data, t258=8))


@pytest.mark.parametrize("fraction", [1 / 3, 1 / 2, 9 / 10])
@pytest.mark.parametrize("name", ["t6_photometric_1", "t6_photometric_0",
                                  "t6_fill_order_2"])
def test_tiff_fax_t6_cut_short_matches_pil(name, fraction):
    """A T.6 strip cut short decodes as libtiff decodes it: the complete
    rows, then the row the data ran out in, filled with the runs read
    (zeros read past the end), equal to PIL's bytes. PIL's rows after
    that are its buffer's bytes, never written (they differ from one
    process to the next); the port's are the 0 sample, one value."""
    from s2sr_tpu_torch.tiles import ccitt

    data = fax_file(name)
    ifd = _ifd(data)
    at = struct.unpack("<I", ifd[273][2][:4])[0]
    cut = data[at:at + int(struct.unpack("<I", ifd[279][2][:4])[0] * fraction)]
    short = _rewrite_tiff(data, cut)
    if FAX_CASES[name][3] == 2:
        cut = cut.translate(_REVERSED)
    _, written, stopped = ccitt.fax4_libtiff(cut, 360, 48)
    assert stopped and 1 < written < 48
    want, got, full = pil_rgb(short), decode_upload(short), pil_rgb(data)
    assert got.shape == want.shape == (48, 360, 3)
    assert np.array_equal(got[:written], want[:written])
    assert np.array_equal(got[:written - 1], full[:written - 1])
    assert not np.array_equal(got[written - 1], full[written - 1])
    assert (got[written:] == got[written, 0, 0]).all()


def test_tiff_zstd_predictor_and_blocks_match_pil():
    """ZSTD with horizontal differencing (RGB and 16-bit gray), and a
    one-strip 480×640 photo: a frame of several blocks whose literals
    are Huffman-coded with a new or the previous tree and whose sequence
    tables repeat from block to block."""
    from s2sr_tpu_torch.tiles import zstd

    _same_as_pil(_pil_file(_tiff_images()["RGB"], "TIFF", compression="zstd",
                           tiffinfo={317: 2}))
    _same_as_pil(_pil_file(_tiff_images()["I;16"], "TIFF", compression="zstd",
                           tiffinfo={317: 2}))
    rng = np.random.default_rng(5)
    y, x = np.mgrid[:480, :640]
    base = 128 + 60 * np.sin(x / 17.0) * np.cos(y / 23.0)
    blocks = (rng.integers(0, 4, (31, 41)) * 20)[y // 16, x // 16]
    img = np.stack([base + blocks, base * 0.8 + blocks, 255 - base], -1) // 32 * 32
    data = _pil_file(Image.fromarray(img.astype(np.uint8)), "TIFF",
                     compression="zstd", strip_size=1 << 22)
    assert len(data) > 16 * 1024 and img.size > 2 * 128 * 1024
    seen = []
    real = zstd._sequences

    def spy(buf, pos, end, state):
        n = buf[pos]
        if n:
            at = pos + (1 if n < 128 else 2 if n < 255 else 3)
            seen.append(buf[at])
        return real(buf, pos, end, state)

    zstd._sequences = spy
    try:
        _same_as_pil(data)
    finally:
        zstd._sequences = real
    modes = {(m >> s) & 3 for m in seen for s in (2, 4, 6)}
    assert len(seen) > 1 and 3 in modes          # a repeated table


def _zstd_frame(blocks: list, content: bytes, checksum: bool = True) -> bytes:
    """A single-segment frame of the given (type, payload) blocks."""
    fhd = 0x20 | (0x04 if checksum else 0) | 0xC0      # 8-byte content size
    out = struct.pack("<IB", 0xFD2FB528, fhd) + struct.pack("<Q", len(content))
    for k, (kind, payload, size) in enumerate(blocks):
        last = k == len(blocks) - 1
        out += struct.pack("<I", last | (kind << 1) | (size << 3))[:3] + payload
    if checksum:
        from s2sr_tpu_torch.tiles.zstd import xxh64

        out += struct.pack("<I", xxh64(content) & 0xFFFFFFFF)
    return out


def _huffman_literals(text: bytes, streams: int) -> bytes:
    """A compressed literals section of ``text`` (two symbols, 'A' and
    'B'): a direct-weight tree, then 1 or 4 backward streams."""
    weights = [0] * 65 + [1]               # 'A' (65) weight 1; 'B' implied
    tree = bytes([127 + len(weights)]) + bytes(
        (weights[i] << 4) | (weights[i + 1] if i + 1 < len(weights) else 0)
        for i in range(0, len(weights), 2))

    def stream(part: bytes) -> bytes:
        v = 1
        for ch in part:
            v = (v << 1) | (ch == ord("B"))
        return v.to_bytes((v.bit_length() + 7) // 8, "little")

    if streams == 1:
        body = stream(text)
    else:
        q = (len(text) + 3) // 4
        parts = [stream(text[i * q:(i + 1) * q]) for i in range(4)]
        body = struct.pack("<HHH", *(len(p) for p in parts[:3])) + b"".join(parts)
    comp = len(tree) + len(body)
    head = 2 | ((0 if streams == 1 else 1) << 2) | (len(text) << 4) | (comp << 14)
    return struct.pack("<I", head)[:3] + tree + body


def test_zstd_frames_libtiff_does_not_write():
    """Frames built here for what libtiff's ZSTD does not emit: raw and
    RLE blocks, RLE and raw literals without sequences, direct Huffman
    weights in 1 and 4 streams, a skippable frame before, the content
    checksum (XXH64) verified, and a wrong checksum refused. XXH64 against
    its published vectors."""
    from s2sr_tpu_torch.tiles.zstd import ZstdError, decompress, xxh64

    assert [xxh64(b""), xxh64(b"a"), xxh64(b"abc")] == [
        0xEF46DB3751D8E999, 0xD24EC4F1A98C6E5B, 0x44BC2CF5AD770999]
    text = bytes(np.random.default_rng(2).choice([65, 66], 300).astype(np.uint8))
    content = b"raw!" + b"\x07" * 9 + b"Z" * 20 + b"lit" + text + text
    # (block type, payload, block size): raw, RLE, then compressed blocks
    # of RLE literals, raw literals and Huffman literals, no sequences
    blocks = [(0, b"raw!", 4), (1, b"\x07", 9),
              (2, bytes([1 | (20 << 3), ord("Z"), 0]), 3),
              (2, bytes([0 | (3 << 3)]) + b"lit" + b"\0", 5)]
    for streams in (1, 4):
        payload = _huffman_literals(text, streams) + b"\0"
        blocks.append((2, payload, len(payload)))
    frame = _zstd_frame(blocks, content)
    skip = struct.pack("<II", 0x184D2A5E, 5) + b"hello"
    assert decompress(skip + frame) == content
    assert decompress(_zstd_frame(blocks, content, checksum=False)) == content
    bad = bytearray(frame)
    bad[-1] ^= 1
    with pytest.raises(ZstdError, match="checksum"):
        decompress(bytes(bad))
    with pytest.raises(ValueError):
        decompress(frame[:-9])


def test_zstd_tif_named_file_refused_as_jax_refuses(tmp_path):
    """A ``.tif``-named file goes through the GeoTIFF readers, and JAX's
    refuses ZSTD: so does the port's (by content it decodes)."""
    from s2sr_tpu.pipelines.io import load_rgb as jax_load_rgb

    data = _pil_file(_tiff_images()["RGB"], "TIFF", compression="zstd")
    path = tmp_path / "scene.tif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="50000"):
        jax_load_rgb(path)
    with pytest.raises(ValueError, match="50000"):
        load_rgb(path)
    assert np.array_equal(decode_upload(data), pil_rgb(data))


def _lab_file(lab: np.ndarray, **kw) -> bytes:
    h, w = lab.shape[:2]
    return _pil_file(Image.frombytes("LAB", (w, h), lab.tobytes()), "TIFF", **kw)


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "zstd"])
def test_tiff_lab_matches_pil(compression):
    """A CIELab photo (photometric 8) decodes to PIL's LittleCMS bytes."""
    rgb = photo(37, 45, seed=12).astype(np.float64)
    lab = np.stack([rgb[..., 0], rgb[..., 1] - 100, 90 - rgb[..., 2]], -1)
    data = _lab_file(lab.astype(np.int64).astype(np.uint8), compression=compression)
    assert Image.open(io.BytesIO(data)).mode == "LAB"
    _same_as_pil(data)


def test_lab_cube_matches_pil():
    """Every one of the 256³ Lab triples (one 4096² image): the port's
    bytes equal PIL's (LittleCMS's 33³ table and its tetrahedral reads)."""
    from s2sr_tpu_torch.tiles.lab import lab_to_rgb

    cube = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([cube >> 16, (cube >> 8) & 255, cube & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), lab.tobytes())
                      .convert("RGB"))
    got = lab_to_rgb(lab)
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("photometric", [9, 10])
def test_icc_and_itu_lab_refused_as_pil_refuses(photometric):
    """ICC Lab (9) and ITU Lab (10): PIL does not open them; neither does
    the port."""
    lab = np.random.default_rng(0).integers(0, 256, (20, 30, 3)).astype(np.uint8)
    _both_refuse(_rewrite_tiff(_lab_file(lab), t262=photometric))


# --- WebP -----------------------------------------------------------------------

def _webp(img, **kw) -> bytes:
    mode = "RGBA" if img.shape[-1] == 4 else "RGB"
    return _pil_file(Image.fromarray(img, mode), "WEBP", **kw)


def _alpha_photo(h, w, seed):
    return np.concatenate([photo(h, w, seed), _noise((h, w, 1), seed)], -1)


def _webp_anim(**kw):
    frames = [Image.fromarray(photo(40, 50, s)) for s in range(3)]
    return _pil_file(frames[0], "WEBP", save_all=True,
                     append_images=frames[1:], duration=100, **kw)


WEBP_CASES = {
    "lossless": lambda: _webp(photo(37, 53, 3), lossless=True),
    "lossless_q0": lambda: _webp(photo(37, 53, 3), lossless=True, quality=0),
    "lossless_m6": lambda: _webp(photo(37, 53, 3), lossless=True, method=6),
    "lossless_noise": lambda: _webp(_noise((45, 67, 3)), lossless=True),
    "lossless_palette_bundled": lambda: _webp(
        (photo(30, 41, 1) // 128 * 255).astype(np.uint8), lossless=True),
    "lossless_palette": lambda: _webp((photo(30, 41, 1) // 64 * 64)
                                      .astype(np.uint8), lossless=True),
    "lossless_1x1": lambda: _webp(_noise((1, 1, 3)), lossless=True),
    "lossless_alpha": lambda: _webp(_alpha_photo(40, 50, 2), lossless=True),
    "lossless_alpha_exact": lambda: _webp(_alpha_photo(40, 50, 2),
                                          lossless=True, exact=True),
    "lossy_q80": lambda: _webp(photo(37, 53, 3), quality=80),
    "lossy_q10": lambda: _webp(photo(37, 53, 3), quality=10),
    "lossy_q100": lambda: _webp(photo(37, 53, 3), quality=100),
    "lossy_m0": lambda: _webp(photo(37, 53, 3), quality=80, method=0),
    "lossy_m6": lambda: _webp(photo(37, 53, 3), quality=50, method=6),
    "lossy_noise": lambda: _webp(_noise((45, 67, 3)), quality=90),
    "lossy_1x1": lambda: _webp(_noise((1, 1, 3)), quality=75),
    "lossy_17x33": lambda: _webp(photo(17, 33, 4), quality=75),
    "lossy_alpha": lambda: _webp(_alpha_photo(40, 50, 2), quality=80),
    "animated_lossy": lambda: _webp_anim(quality=70),
    "animated_lossless": lambda: _webp_anim(lossless=True),
}


@pytest.mark.parametrize("name", list(WEBP_CASES))
def test_webp_matches_pil(name):
    """VP8L (every transform the encoder picks, colour cache, palettes with
    pixel bundling), VP8 (segments, both 16×16 and 4×4 prediction, the
    loop filter, fancy upsampling), with alpha (dropped by convert, never
    premultiplied) and the first frame of an animation: byte-equal."""
    _same_as_pil(WEBP_CASES[name]())


@pytest.mark.parametrize("lossless", [False, True])
def test_webp_truncated_refused_as_pil_refuses(lossless):
    data = _webp(photo(40, 50, 5), lossless=lossless, quality=80)
    _both_refuse(data[:len(data) // 2])
