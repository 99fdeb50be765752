"""The port's upload decoders (``s2sr_tpu_torch/tiles/png.py::decode_png``,
``tiles/jpeg.py::decode_jpeg``, ``pipelines/io.py::load_rgb``) against
PIL, which the JAX package opens every non-GeoTIFF upload with
(``Image.open(path).convert("RGB")``, ``s2sr_tpu/pipelines/io.py``).

Tolerance everywhere: byte-equal. PNGs are written here for every colour
type × bit depth, plain and Adam7, with every filter; JPEGs by PIL (its
encoder's variants) and by a small baseline encoder below for what PIL
cannot write (4:4:0, SOF1, the Adobe transform flag, RGB component ids,
one scan per component). The committed fixtures of
``tests/fixtures_torch/`` are held to the SHA-256 of PIL's decode
recorded beside them, which ``chip_smoke.py`` checks on the card's
machine, where there is no PIL.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from s2sr_tpu_torch.pipelines.io import decode_upload, load_rgb
from s2sr_tpu_torch.tiles.jpeg import decode_jpeg
from s2sr_tpu_torch.tiles.png import decode_png, encode_png
from torch_threads import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).parent / "fixtures_torch"


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# --- PNG ----------------------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples → (h, stride) bytes: big-endian 16-bit, or bits
    packed MSB first."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.reshape(h, -1).astype(np.uint8)
    vals = samples.reshape(h, -1).astype(np.uint8)
    bits = (vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row under a random one of the five filters, led by its type."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        ft = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) >> 1, paeth][ft]
        out.append(ft)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def png_bytes(samples, color_type, depth, interlace=False, palette=None,
              trns=None, seed=0) -> bytes:
    h, w, _ = samples.shape
    rng = np.random.default_rng(seed)
    bpp = max(1, CHANNELS[color_type] * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack_rows(sub, depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


PNG_CASES = [(ct, d, il) for ct, ds in DEPTHS.items() for d in ds
             for il in (False, True)]


@pytest.mark.parametrize("color_type, depth, interlace", PNG_CASES)
def test_png_matches_pil(color_type, depth, interlace):
    """Every colour type × depth, plain and Adam7, rows under random
    filters; palette and tRNS where the type has them; byte-equal to PIL's
    RGB conversion (13 × 11 px: every Adam7 pass non-empty and ragged)."""
    rng = np.random.default_rng(color_type * 100 + depth * 2 + interlace)
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (11, 13, CHANNELS[color_type]))
    if depth == 16:       # both sides of PIL's 16-bit gray clip at 255
        samples[::3] %= 300
    palette = trns = None
    if color_type == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
        trns = bytes(rng.integers(0, 256, min(5, 1 << depth)).astype(np.uint8))
    elif color_type == 0:
        trns = struct.pack(">H", int(samples[0, 0, 0]))
    elif color_type == 2:
        trns = struct.pack(">HHH", *map(int, samples[0, 0]))
    data = png_bytes(samples, color_type, depth, interlace, palette, trns,
                     seed=depth)
    want = pil_rgb(data)
    got = decode_upload(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_png_palette_index_past_palette_is_black():
    """An index past a short palette decodes black, byte-equal to PIL."""
    samples = np.array([[[0], [3]], [[1], [2]]])
    data = png_bytes(samples, 3, 8, palette=np.array([[10, 20, 30],
                                                      [40, 50, 60]]))
    assert np.array_equal(decode_upload(data), pil_rgb(data))
    assert decode_upload(data)[0, 1].tolist() == [0, 0, 0]


@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 700, 4), (90, 3, 3)])
def test_png_encoder_round_trip_and_shapes(shape):
    """The port's own encoder's output (Sub filter), decoded unchanged,
    on degenerate shapes; and random filters on the same pixels."""
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    assert np.array_equal(decode_png(encode_png(img)), img)
    data = png_bytes(img, {3: 2, 4: 6}[shape[2]], 8, seed=3)
    assert np.array_equal(decode_png(data), img)


def _unfilter_by_byte(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The five PNG filters undone one byte at a time, as the decoder
    did before its diagonal loop: the reference it must equal."""
    rows, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((rows, stride), np.int64)
    for y in range(rows):
        ft, row = raw[y, 0], raw[y, 1:].astype(np.int64)
        prev = out[y - 1] if y else np.zeros(stride, np.int64)
        for x in range(stride):
            a = out[y, x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ft]
            out[y, x] = (row[x] + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("filters", [5, 3])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_equals_byte_loop(bpp, filters):
    """The unfilter equals the byte-at-a-time loop on random bytes under
    random filters, bit for bit (integer arithmetic): all five (the
    diagonal loop) and None/Sub/Up only (one step a row)."""
    from s2sr_tpu_torch.tiles.png import _unfilter

    rng = np.random.default_rng(bpp)
    raw = rng.integers(0, 256, (9, 1 + 7 * bpp), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, filters, 9)
    assert np.array_equal(_unfilter(raw, bpp), _unfilter_by_byte(raw, bpp))


def test_png_refuses_bad_input():
    """Not a PNG, or a depth its colour type does not allow: ValueError."""
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    bad = png_bytes(np.zeros((2, 2, 1), np.uint8), 0, 8)
    bad = bad.replace(struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0),
                      struct.pack(">IIBBBBB", 2, 2, 16, 3, 0, 0, 0))
    with pytest.raises(ValueError, match="bad PNG header"):
        decode_png(bad)


# --- JPEG ---------------------------------------------------------------------

def photo(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Fields with noise: both smooth areas and high-frequency blocks."""
    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields

    img = synthetic_fields((h, w), seed=seed).astype(np.int32)
    img += np.random.default_rng(seed).integers(-25, 26, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


PIL_JPEG_CASES = {
    "baseline_444": dict(quality=90, subsampling=0),
    "baseline_422": dict(quality=90, subsampling=1),
    "baseline_420": dict(quality=75, subsampling=2),
    "baseline_411": dict(quality=85, subsampling="4:1:1"),
    "baseline_420_q100": dict(quality=100, subsampling=2),
    "optimized_420": dict(quality=90, subsampling=2, optimize=True),
    "progressive_420": dict(quality=90, subsampling=2, progressive=True),
    "progressive_444_q30": dict(quality=30, subsampling=0, progressive=True),
    "restart_blocks_420": dict(quality=90, subsampling=2,
                               restart_marker_blocks=3),
    "progressive_422_restart_rows": dict(quality=80, subsampling=1,
                                         progressive=True,
                                         restart_marker_rows=1),
}


@pytest.mark.parametrize("name", list(PIL_JPEG_CASES))
@pytest.mark.parametrize("shape", [(61, 75), (8, 8), (3, 5)])
def test_jpeg_from_pil_matches_pil(name, shape):
    """PIL's encoder's variants, byte-equal to PIL's decode; odd sizes
    (ragged MCUs), one block, and chroma 2 px wide (libjpeg then
    replicates instead of its fancy filter)."""
    data = pil_jpeg(photo(*shape, seed=len(name)), **PIL_JPEG_CASES[name])
    assert np.array_equal(decode_upload(data), pil_rgb(data))


def test_jpeg_grayscale_matches_pil():
    """One component: (H, W, 1) from the decoder, PIL's bytes (gray
    replicated) from the upload path, byte-equal."""
    data = pil_jpeg(photo(37, 29)[..., 1], quality=90)
    got = decode_jpeg(data)
    assert got.shape == (37, 29, 1)
    assert np.array_equal(decode_upload(data), pil_rgb(data))


# A baseline encoder for what PIL's cannot write. Huffman tables are
# canonical fixed-length codes over the symbols used (valid tables; the
# decoder takes any), the DCT a float one (any coefficients will do).

_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
                    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47,
                    55, 62, 63])


def _dct_blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(8h, 8w) plane → (h, w, 64) quantized coefficients in zigzag order."""
    k = np.arange(8)
    c = np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2)
    h, w = plane.shape[0] // 8, plane.shape[1] // 8
    b = plane.reshape(h, 8, w, 8).transpose(0, 2, 1, 3).astype(np.float64) - 128
    coef = np.einsum("ij,abjk,lk->abil", c, b, c).reshape(h, w, 64)
    return np.round(coef / q.reshape(64))[..., _ZIGZAG].astype(np.int64)


def _size(v: int) -> int:
    return int(abs(v)).bit_length()


def _bits(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


class _Writer:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        self.acc = (self.acc << length) | value
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _table(symbols) -> tuple:
    """Canonical codes of one length for ``symbols``: (counts, code map)."""
    syms = sorted(set(symbols))
    length = max(2, (len(syms)).bit_length())
    counts = [0] * 16
    counts[length - 1] = len(syms)
    return bytes(counts) + bytes(syms), {s: (i, length) for i, s in
                                         enumerate(syms)}


def own_jpeg(img, sampling=((1, 1), (1, 1), (1, 1)), sof=0xC0, app=("jfif",),
             adobe_transform=None, ids=(1, 2, 3), restart=0,
             interleaved=True, quality_q=6) -> bytes:
    """A sequential JPEG of ``img`` (H, W, 3) uint8 taken as the planes
    to code (no colour conversion: what they mean is for the markers to
    say): sampling (h, v) per component, SOF0 or SOF1, JFIF and/or Adobe
    markers, component ids, a restart interval, one scan or one per
    component."""
    hgt, wid = img.shape[:2]
    nc = len(sampling)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    q = np.full(64, quality_q, np.int64)
    q[0] = 4
    coefs = []
    for ci, (h, v) in enumerate(sampling):
        dw, dh = -(-wid * h // hmax), -(-hgt * v // vmax)
        plane = img[::vmax // v, ::hmax // h, ci][:dh, :dw]
        ph, pw = mcuy * v * 8, mcux * h * 8
        plane = np.pad(plane, ((0, ph - dh), (0, pw - dw)), mode="edge")
        coefs.append((_dct_blocks(plane, q), -(-dh // 8), -(-dw // 8)))

    def scans():
        if interleaved:
            units = []
            for my in range(mcuy):
                for mx in range(mcux):
                    units.append([(ci, my * v + y, mx * h + x)
                                  for ci, (h, v) in enumerate(sampling)
                                  for y in range(v) for x in range(h)])
            yield list(range(nc)), units
        else:
            for ci in range(nc):
                _, hb, wb = coefs[ci]
                yield [ci], [[(ci, y, x)] for y in range(hb) for x in range(wb)]

    # symbols of every block, to size the tables
    dc_syms, ac_syms, coded = [], [], []
    for comps, units in scans():
        pred = {ci: 0 for ci in comps}
        seq = []
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                pred = {ci: 0 for ci in comps}
                seq.append(None)
            for ci, y, x in unit:
                blk = coefs[ci][0][y, x]
                diff = int(blk[0]) - pred[ci]
                pred[ci] = int(blk[0])
                items = [("dc", _size(diff), diff)]
                run = 0
                last = max([k for k in range(1, 64) if blk[k]] or [0])
                for k in range(1, last + 1):
                    if blk[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        items.append(("ac", 0xF0, None))
                        run -= 16
                    items.append(("ac", run << 4 | _size(blk[k]), int(blk[k])))
                    run = 0
                if last < 63:
                    items.append(("ac", 0x00, None))
                dc_syms += [s for kind, s, _ in items if kind == "dc"]
                ac_syms += [s for kind, s, _ in items if kind == "ac"]
                seq.append(items)
        coded.append((comps, seq))
    dc_spec, dc_code = _table(dc_syms)
    ac_spec, ac_code = _table(ac_syms)

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    out = b"\xff\xd8"
    if "jfif" in app:
        out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe_transform]))
    out += seg(0xDB, b"\x00" + bytes(q[_ZIGZAG].astype(np.uint8)))
    out += seg(sof, struct.pack(">BHHB", 8, hgt, wid, nc) + b"".join(
        bytes([ids[ci], h << 4 | v, 0]) for ci, (h, v) in enumerate(sampling)))
    out += seg(0xC4, b"\x00" + dc_spec + b"\x10" + ac_spec)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    for comps, seq in coded:
        out += seg(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[ci], 0x00]) for ci in comps) + b"\x00\x3f\x00")
        w, rst = _Writer(), 0
        for items in seq:
            if items is None:
                w.flush()
                out += bytes(w.out) + bytes([0xFF, 0xD0 + rst % 8])
                w, rst = _Writer(), rst + 1
                continue
            for kind, s, v in items:
                code, length = (dc_code if kind == "dc" else ac_code)[s]
                w.put(code, length)
                size = s & 15 if kind == "ac" else s
                if size:
                    w.put(_bits(v, size), size)
        w.flush()
        out += bytes(w.out)
    return out + b"\xff\xd9"


OWN_JPEG_CASES = {
    "ycc_440": dict(sampling=((1, 2), (1, 1), (1, 1))),
    "ycc_420_sof1": dict(sampling=((2, 2), (1, 1), (1, 1)), sof=0xC1),
    "ycc_422_restart_2": dict(sampling=((2, 1), (1, 1), (1, 1)), restart=2),
    "ycc_420_one_scan_each": dict(sampling=((2, 2), (1, 1), (1, 1)),
                                  interleaved=False, restart=5),
    "adobe_rgb_transform_0": dict(app=(), adobe_transform=0),
    "adobe_ycc_transform_1": dict(app=(), adobe_transform=1,
                                  sampling=((2, 2), (1, 1), (1, 1))),
    "jfif_beats_adobe_0": dict(adobe_transform=0),
    "rgb_component_ids": dict(app=(), ids=(82, 71, 66)),
    "ycc_by_unknown_ids": dict(app=(), ids=(7, 8, 9),
                               sampling=((1, 2), (1, 1), (1, 1))),
    "ycc_chroma_wide_420": dict(sampling=((1, 1), (2, 2), (1, 1))),
}


@pytest.mark.parametrize("name", list(OWN_JPEG_CASES))
@pytest.mark.parametrize("shape", [(29, 43), (5, 3)])
def test_jpeg_variants_pil_cannot_write(name, shape):
    """4:4:0, SOF1, one scan per component, restart intervals, and the
    colour-space rule (JFIF, Adobe transform flag, component ids):
    byte-equal to PIL."""
    data = own_jpeg(photo(*shape, seed=3), **OWN_JPEG_CASES[name])
    assert np.array_equal(decode_upload(data), pil_rgb(data))


def _sof(marker: int, precision: int = 8, nc: int = 3) -> bytes:
    return (b"\xff\xd8" + bytes([0xFF, marker]) + struct.pack(
        ">HBHHB", 8 + 3 * nc, precision, 8, 8, nc)
        + b"".join(bytes([k + 1, 0x11, 0]) for k in range(nc)))


@pytest.mark.parametrize("data, named", [
    (_sof(0xC3), "lossless"), (_sof(0xC9), "arithmetic-coded"),
    (_sof(0xCA), "arithmetic-coded progressive"), (_sof(0xC5), "hierarchical"),
    (_sof(0xC1, precision=12), "12-bit"), (_sof(0xC0, nc=4), "CMYK")])
def test_unsupported_jpeg_refused_by_name(data, named):
    """A frame header and nothing after it, of each kind: PIL refuses the
    bytes, and so does the decoder. Complete files of the kinds PIL
    decodes (lossless, arithmetic, CMYK) decode to PIL's bytes
    (``test_torch_decode_jpeg.py``); hierarchical and 12-bit ones PIL
    refuses whole, and the decoder names them."""
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError):
        decode_jpeg(data)
    if named in ("hierarchical", "12-bit"):
        with pytest.raises(ValueError, match=f"{named}.*PIL refuses it too"):
            decode_jpeg(data)


def test_cmyk_jpeg_from_pil_refused():
    """A real 4-component file (PIL's CMYK with the Adobe marker): since
    the CMYK decode it is no longer refused, and gives PIL's bytes
    (inverted Adobe CMYK through PIL's ``cmyk2rgb``)."""
    buf = io.BytesIO()
    Image.fromarray(photo(16, 16)).convert("CMYK").save(buf, format="JPEG")
    data = buf.getvalue()
    assert np.array_equal(decode_upload(data), pil_rgb(data))


# --- headers that declare more than the data holds ---------------------------

def _declared(kind: str, side: int) -> bytes:
    """A small valid file whose header is rewritten to declare side²."""
    img = photo(16, 16)
    if kind == "png":
        data = encode_png(img)                  # IHDR payload at 16..29
        ihdr = b"IHDR" + struct.pack(">II", side, side) + data[24:29]
        crc = struct.pack(">I", zlib.crc32(ihdr) & 0xFFFFFFFF)
        return data[:12] + ihdr + crc + data[33:]
    data = pil_jpeg(img, quality=90)
    at = data.index(b"\xff\xc0") + 5           # marker, length, precision
    return data[:at] + struct.pack(">HH", side, side) + data[at + 4:]


@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_decompression_bomb_refused_as_pil_refuses(kind):
    """A header that declares 65535² on a file of a few hundred bytes
    raises before anything of that size is allocated, with PIL's
    message: PIL refuses it too (DecompressionBombError above
    2·MAX_IMAGE_PIXELS)."""
    data = _declared(kind, 65535)
    assert len(data) < 2000
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="exceeds limit of 178956970 pixels"):
        decode_upload(data)


@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_declared_size_without_its_data_refused(kind):
    """A header that declares more than the file holds. PNG: 13000² with
    the data of 16² is refused as truncated, early (PIL refuses it too):
    it inflates no more than its header needs and is checked before its
    samples are allocated. JPEG: libjpeg zero-fills what the data does not
    reach (gray below the last decoded MCU) and PIL returns that image;
    so does the decoder, byte-equal, here at 600² (the decode of a
    13000² fill takes the decoder minutes where PIL's C takes a second)."""
    if kind == "png":
        with pytest.raises(ValueError, match="truncated"):
            decode_upload(_declared(kind, 13000))
        return
    data = _declared(kind, 600)
    got = decode_upload(data)
    assert got.shape == (600, 600, 3) and np.array_equal(got, pil_rgb(data))
    assert (got[100:] == 128).all()


# --- load_rgb: the decoder by the file's content --------------------------------

def test_load_rgb_sniffs_content_not_suffix(tmp_path):
    """The decoder follows the bytes, not the name, as PIL does:
    byte-equal to PIL whatever the suffix."""
    img = photo(20, 24)
    jpg, png = pil_jpeg(img, quality=90), encode_png(img)
    for name, data in (("a.png", jpg), ("b.jpg", png), ("c.upload", jpg)):
        (tmp_path / name).write_bytes(data)
        rgb, transform, crs = load_rgb(tmp_path / name)
        assert transform is None and crs is None
        assert np.array_equal(rgb, pil_rgb(data)) and rgb.flags.c_contiguous


@pytest.mark.parametrize("fmt, data", [
    ("GIF", b"GIF89a\x01\x00\x01\x00"), ("BMP", b"BM\x00\x00\x00\x00"),
    ("WebP", b"RIFF\x00\x00\x00\x00WEBPVP8 "),
    ("TIFF", b"II*\x00\x08\x00\x00\x00")])
def test_load_rgb_refuses_other_formats_by_name(tmp_path, fmt, data):
    """GIF, BMP, WebP and TIFF are decoded since these decoders landed
    (``test_torch_decode_formats.py``); these headers with nothing after
    them PIL refuses, and so does ``load_rgb``."""
    (tmp_path / "up.png").write_bytes(data)
    with pytest.raises(Exception):
        Image.open(tmp_path / "up.png").convert("RGB")
    with pytest.raises(ValueError):
        load_rgb(tmp_path / "up.png")


def test_load_rgb_unknown_bytes(tmp_path):
    """Bytes of no image format: PIL's "cannot identify image file"."""
    (tmp_path / "up.png").write_bytes(b"this is not an image")
    with pytest.raises(ValueError, match="cannot identify image file"):
        load_rgb(tmp_path / "up.png")


# --- the committed fixtures ---------------------------------------------------

def test_committed_fixtures_decode_to_pils_bytes():
    """Each committed fixture (≤ 64 px; the larger timing JPEG is checked
    on the card) decodes to the bytes whose SHA-256 PIL gave when it was
    committed, and PIL still gives them."""
    manifest = json.loads((FIXTURES / "fixtures.json").read_text())
    assert len(manifest) >= 6
    for name, rec in manifest.items():
        data = (FIXTURES / name).read_bytes()
        if max(rec["shape"][:2]) > 64:
            continue
        want = pil_rgb(data)
        assert list(want.shape) == rec["shape"]
        assert hashlib.sha256(want.tobytes()).hexdigest() == rec["sha256"]
        got = decode_upload(data)
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"], name
