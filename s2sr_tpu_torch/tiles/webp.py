"""WebP decoder in Python and numpy that gives PIL's RGB bytes exactly.

PIL opens every WebP through libwebp's ``WebPAnimDecoder`` into
non-premultiplied RGBA, and ``convert("RGB")`` drops the alpha; so the
alpha plane (``ALPH``) never reaches the RGB bytes and is not decoded
here. The container: ``VP8 `` (lossy), ``VP8L`` (lossless) or ``VP8X``
with either inside, or the first ``ANMF`` frame of an animation, drawn
at its offset on a canvas of zeros (the first frame is never blended).

- **VP8L** (the WebP lossless bitstream): prefix codes (simple and
  normal, with their code-length codes), meta prefix codes, LZ77 with
  the 120-entry distance map, the colour cache, and the four
  transforms: predictor (14 modes), cross-colour, subtract-green and
  colour indexing with pixel bundling.
- **VP8** (RFC 6386, as libwebp decodes it): the boolean decoder, the
  frame header (segments, filter, partitions, quantizers, token
  probability updates), intra modes (16×16, 4×4 with its contexts,
  chroma), the coefficient tokens, dequantisation with libwebp's Y2
  rules, the WHT and ``TransformOne`` IDCT, the 16×16/8×8/4×4
  predictors with libwebp's edge values (127 above, 129 left), the
  simple and normal loop filters in macroblock order, then libwebp's
  "fancy" upsampler (``UpsampleRgbLinePair``'s 9-3-3-1 chroma filter)
  and its 14-bit ``VP8YUVToR/G/B``.

The boolean decoder and the token loop are per symbol in Python; the
inverse transforms run over all blocks at once in numpy; prediction and
the loop filter go macroblock by macroblock. Whatever libwebp rejects
raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from . import _webp_tables as T
from .png import check_image_size


# --- the container ---------------------------------------------------------

def _chunks(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size:
            raise ValueError("WebP chunk is truncated")
        yield tag, body
        pos += 8 + size + (size & 1)


def decode_webp(data: bytes) -> np.ndarray:
    """Decode a WebP (its first frame) → (H, W, 3) uint8: the bytes of
    PIL's ``Image.open(...).convert("RGB")``."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or len(data) < 20:
        raise ValueError("not a WebP file")
    (riff,) = struct.unpack_from("<I", data, 4)
    end = min(len(data), 8 + riff)
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("WebP file has no chunk")
    tag, body = chunks[0]
    if tag == b"VP8 ":
        return _vp8(body)
    if tag == b"VP8L":
        return _vp8l(body)
    if tag != b"VP8X" or len(body) < 10:
        raise ValueError(f"WebP chunk {tag!r} is not an image")
    cw = 1 + int.from_bytes(body[4:7], "little")
    ch = 1 + int.from_bytes(body[7:10], "little")
    check_image_size(cw, ch)
    for tag, body in chunks[1:]:
        if tag == b"VP8 ":
            return _fit(_vp8(body), cw, ch, 0, 0)
        if tag == b"VP8L":
            return _fit(_vp8l(body), cw, ch, 0, 0)
        if tag == b"ANMF":
            x0 = 2 * int.from_bytes(body[0:3], "little")
            y0 = 2 * int.from_bytes(body[3:6], "little")
            for sub, sbody in _chunks(body, 16, len(body)):
                if sub == b"VP8 ":
                    return _fit(_vp8(sbody), cw, ch, x0, y0)
                if sub == b"VP8L":
                    return _fit(_vp8l(sbody), cw, ch, x0, y0)
            raise ValueError("WebP animation frame has no image")
    raise ValueError("WebP file has no image")


def _fit(img: np.ndarray, cw: int, ch: int, x0: int, y0: int) -> np.ndarray:
    """A frame drawn on the canvas (zeros elsewhere)."""
    h, w = img.shape[:2]
    if (h, w) == (ch, cw) and x0 == y0 == 0:
        return img
    if x0 + w > cw or y0 + h > ch:
        raise ValueError("WebP frame lies outside its canvas")
    out = np.zeros((ch, cw, 3), np.uint8)
    out[y0:y0 + h, x0:x0 + w] = img
    return out


# --- VP8L ------------------------------------------------------------------

class _LBits:
    """LSB-first bit reader over the VP8L stream; past its end it reads
    zeros (``nbits`` is the real length)."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(8)
        self.nbits = 8 * len(data)
        self.pos = 0

    def peek(self) -> int:
        """At least 57 bits from the position, the next one lowest."""
        p = self.pos
        b = p >> 3
        return int.from_bytes(self.data[b:b + 8], "little") >> (p & 7)

    def read(self, n: int) -> int:
        v = self.peek() & ((1 << n) - 1)
        self.pos += n
        return v


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)


def _build(lengths: list):
    """Canonical prefix code of ``lengths`` → (table over the next ``bits``
    stream bits → (symbol, length), bits); one used symbol is a code of
    zero bits."""
    used = [s for s, n in enumerate(lengths) if n]
    if not used:
        raise ValueError("VP8L prefix code has no symbol")
    if len(used) == 1:
        return [(used[0], 0)], 0
    maxlen = max(lengths)
    counts = [0] * (maxlen + 1)
    for n in lengths:
        if n:
            counts[n] += 1
    code, nxt = 0, [0] * (maxlen + 2)
    for n in range(1, maxlen + 1):
        code = (code + counts[n - 1]) << 1
        nxt[n] = code
    if sum(counts[n] << (maxlen - n) for n in range(1, maxlen + 1)) != 1 << maxlen:
        raise ValueError("VP8L prefix code is incomplete")
    table = [None] * (1 << maxlen)
    for s, n in enumerate(lengths):
        if not n:
            continue
        c = nxt[n]
        nxt[n] += 1
        rev = int(f"{c:0{n}b}"[::-1], 2)
        for k in range(rev, 1 << maxlen, 1 << n):
            table[k] = (s, n)
    return table, maxlen


def _read_code(br: _LBits, alphabet: int):
    if br.read(1):                                   # simple code
        num = br.read(1) + 1
        lengths = [0] * alphabet
        s0 = br.read(8 if br.read(1) else 1)
        if s0 >= alphabet:
            raise ValueError("VP8L simple code symbol out of range")
        lengths[s0] = 1
        if num == 2:
            s1 = br.read(8)
            if s1 >= alphabet:
                raise ValueError("VP8L simple code symbol out of range")
            lengths[s1] = 1
        return _build(lengths)
    ncodes = br.read(4) + 4
    cl = [0] * 19
    for i in range(ncodes):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    table, bits = _build(cl)
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > alphabet:
            raise ValueError("VP8L code-length count out of range")
    else:
        max_symbol = alphabet
    lengths = [0] * alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        s, n = table[br.peek() & ((1 << bits) - 1)] if bits else table[0]
        br.pos += n
        if s < 16:
            lengths[sym] = s
            sym += 1
            if s:
                prev = s
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[s - 16]
            repeat = br.read(extra) + offset
            if sym + repeat > alphabet:
                raise ValueError("VP8L code lengths overflow the alphabet")
            v = prev if s == 16 else 0
            lengths[sym:sym + repeat] = [v] * repeat
            sym += repeat
    return _build(lengths)


def _prefix_length(br: _LBits, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _decode_stream(br: _LBits, xsize: int, ysize: int, level0: bool) -> list:
    """One entropy-coded image (the main image or a transform's
    sub-image) → its ARGB pixels as a flat list."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("VP8L colour cache size out of range")
    meta = None
    hbits = 0
    if level0 and br.read(1):
        hbits = br.read(3) + 2
        hx = -(-xsize // (1 << hbits))
        hy = -(-ysize // (1 << hbits))
        meta_img = _decode_stream(br, hx, hy, False)
        meta = [(p >> 8) & 0xFFFF for p in meta_img]
        ngroups = max(meta) + 1
    else:
        ngroups = 1
    cache_size = 1 << cache_bits if cache_bits else 0
    groups = []
    for _ in range(ngroups):
        groups.append([_read_code(br, 256 + 24 + cache_size),
                       _read_code(br, 256), _read_code(br, 256),
                       _read_code(br, 256), _read_code(br, 40)])
    n = xsize * ysize
    out = [0] * n
    cache = [0] * cache_size
    shift = 32 - cache_bits
    hxsize = -(-xsize // (1 << hbits)) if meta is not None else 0
    i = col = row = 0
    cached = 0                  # pixels up to here are in the colour cache

    def sym(code):
        table, bits = code
        if not bits:
            return table[0][0]
        s, ln = table[br.peek() & ((1 << bits) - 1)]
        br.pos += ln
        return s

    group = groups[0]
    while i < n:
        if meta is not None:
            group = groups[meta[(row >> hbits) * hxsize + (col >> hbits)]]
        g = sym(group[0])
        if g < 256:
            r = sym(group[1])
            b = sym(group[2])
            a = sym(group[3])
            out[i] = (a << 24) | (r << 16) | (g << 8) | b
            i += 1
            col += 1
        elif g < 280:
            length = _prefix_length(br, g - 256)
            code = _prefix_length(br, sym(group[4]))
            if code > 120:
                dist = code - 120
            else:
                dc = T.CODE_TO_PLANE[code - 1]
                dist = max(1, (dc >> 4) * xsize + 8 - (dc & 15))
            if dist > i or i + length > n:
                raise ValueError("VP8L backward reference out of range")
            for k in range(i, i + length):
                out[k] = out[k - dist]
            i += length
            col += length
        else:
            idx = g - 280
            if idx >= cache_size:
                raise ValueError("VP8L colour cache index out of range")
            while cached < i:
                p = out[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
            out[i] = cache[idx]
            i += 1
            col += 1
        while col >= xsize:
            col -= xsize
            row += 1
        if cache_size and i - cached > 0 and g < 280:
            while cached < i:
                p = out[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
        if br.pos > br.nbits:
            raise ValueError("VP8L data is truncated")
    return out


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(p):
    return ((p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255)


def _select(L, Tp, TL):
    pl = sum(abs(t - tl) for t, tl in zip(_channels(Tp), _channels(TL)))
    pt = sum(abs(l - tl) for l, tl in zip(_channels(L), _channels(TL)))
    return L if pl < pt else Tp


def _clamp_full(a, b, c):
    out = 0
    for sh in (24, 16, 8, 0):
        v = ((a >> sh) & 255) + ((b >> sh) & 255) - ((c >> sh) & 255)
        out |= min(255, max(0, v)) << sh
    return out


def _clamp_half(a, b):
    out = 0
    for sh in (24, 16, 8, 0):
        x, y = (a >> sh) & 255, (b >> sh) & 255
        d = x - y
        v = x + (d // 2 if d >= 0 else -((-d) // 2))
        out |= min(255, max(0, v)) << sh
    return out


def _predict(mode, L, Tp, TR, TL):
    if mode == 1:
        return L
    if mode == 2:
        return Tp
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg2(_avg2(L, TR), Tp)
    if mode == 6:
        return _avg2(L, TL)
    if mode == 7:
        return _avg2(L, Tp)
    if mode == 8:
        return _avg2(TL, Tp)
    if mode == 9:
        return _avg2(Tp, TR)
    if mode == 10:
        return _avg2(_avg2(L, TL), _avg2(Tp, TR))
    if mode == 11:
        return _select(L, Tp, TL)
    if mode == 12:
        return _clamp_full(L, Tp, TL)
    if mode == 13:
        return _clamp_half(_avg2(L, Tp), TL)
    return 0xFF000000


def _add(a, b):
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _inverse_predictor(px: list, w: int, h: int, bits: int, modes: list) -> None:
    bw = -(-w // (1 << bits))
    for y in range(h):
        row = y * w
        for x in range(w):
            i = row + x
            if y == 0:
                pred = 0xFF000000 if x == 0 else px[i - 1]
            elif x == 0:
                pred = px[i - w]
            else:
                mode = (modes[(y >> bits) * bw + (x >> bits)] >> 8) & 15
                # TR of the last column: the first pixel of this row
                pred = _predict(mode, px[i - 1], px[i - w], px[i - w + 1],
                                px[i - w - 1])
            px[i] = _add(px[i], pred)


def _vp8l(data: bytes) -> np.ndarray:
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("not a VP8L bitstream")
    br = _LBits(data[1:])
    w = br.read(14) + 1
    h = br.read(14) + 1
    br.read(1)                                     # alpha_is_used
    if br.read(3) != 0:
        raise ValueError("VP8L version is not 0")
    check_image_size(w, h)
    transforms = []
    xsize = w
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("VP8L transform repeated")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _decode_stream(br, -(-xsize // (1 << bits)),
                                 -(-h // (1 << bits)), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 2:
            transforms.append((2, 0, None, xsize))
        else:
            ncolors = br.read(8) + 1
            bits = 0 if ncolors > 16 else 1 if ncolors > 4 else 2 if ncolors > 2 else 3
            cmap = _decode_stream(br, ncolors, 1, False)
            for k in range(1, ncolors):
                cmap[k] = _add(cmap[k], cmap[k - 1])
            transforms.append((3, bits, cmap, xsize))
            xsize = -(-xsize // (1 << bits))
    px = _decode_stream(br, xsize, h, True)
    for kind, bits, sub, tw in reversed(transforms):
        if kind == 0:
            _inverse_predictor(px, tw, h, bits, sub)
        elif kind == 1:
            a = np.asarray(px, np.uint32).reshape(h, tw)
            bw = -(-tw // (1 << bits))
            m = np.asarray(sub, np.uint32).reshape(-1, bw)
            m = m[np.arange(h)[:, None] >> bits, np.arange(tw)[None, :] >> bits]
            g2r = (m & 255).astype(np.uint8).view(np.int8).astype(np.int32)
            g2b = ((m >> 8) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
            r2b = ((m >> 16) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
            green = ((a >> 8) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
            red = ((a >> 16) & 255).astype(np.int32)
            blue = (a & 255).astype(np.int32)
            red = (red + ((g2r * green) >> 5)) & 255
            sred = red.astype(np.uint8).view(np.int8).astype(np.int32)
            blue = (blue + ((g2b * green) >> 5) + ((r2b * sred) >> 5)) & 255
            a = (a & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)
            px = a.reshape(-1).tolist()
        elif kind == 2:
            a = np.asarray(px, np.uint32)
            g = (a >> 8) & 255
            rb = ((a & 0x00FF00FF) + ((g << 16) | g)) & 0x00FF00FF
            px = ((a & 0xFF00FF00) | rb).tolist()
        else:
            size = 1 << (8 >> bits) if bits else 256
            cmap = np.zeros(max(size, 256), np.uint32)
            cmap[:min(len(sub), 256)] = sub[:256]
            packed = np.asarray(px, np.uint32).reshape(h, -1)
            idx = (packed >> 8) & 255
            if bits:
                per = 1 << bits
                width = 8 >> bits
                shifts = (np.arange(per, dtype=np.uint32) * width)
                idx = ((idx[:, :, None] >> shifts) & ((1 << width) - 1))
                idx = idx.reshape(h, -1)[:, :tw]
            px = cmap[idx].reshape(-1).tolist()
    a = np.asarray(px, np.uint32).reshape(h, w)
    rgb = np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255], -1)
    return rgb.astype(np.uint8)


# --- VP8: boolean decoder ----------------------------------------------------

_NORM = [0] + [7 - k.bit_length() + 1 for k in range(1, 256)]


class _Bool:
    """RFC 6386's boolean decoder, reading zeros past its data; ``eof``
    is set when it needed a byte it did not have (libwebp's flag)."""

    __slots__ = ("data", "pos", "value", "range", "bits", "eof")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.value = 0
        self.range = 255
        self.bits = -8
        self.eof = False

    def _load(self):
        d = self.data[self.pos:self.pos + 7]
        self.pos += len(d)
        if len(d) < 7:
            if not d:
                if self.eof:
                    self.value <<= 8
                    self.bits += 8
                    return
                self.eof = True
            d = d + bytes(7 - len(d))
        self.value = (self.value << 56) | int.from_bytes(d, "big")
        self.bits += 56

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = (((self.range - 1) * prob) >> 8) + 1
        bigsplit = split << self.bits
        if self.value >= bigsplit:
            self.range -= split
            self.value -= bigsplit
            b = 1
        else:
            self.range = split
            b = 0
        s = _NORM[self.range]
        self.range <<= s
        self.bits -= s
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


# --- VP8: frame header, modes and tokens ------------------------------------

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# kYModesIntra4: the 4×4 mode tree (leaves are −mode)
_YMODES4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_B_DC, _B_TM, _B_VE, _B_HE = 0, 1, 2, 3        # also DC, TM, V, H of 16×16


def _clip(v: int, hi: int) -> int:
    return 0 if v < 0 else hi if v > hi else v


def _large(br: _Bool, P: list, p: int) -> int:
    bit = br.bit
    if not bit(P[p + 3]):
        if not bit(P[p + 4]):
            return 2
        return 3 + bit(P[p + 5])
    if not bit(P[p + 6]):
        if not bit(P[p + 7]):
            return 5 + bit(159)
        v = 7 + 2 * bit(165)
        return v + bit(145)
    bit1 = bit(P[p + 8])
    bit0 = bit(P[p + 9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for pr in _CAT[cat]:
        v = v + v + bit(pr)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, P: list, t: int, ctx: int, dc: int, ac: int, n: int,
            out: list, base: int) -> int:
    """libwebp's ``GetCoeffs``: tokens of one 4×4 block from position
    ``n`` (type ``t``, context ``ctx``) dequantised into ``out`` in natural
    order; → the position after the last nonzero (16 when it ran out).
    The boolean decoder's step is written out inline (the decoder's hot
    loop); its state goes back to ``br`` around the rarer large values."""
    value, rng, bits = br.value, br.range, br.bits
    norm = _NORM
    tb = t * 264
    p = tb + _BANDS[n] * 33 + ctx * 11
    while n < 16:
        # end of block?
        if bits < 0:
            br.value, br.bits = value, bits
            br._load()
            value, bits = br.value, br.bits
        split = (((rng - 1) * P[p]) >> 8) + 1
        big = split << bits
        if value >= big:
            rng -= split
            value -= big
            sh = norm[rng]
            rng <<= sh
            bits -= sh
        else:
            sh = norm[split]
            rng = split << sh
            bits -= sh
            br.value, br.range, br.bits = value, rng, bits
            return n
        while True:                                  # zeros
            if bits < 0:
                br.value, br.bits = value, bits
                br._load()
                value, bits = br.value, br.bits
            split = (((rng - 1) * P[p + 1]) >> 8) + 1
            big = split << bits
            if value >= big:
                rng -= split
                value -= big
                sh = norm[rng]
                rng <<= sh
                bits -= sh
                break
            sh = norm[split]
            rng = split << sh
            bits -= sh
            n += 1
            if n == 16:
                br.value, br.range, br.bits = value, rng, bits
                return 16
            p = tb + _BANDS[n] * 33
        if bits < 0:
            br.value, br.bits = value, bits
            br._load()
            value, bits = br.value, br.bits
        split = (((rng - 1) * P[p + 2]) >> 8) + 1
        big = split << bits
        if value >= big:
            rng -= split
            value -= big
            sh = norm[rng]
            rng <<= sh
            bits -= sh
            br.value, br.range, br.bits = value, rng, bits
            v, nctx = _large(br, P, p), 2
            value, rng, bits = br.value, br.range, br.bits
        else:
            sh = norm[split]
            rng = split << sh
            bits -= sh
            v, nctx = 1, 1
        # the sign, at probability one half
        if bits < 0:
            br.value, br.bits = value, bits
            br._load()
            value, bits = br.value, br.bits
        split = ((rng - 1) >> 1) + 1
        big = split << bits
        if value >= big:
            rng -= split
            value -= big
            v = -v
            sh = norm[rng]
            rng <<= sh
        else:
            sh = norm[split]
            rng = split << sh
        bits -= sh
        out[base + _ZIGZAG[n]] = v * (ac if n else dc)
        n += 1
        p = tb + _BANDS[n] * 33 + nctx * 11
    br.value, br.range, br.bits = value, rng, bits
    return 16


def _nz_code(nz: int, dc_nz: bool) -> int:
    return 3 if nz > 3 else 2 if nz > 1 else int(dc_nz)


def _wht(dc: list) -> list:
    """``TransformWHT``: the 16 Y2 values → the 16 luma DCs."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[4 * i] = (a0 + a1) >> 3
        out[4 * i + 1] = (a3 + a2) >> 3
        out[4 * i + 2] = (a0 - a1) >> 3
        out[4 * i + 3] = (a3 - a2) >> 3
    return out


def _idct_residuals(coef: np.ndarray) -> np.ndarray:
    """``TransformOne`` over (..., 16) natural-order coefficients →
    (..., 4, 4) residuals (the ``>> 3`` values it adds before the clip)."""
    c = coef.astype(np.int64).reshape(coef.shape[:-1] + (4, 4))

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b = i0 + i2, i0 - i2
    cc = mul2(i1) - mul1(i3)
    d = mul1(i1) + mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], -2)   # [row out][col]
    # horizontal pass: output row k from the column results' row k
    t0, t1, t2, t3 = t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3]
    dc = t0 + 4
    a, b = dc + t2, dc - t2
    cc = mul2(t1) - mul1(t3)
    d = mul1(t1) + mul2(t3)
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3


class _Frame:
    """Everything parsed from the frame header."""


def _header(data: bytes) -> _Frame:
    if len(data) < 10:
        raise ValueError("VP8 frame is truncated")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError("VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError("VP8 profile is out of range")
    if not (bits >> 4) & 1:
        raise ValueError("VP8 frame is not shown")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8 start code is missing")
    width = (data[6] | (data[7] << 8)) & 0x3FFF
    height = (data[8] | (data[9] << 8)) & 0x3FFF
    if not width or not height:
        raise ValueError("VP8 frame has no pixels")
    check_image_size(width, height)
    buf = data[10:]
    if part0 > len(buf):
        raise ValueError("VP8 first partition is truncated")
    f = _Frame()
    f.width, f.height = width, height
    br = _Bool(buf[:part0])
    br.bit(128)                                   # colour space
    br.bit(128)                                   # clamping type
    f.use_segment = br.bit(128)
    f.update_map = 0
    abs_delta, quant, fstr = 1, [0] * 4, [0] * 4
    f.seg_probs = [255, 255, 255]
    if f.use_segment:
        f.update_map = br.bit(128)
        if br.bit(128):
            abs_delta = br.bit(128)
            quant = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            fstr = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if f.update_map:
            f.seg_probs = [br.literal(8) if br.bit(128) else 255
                           for _ in range(3)]
    simple = br.bit(128)
    level = br.literal(6)
    sharpness = br.literal(3)
    ref_lf, mode_lf = [0] * 4, [0] * 4
    if br.bit(128) and br.bit(128):
        for i in range(4):
            if br.bit(128):
                ref_lf[i] = br.signed(6)
        for i in range(4):
            if br.bit(128):
                mode_lf[i] = br.signed(6)
    f.filter_type = 0 if level == 0 else 1 if simple else 2
    # partitions
    nparts = 1 << br.literal(2)
    rest = buf[part0:]
    if len(rest) < 3 * (nparts - 1):
        raise ValueError("VP8 partition sizes are truncated")
    start, left = 3 * (nparts - 1), len(rest) - 3 * (nparts - 1)
    f.parts = []
    for k in range(nparts - 1):
        size = min(int.from_bytes(rest[3 * k:3 * k + 3], "little"), left)
        f.parts.append(_Bool(rest[start:start + size]))
        start += size
        left -= size
    f.parts.append(_Bool(rest[start:]))
    # quantizers
    base_q0 = br.literal(7)
    dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
    f.dq = []
    for s in range(4):
        if f.use_segment:
            q = quant[s] + (0 if abs_delta else base_q0)
        else:
            q = base_q0
        y2ac = (T.AC_TABLE[_clip(q + dq[2], 127)] * 101581) >> 16
        f.dq.append((
            (T.DC_TABLE[_clip(q + dq[0], 127)], T.AC_TABLE[_clip(q, 127)]),
            (T.DC_TABLE[_clip(q + dq[1], 127)] * 2, max(8, y2ac)),
            (T.DC_TABLE[_clip(q + dq[3], 117)], T.AC_TABLE[_clip(q + dq[4], 127)])))
    br.bit(128)                                   # refresh entropy probs
    P = list(T.COEFFS_PROBA0)
    upd = T.COEFFS_UPDATE_PROBA
    for i in range(len(P)):
        if br.bit(upd[i]):
            P[i] = br.literal(8)
    f.P = P
    f.use_skip = br.bit(128)
    f.skip_p = br.literal(8) if f.use_skip else 0
    # loop filter strengths per segment and (i16, i4)
    f.fstrength = []
    for s in range(4):
        if f.use_segment:
            base = fstr[s] + (0 if abs_delta else level)
        else:
            base = level
        row = []
        for i4 in (0, 1):
            lv = base + ref_lf[0] + (mode_lf[0] if i4 else 0)
            lv = _clip(lv, 63)
            if lv > 0 and f.filter_type:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                row.append((2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0))
            else:
                row.append((0, 0, 0))
        f.fstrength.append(row)
    f.br = br
    return f


def _parse(f: _Frame):
    """Modes and coefficients of every macroblock, in raster order."""
    mbw, mbh = (f.width + 15) >> 4, (f.height + 15) >> 4
    n = mbw * mbh
    coef = [0] * (n * 384)
    modes = []                       # (is_i4, imodes, uvmode, segment)
    filt = []                        # (limit, ilevel, hev, inner)
    br, P = f.br, f.P
    bit = br.bit
    intra_t = [0] * (4 * mbw)
    top_nz = [0] * mbw
    top_nz_dc = [0] * mbw
    nparts = len(f.parts)
    for mby in range(mbh):
        intra_l = [0] * 4
        left_nz = left_nz_dc = 0
        tok = f.parts[mby & (nparts - 1)]
        for mbx in range(mbw):
            # intra modes (first partition)
            if f.update_map:
                sp = f.seg_probs
                seg = bit(sp[1]) if not bit(sp[0]) else 2 + bit(sp[2])
            else:
                seg = 0
            skip = bit(f.skip_p) if f.use_skip else 0
            is_i4 = not bit(145)
            if not is_i4:
                if bit(156):
                    ymode = _B_TM if bit(128) else _B_HE
                else:
                    ymode = _B_VE if bit(163) else _B_DC
                imodes = [ymode]
                intra_t[4 * mbx:4 * mbx + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                imodes = []
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = T.BMODES_PROBA[(intra_t[4 * mbx + x] * 10 + ym) * 9:]
                        i = _YMODES4[bit(prob[0])]
                        while i > 0:
                            i = _YMODES4[2 * i + bit(prob[i])]
                        ym = -i
                        intra_t[4 * mbx + x] = ym
                        imodes.append(ym)
                    intra_l[y] = ym
            if not bit(142):
                uvmode = _B_DC
            elif not bit(114):
                uvmode = _B_VE
            else:
                uvmode = _B_TM if bit(183) else _B_HE
            modes.append((is_i4, imodes, uvmode, seg))
            # residuals (token partition)
            m = mby * mbw + mbx
            base = m * 384
            (y1dc, y1ac), (y2dc, y2ac), (uvdc, uvac) = f.dq[seg]
            non_zero_y = non_zero_uv = 0
            if not skip:
                if not is_i4:
                    dc = [0] * 16
                    ctx = top_nz_dc[mbx] + left_nz_dc
                    nz = _coeffs(tok, P, 1, ctx, y2dc, y2ac, 0, dc, 0)
                    top_nz_dc[mbx] = left_nz_dc = int(nz > 0)
                    if nz > 1:
                        dcs = _wht(dc)
                    else:
                        dcs = [(dc[0] + 3) >> 3] * 16
                    for k in range(16):
                        coef[base + 16 * k] = dcs[k]
                    first, t = 1, 0
                else:
                    first, t = 0, 3
                tnz = top_nz[mbx] & 0x0F
                lnz = left_nz & 0x0F
                for y in range(4):
                    ln = lnz & 1
                    nzc = 0
                    for x in range(4):
                        ctx = ln + (tnz & 1)
                        off = base + 16 * (4 * y + x)
                        nz = _coeffs(tok, P, t, ctx, y1dc, y1ac, first, coef, off)
                        ln = int(nz > first)
                        tnz = (tnz >> 1) | (ln << 7)
                        nzc = (nzc << 2) | _nz_code(nz, coef[off] != 0)
                    tnz >>= 4
                    lnz = (lnz >> 1) | (ln << 7)
                    non_zero_y = (non_zero_y << 8) | nzc
                out_t, out_l = tnz, lnz >> 4
                for ch in (0, 2):
                    nzc = 0
                    tnz = top_nz[mbx] >> (4 + ch)
                    lnz = left_nz >> (4 + ch)
                    for y in range(2):
                        ln = lnz & 1
                        for x in range(2):
                            ctx = ln + (tnz & 1)
                            off = base + 256 + 32 * ch + 16 * (2 * y + x)
                            nz = _coeffs(tok, P, 2, ctx, uvdc, uvac, 0, coef, off)
                            ln = int(nz > 0)
                            tnz = (tnz >> 1) | (ln << 3)
                            nzc = (nzc << 2) | _nz_code(nz, coef[off] != 0)
                        tnz >>= 2
                        lnz = (lnz >> 1) | (ln << 5)
                    non_zero_uv |= nzc << (4 * ch)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lnz & 0xF0) << ch
                top_nz[mbx], left_nz = out_t, out_l
                skip = not (non_zero_y | non_zero_uv)
            else:
                top_nz[mbx] = left_nz = 0
                if not is_i4:
                    top_nz_dc[mbx] = left_nz_dc = 0
            limit, il, hev = f.fstrength[seg][int(is_i4)]
            filt.append((limit, il, hev, is_i4 or not skip))
            if tok.eof:
                raise ValueError("VP8 data is truncated (premature end of "
                                 "a partition)")
    return mbw, mbh, np.asarray(coef, np.int64).reshape(n, 24, 16), modes, filt


# --- VP8: prediction and reconstruction ------------------------------------

def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2i(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list, x: int) -> list:
    """One 4×4 luma prediction (libwebp's ``VP8PredLuma4``): ``top`` the
    8 samples above (4 above-right), ``left`` the 4 to the left, ``x`` the
    corner; → 16 values, row-major."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = x
    if mode == _B_DC:
        dc = (A + B + C + D + I + J + K + L + 4) >> 3
        return [dc] * 16
    if mode == _B_TM:
        return [min(255, max(0, t + l - X)) for l in left for t in (A, B, C, D)]
    if mode == _B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return row * 4
    if mode == _B_HE:
        r = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        return [v for v in r for _ in range(4)]
    o = [0] * 16

    def put(x_, y_, v):
        o[4 * y_ + x_] = v

    if mode == 4:                                   # RD
        put(0, 3, _avg3(J, K, L))
        v = _avg3(I, J, K); put(1, 3, v); put(0, 2, v)
        v = _avg3(X, I, J); put(2, 3, v); put(1, 2, v); put(0, 1, v)
        v = _avg3(A, X, I); put(3, 3, v); put(2, 2, v); put(1, 1, v); put(0, 0, v)
        v = _avg3(B, A, X); put(3, 2, v); put(2, 1, v); put(1, 0, v)
        v = _avg3(C, B, A); put(3, 1, v); put(2, 0, v)
        put(3, 0, _avg3(D, C, B))
    elif mode == 5:                                 # VR
        v = _avg2i(X, A); put(0, 0, v); put(1, 2, v)
        v = _avg2i(A, B); put(1, 0, v); put(2, 2, v)
        v = _avg2i(B, C); put(2, 0, v); put(3, 2, v)
        put(3, 0, _avg2i(C, D))
        put(0, 3, _avg3(K, J, I))
        put(0, 2, _avg3(J, I, X))
        v = _avg3(I, X, A); put(0, 1, v); put(1, 3, v)
        v = _avg3(X, A, B); put(1, 1, v); put(2, 3, v)
        v = _avg3(A, B, C); put(2, 1, v); put(3, 3, v)
        put(3, 1, _avg3(B, C, D))
    elif mode == 6:                                 # LD
        put(0, 0, _avg3(A, B, C))
        v = _avg3(B, C, D); put(1, 0, v); put(0, 1, v)
        v = _avg3(C, D, E); put(2, 0, v); put(1, 1, v); put(0, 2, v)
        v = _avg3(D, E, F); put(3, 0, v); put(2, 1, v); put(1, 2, v); put(0, 3, v)
        v = _avg3(E, F, G); put(3, 1, v); put(2, 2, v); put(1, 3, v)
        v = _avg3(F, G, H); put(3, 2, v); put(2, 3, v)
        put(3, 3, _avg3(G, H, H))
    elif mode == 7:                                 # VL
        put(0, 0, _avg2i(A, B))
        v = _avg2i(B, C); put(1, 0, v); put(0, 2, v)
        v = _avg2i(C, D); put(2, 0, v); put(1, 2, v)
        v = _avg2i(D, E); put(3, 0, v); put(2, 2, v)
        put(0, 1, _avg3(A, B, C))
        v = _avg3(B, C, D); put(1, 1, v); put(0, 3, v)
        v = _avg3(C, D, E); put(2, 1, v); put(1, 3, v)
        v = _avg3(D, E, F); put(3, 1, v); put(2, 3, v)
        put(3, 2, _avg3(E, F, G))
        put(3, 3, _avg3(F, G, H))
    elif mode == 8:                                 # HD
        v = _avg2i(I, X); put(0, 0, v); put(2, 1, v)
        v = _avg2i(J, I); put(0, 1, v); put(2, 2, v)
        v = _avg2i(K, J); put(0, 2, v); put(2, 3, v)
        put(0, 3, _avg2i(L, K))
        put(3, 0, _avg3(A, B, C))
        put(2, 0, _avg3(X, A, B))
        v = _avg3(I, X, A); put(1, 0, v); put(3, 1, v)
        v = _avg3(J, I, X); put(1, 1, v); put(3, 2, v)
        v = _avg3(K, J, I); put(1, 2, v); put(3, 3, v)
        put(1, 3, _avg3(L, K, J))
    elif mode == 9:                                 # HU
        put(0, 0, _avg2i(I, J))
        v = _avg2i(J, K); put(2, 0, v); put(0, 1, v)
        v = _avg2i(K, L); put(2, 1, v); put(0, 2, v)
        put(1, 0, _avg3(I, J, K))
        v = _avg3(J, K, L); put(3, 0, v); put(1, 1, v)
        v = _avg3(K, L, L); put(3, 1, v); put(1, 2, v)
        for x_, y_ in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
            put(x_, y_, L)
    else:
        raise ValueError("VP8 4x4 intra mode out of range")
    return o


def _pred_block(buf: np.ndarray, y: int, x: int, size: int, mode: int,
                mbx: int, mby: int) -> np.ndarray:
    """16×16 luma or 8×8 chroma prediction at buffer position (y, x) (the
    buffer keeps a border row and column: 127 above, 129 to the left),
    with ``CheckMode``'s DC variants at the frame's top and left."""
    top = buf[y - 1, x:x + size].astype(np.int32)
    left = buf[y:y + size, x - 1].astype(np.int32)
    shift = 4 if size == 8 else 5
    if mode == _B_DC:
        if mby and mbx:
            dc = (int(top.sum()) + int(left.sum()) + size) >> shift
        elif mbx:                                  # no top
            dc = (int(left.sum()) + size // 2) >> (shift - 1)
        elif mby:                                  # no left
            dc = (int(top.sum()) + size // 2) >> (shift - 1)
        else:
            dc = 128
        return np.full((size, size), dc, np.int32)
    if mode == _B_VE:
        return np.broadcast_to(top, (size, size))
    if mode == _B_HE:
        return np.broadcast_to(left[:, None], (size, size))
    corner = int(buf[y - 1, x - 1])
    return np.clip(top[None, :] + left[:, None] - corner, 0, 255)


def _reconstruct(f: _Frame, mbw: int, mbh: int, coef: np.ndarray, modes: list):
    """The unfiltered Y, U, V planes (macroblock-aligned) with a border
    row above and a border column to the left."""
    res = _idct_residuals(coef)                    # (n, 24, 4, 4)
    H, W = 16 * mbh, 16 * mbw
    Y = np.zeros((H + 1, W + 1 + 4), np.int32)
    U = np.zeros((H // 2 + 1, W // 2 + 1), np.int32)
    V = np.zeros_like(U)
    for p in (Y, U, V):
        p[0, :] = 127
        p[1:, 0] = 129
    for mby in range(mbh):
        for mbx in range(mbw):
            m = mby * mbw + mbx
            is_i4, imodes, uvmode, _ = modes[m]
            y0, x0 = 16 * mby + 1, 16 * mbx + 1
            r = res[m]
            if is_i4:
                if mby == 0:
                    tr = [127] * 4
                elif mbx == mbw - 1:
                    tr = [int(Y[y0 - 1, x0 + 15])] * 4
                else:
                    tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
                # the macroblock and its borders as lists: win[1 + r][1 + c]
                # is pixel (r, c), row 0 the samples above, column 0 left
                win = Y[y0 - 1:y0 + 16, x0 - 1:x0 + 17].tolist()
                rs = r[:16].reshape(16, 16).tolist()
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    ty, lx = 4 * by, 4 * bx
                    above = win[ty]
                    top = above[lx + 1:lx + 5] + (
                        tr if bx == 3 else above[lx + 5:lx + 9])
                    left = [win[ty + 1 + i][lx] for i in range(4)]
                    pred = _pred4(imodes[n], top, left, above[lx])
                    res4 = rs[n]
                    for i in range(4):
                        row = win[ty + 1 + i]
                        for j in range(4):
                            v = pred[4 * i + j] + res4[4 * i + j]
                            row[lx + 1 + j] = 0 if v < 0 else 255 if v > 255 else v
                Y[y0:y0 + 16, x0:x0 + 16] = np.asarray(win[1:], np.int32)[:, 1:17]
            else:
                pred = _pred_block(Y, y0, x0, 16, imodes[0], mbx, mby)
                rr = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + rr, 0, 255)
            cy, cx = 8 * mby + 1, 8 * mbx + 1
            for plane, k in ((U, 16), (V, 20)):
                pred = _pred_block(plane, cy, cx, 8, uvmode, mbx, mby)
                rr = r[k:k + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[cy:cy + 8, cx:cx + 8] = np.clip(pred + rr, 0, 255)
    return Y[1:, 1:W + 1], U[1:, 1:], V[1:, 1:]


# --- VP8: loop filter ---------------------------------------------------------

def _sclip1(v):
    return np.clip(v, -128, 127)


def _edge(seg: np.ndarray, thresh, ithresh, hev_t, kind: str) -> np.ndarray:
    """The lines of ``seg`` ((n, 8): p3 p2 p1 p0 q0 q1 q2 q3 per line)
    filtered: ``kind`` "simple", "mb" (6 taps) or "inner" (4);
    ``thresh``, ``ithresh``, ``hev_t`` per line (arrays of n) or scalars.
    Mirrors ``dec.c``'s ``SimpleVFilter16``/``FilterLoop26``/``FilterLoop24``
    per line."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, k] for k in range(8))
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    out = seg.copy()
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    f2p0 = np.clip(p0 + np.clip((a + 3) >> 3, -16, 15), 0, 255)
    f2q0 = np.clip(q0 - np.clip((a + 4) >> 3, -16, 15), 0, 255)
    if kind == "simple":
        out[:, 3] = np.where(need, f2p0, p0)
        out[:, 4] = np.where(need, f2q0, q0)
        return out
    need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
             & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
             & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    if kind == "mb":
        a = _sclip1(a)
        a1 = (27 * a + 63) >> 7
        a2 = (18 * a + 63) >> 7
        a3 = (9 * a + 63) >> 7
        full = (p2 + a3, p1 + a2, p0 + a1, q0 - a1, q1 - a2, q2 - a3)
        cols = (1, 2, 3, 4, 5, 6)
    else:
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        full = (p1 + a3, p0 + a2, q0 - a1, q1 - a3)
        cols = (2, 3, 4, 5)
    soft = need & ~hev
    for c, v in zip(cols, full):
        out[:, c] = np.where(soft, np.clip(v, 0, 255), seg[:, c])
    out[:, 3] = np.where(need & hev, f2p0, out[:, 3])
    out[:, 4] = np.where(need & hev, f2q0, out[:, 4])
    return out


def _loop_filter(f: _Frame, Y, U, V, mbw: int, mbh: int, filt: list) -> None:
    """libwebp's ``DoFilter`` for every macroblock, in an order that keeps
    its raster-order results: macroblock (x, y) reads what (x − 1, y) and
    (x + 1, y − 1) leave and nothing later touches it, so the macroblocks
    of one wavefront x + 2y are independent and each of the eight edge
    steps runs over all of them at once."""
    if not f.filter_type:
        return
    simple = f.filter_type == 1
    prm = np.asarray(filt, np.int64).reshape(mbh, mbw, 4)
    planes = [(Y, 16)] if simple else [(Y, 16), (U, 8), (V, 8)]
    kind_mb, kind_in = ("simple", "simple") if simple else ("mb", "inner")
    for t in range(mbw + 2 * (mbh - 1)):
        ys = np.arange(max(0, (t - mbw + 2) // 2), min(mbh, t // 2 + 1))
        xs = t - 2 * ys
        keep = (xs >= 0) & (xs < mbw) & (prm[ys, np.clip(xs, 0, mbw - 1), 0] > 0)
        ys, xs = ys[keep], xs[keep]
        if not len(ys):
            continue
        limit, il, hev, inner = (prm[ys, xs, k] for k in range(4))
        steps = ((xs > 0, 0, "v", limit + 4, kind_mb),
                 *((inner > 0, k, "v", limit, kind_in) for k in (4, 8, 12)),
                 (ys > 0, 0, "h", limit + 4, kind_mb),
                 *((inner > 0, k, "h", limit, kind_in) for k in (4, 8, 12)))
        for sel, k, orient, thr, kind in steps:
            if not sel.any():
                continue
            for P, n in planes:
                if n == 8 and k not in (0, 4):
                    continue
                kk = k if n == 16 else k and 4
                y0, x0 = ys[sel] * n, xs[sel] * n
                line = np.arange(n)
                tap = np.arange(-4, 4)
                if orient == "v":                  # a vertical edge at x0 + kk
                    r = (y0[:, None, None] + line[None, :, None]).repeat(8, 2)
                    c = (x0[:, None, None] + kk + tap[None, None, :]).repeat(n, 1)
                else:                              # a horizontal edge at y0 + kk
                    r = (y0[:, None, None] + kk + tap[None, None, :]).repeat(n, 1)
                    c = (x0[:, None, None] + line[None, :, None]).repeat(8, 2)
                per = lambda v: np.repeat(v[sel], n)
                seg = P[r, c].reshape(-1, 8)
                P[r, c] = _edge(seg, per(thr), per(il), per(hev),
                                kind).reshape(r.shape)


# --- VP8: fancy upsampling and YUV → RGB --------------------------------------

def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """``UpsampleRgbLinePair``'s chroma for every luma pixel: (h, w) from
    the ((h + 1) / 2, (w + 1) / 2) plane, the 9-3-3-1 filter with
    libwebp's rounding, the first luma row and (for an even height) the
    last from their chroma row doubled, the first column and (for an
    even width) the last from 3:1 vertical weights only."""
    c = c.astype(np.int32)
    ch, cw = c.shape
    yy = np.arange(h)
    near = np.where(yy % 2 == 1, (yy - 1) >> 1, yy >> 1)
    far = np.where(yy == 0, 0, np.where(yy % 2 == 1, (yy + 1) >> 1, (yy >> 1) - 1))
    far = np.minimum(far, ch - 1)
    near = np.minimum(near, ch - 1)
    xx = np.arange(w)
    n_col = np.where(xx % 2 == 1, (xx - 1) >> 1, xx >> 1)
    f_col = np.where(xx % 2 == 1, (xx + 1) >> 1, (xx >> 1) - 1)
    n_col = np.minimum(n_col, cw - 1)
    f_col = np.clip(f_col, 0, cw - 1)
    N, F = c[near], c[far]                        # (h, cw)
    Nn, Nf = N[:, n_col], N[:, f_col]
    Fn, Ff = F[:, n_col], F[:, f_col]
    diag = (Nn + Nf + Fn + Ff + 8 + 2 * (Nf + Fn)) >> 3
    out = (diag + Nn) >> 1
    edge = (3 * Nn + Fn + 2) >> 2
    out[:, 0] = edge[:, 0]
    if w % 2 == 0:
        out[:, w - 1] = edge[:, w - 1]
    return out


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's ``VP8YuvToRgb`` (14-bit fixed point, ``VP8Clip8``)."""
    y = y.astype(np.int64)
    u = u.astype(np.int64)
    v = v.astype(np.int64)

    def mult_hi(a, c):
        return (a * c) >> 8

    def clip8(a):
        return np.where((a & ~16383) == 0, a >> 6, np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _vp8(data: bytes) -> np.ndarray:
    f = _header(data)
    mbw, mbh, coef, modes, filt = _parse(f)
    Y, U, V = _reconstruct(f, mbw, mbh, coef, modes)
    _loop_filter(f, Y, U, V, mbw, mbh, filt)
    h, w = f.height, f.width
    y = Y[:h, :w]
    u = _upsample(U[:(h + 1) // 2, :(w + 1) // 2], h, w)
    v = _upsample(V[:(h + 1) // 2, :(w + 1) // 2], h, w)
    return _yuv_to_rgb(y, u, v)
