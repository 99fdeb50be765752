"""JPEG decoder in numpy that gives PIL's RGB bytes exactly.

The JAX package opens uploads with ``PIL.Image.open(path).convert("RGB")``,
whose JPEG decoder is libjpeg-turbo with its defaults. The card's machine
has no PIL, so the port decodes on the host with the same arithmetic:

- Huffman entropy decoding of sequential (SOF0 baseline, SOF1 extended)
  and progressive (SOF2) 8-bit files, interleaved or not, with restart
  intervals (``jdhuff.c``, ``jdphuff.c``); the only Python loop;
- the accurate integer IDCT (``jidctint.c::jpeg_idct_islow``: CONST_BITS
  13, PASS1_BITS 2, the post-IDCT range-limit table), over all blocks at
  once;
- fancy upsampling (``jdsample.c``: ``h2v1``, ``h1v2``, ``h2v2`` with
  their alternating rounding biases, the edges replicated; box
  replication where libjpeg takes it), over whole planes;
- the fixed-point YCbCr → RGB tables of ``jdcolor.c``, and libjpeg's rule
  for the colour space (JFIF, then the Adobe transform flag, then the
  component ids);
- no EXIF rotation, since ``Image.open`` applies none.

A complete progressive file is output without block smoothing, as
libjpeg does once every coefficient is known. Besides:

- arithmetic coding, sequential and progressive (SOF9, SOF10; the
  QM-coder and models of ``jdarith.c`` in :mod:`.jpeg_arith`);
- lossless files (SOF3, 8-bit): the seven predictors, the point
  transform, restarts per MCU row; H×V samples of a subsampled
  component an MCU, each replicated over its Hmax/H × Vmax/V pixels, as
  libjpeg-turbo upsamples in lossless mode; libjpeg-turbo converts no
  colour there, so PIL refuses a 3-component file that JFIF or an Adobe
  transform marks as YCbCr, and so does this decoder;
- 4-component files: CMYK, or YCCK (Adobe transform 2) converted to
  CMYK as ``jdcolor.c::ycck_cmyk_convert``; PIL reads them inverted
  ("CMYK;I", Adobe's convention) and converts with ``cmyk2rgb``;
- corrupt entropy data as libjpeg recovers from it: a code no table
  holds reads as symbol 0 after 17 bits, DC predictions wrap at 16
  bits, and an MCU that needs bits past its segment's end is decoded
  on zeros while the rest of that restart interval stays zero.

A scan whose data ends without a marker (a truncated file) raises, as
PIL does without ``LOAD_TRUNCATED_IMAGES``; so do hierarchical files,
arithmetic lossless files and samples of other than 8 bits, which PIL
refuses too.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg_arith import decode_scan_arith
from .png import check_image_size

# zigzag index → natural (row-major) index, with libjpeg's 16 spare
# entries so a corrupt run cannot index past the block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16)

# frames PIL's libjpeg-turbo refuses ("broken data stream")
_UNSUPPORTED_SOF = {
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)"}
_FRAMES = {0xC0: "huffman", 0xC1: "huffman", 0xC2: "progressive",
           0xC9: "arith", 0xCA: "arith_progressive", 0xC3: "lossless"}


def _refuse(what: str):
    return ValueError(f"{what} JPEG is not decoded (PIL refuses it too)")


# --- entropy decoding --------------------------------------------------------

def _huff_lut(counts: bytes, symbols: bytes) -> list:
    """A 16-bit lookup table: the next 16 bits of the stream → ``length <<
    8 | symbol`` (canonical codes, JPEG Annex C); a bad code reads as
    symbol 0 after 17 bits, as ``jpeg_huff_decode`` gives up."""
    lut = np.full(1 << 16, 17 << 8, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = length << 8 | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Bits:
    """An entropy-coded segment (stuffing removed) read at bit ``pos``
    through ``win``, the 32 bits that start at each byte; past its end the
    stream reads as zeros, as libjpeg fills it, for ``pad`` bytes (room
    for one MCU); ``nbits`` is the segment's real length."""

    __slots__ = ("win", "pos", "nbits")

    def __init__(self, seg: bytes, pad: int = 8):
        self.nbits = 8 * len(seg)
        b = np.zeros(len(seg) + pad, np.uint64)
        b[:len(seg)] = np.frombuffer(seg, np.uint8)
        self.win = ((b[:-3] << np.uint64(24)) | (b[1:-2] << np.uint64(16))
                    | (b[2:-1] << np.uint64(8)) | b[3:]).tolist()
        self.pos = 0


def _segments(data: bytes, pos: int) -> tuple:
    """The entropy-coded data from ``pos``: its restart segments with
    0xFF00 stuffing removed, and the position of the marker that ends it."""
    segs, cur, i = [], bytearray(), pos
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            cur += data[i:]
            segs.append(bytes(cur))
            return segs, n
        cur += data[i:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            i = j + 2
        elif nxt == 0xFF:            # fill byte before a marker
            i = j + 1
        elif 0xD0 <= nxt <= 0xD7:    # RSTn: the next segment
            segs.append(bytes(cur))
            cur = bytearray()
            i = j + 2
        else:
            segs.append(bytes(cur))
            return segs, j


class _Scan:
    """One scan's decoding state over its restart segments; a missing
    segment reads as an empty one."""

    def __init__(self, segs: list, pad: int):
        self.segs = segs
        self.seg = 0
        self.pad = pad
        self.bits = _Bits(segs[0], pad)

    def restart(self):
        self.seg += 1
        seg = self.segs[self.seg] if self.seg < len(self.segs) else b""
        self.bits = _Bits(seg, self.pad)


def _decode_scan(scan: _Scan, comps: list, blocks: "_McuBlocks", coef: list,
                 mcus: int, restart: int, lut_dc: dict, lut_ac: dict,
                 ss: int, se: int, ah: int, al: int, progressive: bool):
    """Decode one scan into ``coef`` (per component, a flat int16
    memoryview of coefficients in natural order, 64 a block; as fast to
    index from Python as a list, at 2 bytes a coefficient). ``blocks[m]``
    lists the (component slot, block index) of MCU m in order."""
    win, nbits = scan.bits.win, scan.bits.nbits
    pos = 0
    pred = [0] * len(comps)
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    natural = _NATURAL.tolist()
    short = False            # libjpeg's insufficient_data
    for m in range(mcus):
        if restart and m and m % restart == 0:
            scan.restart()
            win, nbits, pos = scan.bits.win, scan.bits.nbits, 0
            pred = [0] * len(comps)
            eobrun = 0
            short = False
        if short:
            continue
        if pos > nbits:
            short = True
            continue
        for slot, blk in blocks[m]:
            c = comps[slot]
            out = coef[c["index"]]
            base = blk * 64
            if not progressive or (ss == 0 and ah == 0):
                # DC: Huffman-coded difference (F.2.2.1 / G.1.2.1)
                e = lut_dc[c["td"]][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += e >> 8
                s = e & 0xFF
                if s:
                    v = (win[pos >> 3] >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v += 1 - (1 << s)
                    s = v
                pred[slot] += s
                v = pred[slot] << al if progressive else pred[slot]
                out[base] = ((v + 0x8000) & 0xFFFF) - 0x8000
                if progressive:
                    continue
                ac = lut_ac[c["ta"]]
                k = 1
                while k < 64:
                    e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    pos += e >> 8
                    rs = e & 0xFF
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        v = (win[pos >> 3] >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                        pos += s
                        if v < 1 << (s - 1):
                            v += 1 - (1 << s)
                        out[base + natural[k]] = v
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            elif ss == 0:
                # DC refinement: one bit
                if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                    out[base] |= p1
                pos += 1
            elif ah == 0:
                # AC first pass (G.1.2.2)
                if eobrun:
                    eobrun -= 1
                    continue
                ac = lut_ac[c["ta"]]
                k = ss
                while k <= se:
                    e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    pos += e >> 8
                    rs = e & 0xFF
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        v = (win[pos >> 3] >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                        pos += s
                        if v < 1 << (s - 1):
                            v += 1 - (1 << s)
                        out[base + natural[k]] = v << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[pos >> 3] >> (32 - r - (pos & 7))) & ((1 << r) - 1)
                            pos += r
                        eobrun -= 1
                        break
                    k += 1
            else:
                # AC refinement (G.1.2.3), as jdphuff.c's decode_mcu_AC_refine
                ac = lut_ac[c["ta"]]
                k = ss
                if eobrun == 0:
                    while k <= se:
                        e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        pos += e >> 8
                        rs = e & 0xFF
                        r, s = rs >> 4, rs & 15
                        if s:
                            bit = (win[pos >> 3] >> (31 - (pos & 7))) & 1
                            pos += 1
                            s = p1 if bit else m1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += (win[pos >> 3] >> (32 - r - (pos & 7))) & ((1 << r) - 1)
                                pos += r
                            break
                        while k <= se:
                            at = base + natural[k]
                            cur = out[at]
                            if cur:
                                if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not cur & p1:
                                    out[at] = cur + (p1 if cur >= 0 else m1)
                                pos += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            out[base + natural[k]] = s
                        k += 1
                if eobrun:
                    while k <= se:
                        at = base + natural[k]
                        cur = out[at]
                        if cur:
                            if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not cur & p1:
                                out[at] = cur + (p1 if cur >= 0 else m1)
                            pos += 1
                        k += 1
                    eobrun -= 1
    scan.bits.pos = pos


# --- IDCT, upsampling, colour -------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
        "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
        "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
        "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _w16(x):
    """Wrap to int16, as a 16-bit SIMD add or multiply keeps its low half."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _idct_1d(v: list, descale: int) -> list:
    """One 8-point pass of ``jpeg_idct_islow`` on int64 arrays ``v[0..7]``
    (the shortcuts for zero AC terms give the same values); outputs
    descaled by ``descale`` bits with rounding. The sums the AVX2 version
    forms in 16 bits (``in0 ± in4``, ``z3``, ``z4``) wrap as there; valid
    data never reaches that range."""
    f = _FIX
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 - z3 * f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = _w16(v[0] + v[4]) << _CONST_BITS
    tmp1 = _w16(v[0] - v[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, _w16(t0 + t2), _w16(t1 + t3)
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (descale - 1)
    return [(x + half) >> descale for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer IDCT as libjpeg-turbo's AVX2 version
    computes it (the one PIL runs on x86-64): (N, 64) natural-order
    coefficients and their 64 quantizers → (N, 8, 8) uint8 samples. The
    dequantized coefficients are 16-bit products, the first pass's
    outputs saturate to 16 bits, and the samples saturate to 0..255 (the
    C version wraps values beyond ±512 first); only corrupt data reaches
    any of these limits."""
    x = _w16(coef.astype(np.int64).reshape(-1, 8, 8)
             * qtable.astype(np.int64).reshape(8, 8))
    # pass 1: columns (along the row index), into the work array
    ws = _idct_1d([x[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.clip(np.stack(ws, axis=1), -0x8000, 0x7FFF)
    # pass 2: rows
    out = _idct_1d([ws[:, :, k] for k in range(8)],
                   _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(out, axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _edge_pad(p: np.ndarray, axis: int) -> np.ndarray:
    """``p`` with its first and last line along ``axis`` repeated once
    outside (libjpeg's context rows; the column special cases)."""
    first = np.take(p, [0], axis=axis)
    last = np.take(p, [-1], axis=axis)
    return np.concatenate([first, p, last], axis=axis)


def _h2v1_fancy(p: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample``: (h, w) → (h, 2w), 3/4 nearer + 1/4 further,
    biases 1 (left output) and 2 (right), edge columns copied."""
    q = _edge_pad(p.astype(np.int32), 1)
    mid = q[:, 1:-1] * 3
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (mid + q[:, :-2] + 1) >> 2
    out[:, 1::2] = (mid + q[:, 2:] + 2) >> 2
    out[:, 0] = p[:, 0]
    out[:, -1] = p[:, -1]
    return out.astype(np.uint8)


def _h1v2_fancy(p: np.ndarray) -> np.ndarray:
    """``h1v2_fancy_upsample``: (h, w) → (2h, w), biases 1 (upper output)
    and 2 (lower); the rows above the first and below the last are those
    rows themselves."""
    q = _edge_pad(p.astype(np.int32), 0)
    mid = q[1:-1] * 3
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    out[0::2] = (mid + q[:-2] + 1) >> 2
    out[1::2] = (mid + q[2:] + 2) >> 2
    return out.astype(np.uint8)


def _h2v2_fancy(p: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample``: (h, w) → (2h, 2w). Column sums 3·near +
    far rows, then 3·this + neighbour column sums with biases 8 (left)
    and 7 (right); the first and last columns use 4·this."""
    q = _edge_pad(p.astype(np.int32), 0)
    h, w = p.shape
    out = np.empty((2 * h, 2 * w), np.int32)
    for v, far in ((0, q[:-2]), (1, q[2:])):
        cs = q[1:-1] * 3 + far                       # (h, w) column sums
        cp = _edge_pad(cs, 1)
        rows = out[v::2]
        rows[:, 0::2] = (cs * 3 + cp[:, :-2] + 8) >> 4
        rows[:, 1::2] = (cs * 3 + cp[:, 2:] + 7) >> 4
        rows[:, 0] = (cs[:, 0] * 4 + 8) >> 4
        rows[:, -1] = (cs[:, -1] * 4 + 7) >> 4
    return out.astype(np.uint8)


def _upsample(p: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """A component plane (downsampled_height, downsampled_width) expanded
    by (vf, hf), as ``jinit_upsampler`` picks the method."""
    if (hf, vf) == (1, 1):
        return p
    w = p.shape[1]
    if (hf, vf) == (2, 1) and w > 2:
        return _h2v1_fancy(p)
    if (hf, vf) == (1, 2):
        return _h1v2_fancy(p)
    if (hf, vf) == (2, 2) and w > 2:
        return _h2v2_fancy(p)
    return np.repeat(np.repeat(p, vf, axis=0), hf, axis=1)


def _ycc_tables():
    scale, half = 16, 1 << 15

    def fix(x):
        return int(x * (1 << scale) + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + half) >> scale
    cb_b = (fix(1.77200) * x + half) >> scale
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
               clip: bool = True) -> np.ndarray:
    """``jdcolor.c::ycc_rgb_convert`` on uint8 planes → (H, W, 3) uint8
    (int64 before the range limit with ``clip=False``)."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    yi = y.astype(np.int64)
    r = yi + cr_r[cr]
    g = yi + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yi + cb_b[cb]
    rgb = np.stack([r, g, b], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8) if clip else rgb


def _output_lossless(frame, planes, jfif, adobe, transform) -> np.ndarray:
    """Lossless samples, shifted back by the point transform and kept as
    8-bit samples, a subsampled component replicated up to full size;
    libjpeg-turbo converts no colour in lossless mode, so a 3-component
    file marked YCbCr is refused, as PIL refuses it."""
    if "lossless_pt" not in frame:
        raise ValueError("JPEG lossless frame has no scan")
    pt = frame["lossless_pt"]
    h, w = frame["height"], frame["width"]
    full = []
    for c, p in zip(frame["comps"], planes):
        a = np.asarray(p, np.int64)[:c["dh"], :c["dw"]]
        a = np.repeat(np.repeat(a, frame["vmax"] // c["v"], 0),
                      frame["hmax"] // c["h"], 1)[:h, :w]
        full.append((a << pt) & 0xFF)
    img = np.stack(full, -1).astype(np.uint8)
    if img.shape[2] == 3 and (jfif or (adobe and transform != 0)):
        raise ValueError("broken data stream: lossless JPEG in YCbCr")
    if img.shape[2] == 4:
        return cmyk_to_rgb(255 - img)
    return img


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's ``Convert.c::cmyk2rgb`` on (H, W, 4) uint8: with nk = 255 − K,
    each channel nk − MULDIV255(C, nk), MULDIV255 rounding as PIL's
    ``((t >> 8) + t) >> 8`` with t = a·b + 128."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# --- the file ---------------------------------------------------------------

def decode_jpeg(data: bytes, colour: str | None = None) -> np.ndarray:
    try:
        return _decode(data, colour)
    except (IndexError, KeyError, struct.error):
        # a header that ends early or names a table or component the file
        # never defines: libjpeg stops with an error, PIL raises
        raise ValueError("broken data stream when reading JPEG") from None


def _decode(data: bytes, colour: str | None = None) -> np.ndarray:
    """Decode a JPEG → (H, W, 3) uint8 RGB, or (H, W, 1) for a grayscale
    file: the bytes PIL's ``Image.open(...).convert("RGB")`` gives (gray
    replicated to RGB there). ``colour`` overrides libjpeg's colour-space
    rule for 3 components: ``"ycc"`` converts, ``"none"`` keeps the
    samples (libtiff's two settings)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    qt: dict = {}
    lut_dc: dict = {}
    lut_ac: dict = {}
    frame = None
    mode = None
    dac: dict = {}
    restart = 0
    jfif = adobe = False
    transform = None
    coef: list = []
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1                  # garbage between segments: skip
            continue
        marker = data[pos + 1] if pos + 1 < n else 0xD9
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD9:
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe, transform = True, seg[11]
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(seg[i + 1:i + 65])
                    i += 65
                table = np.zeros(64, np.int64)
                table[_NATURAL[:64]] = vals
                qt[tq] = table
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                lut = _huff_lut(counts, seg[i + 17:i + 17 + total])
                (lut_ac if tc else lut_dc)[th] = lut
                i += 17 + total
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker in _UNSUPPORTED_SOF:
            raise _refuse(_UNSUPPORTED_SOF[marker])
        elif marker == 0xCC:
            for i in range(0, len(seg) - 1, 2):   # arithmetic conditioning
                tc, tb, cs = seg[i] >> 4, seg[i] & 15, seg[i + 1]
                dac[("ac", tb) if tc else ("dc", tb)] = (
                    cs if tc else (cs & 15, cs >> 4))
        elif marker in _FRAMES:
            mode = _FRAMES[marker]
            frame = _frame(seg, mode)
            if mode == "lossless":
                # one sample a data unit: planes padded to whole MCUs
                ux = -(-frame["width"] // frame["hmax"])
                uy = -(-frame["height"] // frame["vmax"])
                coef = [[[0] * (ux * c["h"]) for _ in range(uy * c["v"])]
                        for c in frame["comps"]]
            else:
                coef = [np.zeros(c["bh"] * c["bw"] * 64, np.int16)
                        for c in frame["comps"]]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            pos = _scan(data, pos, seg, frame, coef, restart, qt, lut_dc,
                        lut_ac, mode, dac)
    if frame is None:
        raise ValueError("JPEG without a frame header")
    if mode == "lossless":
        return _output_lossless(frame, coef, jfif, adobe, transform)
    return _output(frame, coef, jfif, adobe, transform, colour)


def _frame(seg: bytes, mode: str) -> dict:
    precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise _refuse(f"{precision}-bit")
    if nc not in (1, 3, 4):
        raise _refuse(f"{nc}-component")
    if height == 0 or width == 0:
        raise _refuse("DNL-sized")
    check_image_size(width, height)
    comps = []
    for k in range(nc):
        cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq,
                      "index": k})
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        c["dw"] = -(-width * c["h"] // hmax)          # downsampled size
        c["dh"] = -(-height * c["v"] // vmax)
        c["wb"], c["hb"] = -(-c["dw"] // 8), -(-c["dh"] // 8)
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # stored, padded
    if mode == "lossless" and any(hmax % c["h"] or vmax % c["v"]
                                  for c in comps):
        raise ValueError("JPEG lossless with fractional sampling is not "
                         "decoded")
    return {"width": width, "height": height, "comps": comps, "hmax": hmax,
            "vmax": vmax, "mcux": mcux, "mcuy": mcuy, "qt": {},
            "precision": precision}


class _McuBlocks:
    """The (component slot, block index) of each MCU of a scan, in order,
    made per MCU: a list of them all would take hundreds of bytes an MCU
    before a bit of the scan is read."""

    def __init__(self, frame: dict, comps: list):
        if len(comps) == 1:               # non-interleaved: one block an MCU
            c = comps[0]
            self.cols, self.n = c["wb"], c["wb"] * c["hb"]
            self.parts = [(0, c["bw"], 1, 0)]
        else:
            self.cols, self.n = frame["mcux"], frame["mcux"] * frame["mcuy"]
            # per block of an MCU: slot, blocks a row of MCUs moves, blocks
            # an MCU moves along its row, offset inside the MCU
            self.parts = [(slot, c["v"] * c["bw"], c["h"], v * c["bw"] + h)
                          for slot, c in enumerate(comps)
                          for v in range(c["v"]) for h in range(c["h"])]

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, m: int) -> list:
        my, mx = divmod(m, self.cols)
        return [(slot, my * row + mx * step + off)
                for slot, row, step, off in self.parts]


def _scan(data, pos, seg, frame, coef, restart, qt, lut_dc, lut_ac, mode,
          dac):
    ns = seg[0]
    by_id = {c["id"]: c for c in frame["comps"]}
    comps = []
    lossless = mode == "lossless"
    for k in range(ns):
        c = by_id[seg[1 + 2 * k]]
        c["td"], c["ta"] = seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15
        # the quantization table in force when a component is first
        # scanned is the one its IDCT uses (libjpeg latches it)
        if not lossless and c["index"] not in frame["qt"]:
            if c["tq"] not in qt:
                raise ValueError(f"JPEG quantization table {c['tq']} "
                                 "is not defined")
            frame["qt"][c["index"]] = qt[c["tq"]].copy()
        comps.append(c)
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if mode in ("progressive", "arith_progressive") and (
            (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
            or (ah and al != ah - 1) or al > 13):
        raise ValueError("broken data stream: invalid progressive scan")
    segs, end = _segments(data, pos)
    if end >= len(data):
        # no marker after the scan: libjpeg asks for more data and PIL
        # refuses the file
        raise ValueError("image file is truncated")
    if lossless:
        _lossless_scan(segs, comps, frame, coef, restart, lut_dc, ss, al)
        return end
    blocks = _McuBlocks(frame, comps)
    progressive = mode in ("progressive", "arith_progressive")
    try:
        if mode.startswith("arith"):
            decode_scan_arith(segs, comps, blocks, [memoryview(c) for c in coef],
                              len(blocks), restart, dac, ss, se, ah, al,
                              progressive, _NATURAL.tolist())
        else:
            pad = 8 + 216 * len(blocks[0])   # one MCU's most bits, on zeros
            _decode_scan(_Scan(segs, pad), comps, blocks,
                         [memoryview(c) for c in coef], len(blocks), restart,
                         lut_dc, lut_ac, ss, se, ah, al, progressive)
    except (IndexError, KeyError):
        # a Huffman table is missing or the run left its block
        raise ValueError("JPEG scan data is corrupt") from None
    return end


_PREDICTORS = (
    None, lambda a, b, c: a, lambda a, b, c: b, lambda a, b, c: c,
    lambda a, b, c: a + b - c, lambda a, b, c: a + ((b - c) >> 1),
    lambda a, b, c: b + ((a - c) >> 1), lambda a, b, c: (a + b) >> 1)


def _lossless_scan(segs, comps, frame, planes, restart, lut_dc, psv, pt):
    """A lossless scan (``jdlhuff.c``, ``jddiffct.c``, ``jdpred.c``):
    Huffman-coded differences, one sample per data unit (H×V of each
    component an MCU when interleaved), undifferenced per component row
    with predictor ``psv``; each component's first row of the scan and of
    each restart interval predicts from 2^(P-Pt-1) then from the left,
    the first column from above; values modulo 2^16, then shifted left by
    ``pt``."""
    if not 1 <= psv <= 7:
        raise ValueError(f"JPEG lossless predictor {psv} is out of range")
    if len(comps) == 1:                  # one sample an MCU
        c = comps[0]
        mcux, mcuy, units = c["dw"], c["dh"], [(0, c, 1, 1)]
    else:
        mcux = -(-frame["width"] // frame["hmax"])
        mcuy = -(-frame["height"] // frame["vmax"])
        units = [(slot, c, c["h"], c["v"]) for slot, c in enumerate(comps)]
    if restart and restart % mcux:
        raise _refuse("lossless with a restart interval inside a row,")
    rows_per_interval = restart // mcux if restart else 0
    predict = _PREDICTORS[psv]
    init = 1 << (frame["precision"] - pt - 1)
    seg_i = 0
    per_row = sum(h * v for _, _, h, v in units) * mcux
    bits = _Bits(segs[0], 8 + 4 * per_row)
    win, pos = bits.win, 0
    for my in range(mcuy):
        if rows_per_interval and my and my % rows_per_interval == 0:
            seg_i += 1
            bits = _Bits(segs[seg_i] if seg_i < len(segs) else b"",
                         8 + 4 * per_row)
            win, pos = bits.win, 0
        restart_row = my == 0 or (rows_per_interval
                                  and my % rows_per_interval == 0)
        diffs = [[[0] * (mcux * h) for _ in range(v)] for _, _, h, v in units]
        for mx in range(mcux):
            for slot, c, h, v in units:
                lut = lut_dc[c["td"]]
                for dv in range(v):
                    drow = diffs[slot][dv]
                    for dh in range(h):
                        e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        pos += e >> 8
                        s = e & 0xFF
                        if s == 16:
                            d = 32768
                        elif s:
                            d = (win[pos >> 3] >> (32 - s - (pos & 7))) \
                                & ((1 << s) - 1)
                            pos += s
                            if d < 1 << (s - 1):
                                d += 1 - (1 << s)
                        else:
                            d = 0
                        drow[mx * h + dh] = d
        for slot, c, h, v in units:
            plane = planes[c["index"]]
            for dv in range(v):
                y = my * v + dv
                if y >= len(plane):
                    continue
                row, d = plane[y], diffs[slot][dv]
                width = min(len(row), len(d))
                above = plane[y - 1] if y else None
                first = restart_row and dv == 0
                for x in range(width):
                    if first:
                        p = init if x == 0 else row[x - 1]
                    elif x == 0:
                        p = above[0]
                    else:
                        p = predict(row[x - 1], above[x], above[x - 1])
                    row[x] = (p + d[x]) & 0xFFFF
    frame["lossless_pt"] = pt


def _output(frame, coef, jfif, adobe, transform, colour=None) -> np.ndarray:
    height, width = frame["height"], frame["width"]
    planes = []
    for c in frame["comps"]:
        k = c["index"]
        if k not in frame["qt"]:
            raise ValueError(f"JPEG component {c['id']} has no scan")
        q = frame["qt"][k]
        blocks = coef[k].astype(np.int64).reshape(-1, 64)
        px = idct_islow(blocks, q).reshape(c["bh"], c["bw"], 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        plane = plane[:c["dh"], :c["dw"]]
        if frame["hmax"] % c["h"] or frame["vmax"] % c["v"]:
            raise _refuse("fractionally sampled")
        up = _upsample(plane, frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return planes[0][:, :, None]
    if len(planes) == 4:
        if adobe and transform != 0:              # YCCK → CMYK
            cmy = 255 - ycc_to_rgb(*planes[:3], clip=False)
            planes = [*np.moveaxis(np.clip(cmy, 0, 255).astype(np.uint8), -1, 0),
                      planes[3]]
        return cmyk_to_rgb(255 - np.stack(planes, -1))
    ids = [c["id"] for c in frame["comps"]]
    if colour is not None:
        ycc = colour == "ycc"
    elif jfif:
        ycc = True
    elif adobe:
        ycc = transform != 0
    else:
        ycc = ids != [82, 71, 66]                   # 'R', 'G', 'B'
    if not ycc:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)
