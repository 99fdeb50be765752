"""The port's JPEG decoder (``s2sr_tpu_torch/tiles/jpeg.py``,
``tiles/jpeg_arith.py``) on what PIL decodes beyond the baseline and
progressive Huffman files of ``test_torch_decode.py``, against PIL's
``Image.open(...).convert("RGB")``. Tolerance: byte-equal, or PIL and the
decoder both refusing the same bytes.

PIL cannot write arithmetic-coded or lossless JPEGs
this module holds
small encoders for them: the QM-coder and the Annex F/G models of
libjpeg's ``jcarith.c`` (sequential and progressive, with DAC
conditioning and restarts), and a lossless Huffman encoder (the seven
predictors, the point transform, restarts per row). CMYK comes from
PIL (Adobe CMYK) and YCCK from ``test_torch_decode.own_jpeg`` with the
Adobe transform flag 2.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from s2sr_tpu_torch.pipelines.io import decode_upload
from s2sr_tpu_torch.tiles.jpeg import decode_jpeg
from s2sr_tpu_torch.tiles.jpeg_arith import ARITAB

from test_torch_decode import _dct_blocks, own_jpeg, photo, pil_jpeg, pil_rgb
from torch_threads import one_torch_thread  # noqa: F401


# --- an arithmetic-coding encoder (jcarith.c) ----------------------------------

# zigzag position → natural index
NAT = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
       40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
       43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
       53, 60, 61, 54, 47, 55, 62, 63]


class QMEncoder:
    """jcarith.c's arith_encode and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        while self.zc:
                            self._emit(0)
                            self.zc -= 1
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        while self.zc:
                            self._emit(0)
                            self.zc -= 1
                        self._emit(self.buffer)
                    if self.sc:
                        while self.zc:
                            self._emit(0)
                            self.zc -= 1
                        while self.sc:
                            self._emit(0xFF)
                            self._emit(0)
                            self.sc -= 1
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                while self.zc:
                    self._emit(0)
                    self.zc -= 1
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                while self.zc:
                    self._emit(0)
                    self.zc -= 1
                self._emit(self.buffer)
            if self.sc:
                while self.zc:
                    self._emit(0)
                    self.zc -= 1
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
        if self.c & 0x7FFF800:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _dc(enc, st, ctx, ci, m, last, L=0, U=1):
    """One DC difference (T.81 F.1.4.1; ``encode_mcu``'s DC part), the
    conditioning context ``ctx[ci]`` updated with the DAC bounds L, U."""
    s = st
    i = ctx[ci]
    v = m - last[ci]
    if v == 0:
        enc.encode(s, i, 0)
        ctx[ci] = 0
        return
    last[ci] = m
    enc.encode(s, i, 1)
    if v > 0:
        enc.encode(s, i + 1, 0)
        i += 2
        ctx[ci] = 4
    else:
        v = -v
        enc.encode(s, i + 1, 1)
        i += 3
        ctx[ci] = 8
    mm = 0
    v -= 1
    if v:
        enc.encode(s, i, 1)
        mm = 1
        v2 = v
        i = 20
        v2 >>= 1
        while v2:
            enc.encode(s, i, 1)
            mm <<= 1
            i += 1
            v2 >>= 1
    enc.encode(s, i, 0)
    if mm < (1 << L) >> 1:
        ctx[ci] = 0
    elif mm > (1 << U) >> 1:
        ctx[ci] += 8
    i += 14
    mm >>= 1
    while mm:
        enc.encode(s, i, 1 if mm & v else 0)
        mm >>= 1


def _ac_mag(enc, st, i, v, k, K):
    """The magnitude category and bits of |v| ≥ 1 (F.1.4.4.1.3), from the
    bin ``i`` (its S0), with the K conditioning of position ``k``."""
    mm = 0
    v -= 1
    if v:
        enc.encode(st, i, 1)
        mm = 1
        v2 = v >> 1
        if v2:
            enc.encode(st, i, 1)
            mm <<= 1
            i = 189 if k <= K else 217
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                mm <<= 1
                i += 1
                v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    mm >>= 1
    while mm:
        enc.encode(st, i, 1 if mm & v else 0)
        mm >>= 1


def _ac_seq(enc, st, fixed, blk, ss, se, al, K):
    """AC coefficients ss..se of a block, point-transformed by ``al``
    (``encode_mcu``'s AC part, ``encode_mcu_AC_first``)."""
    def val(k):
        v = int(blk[NAT[k]])
        return v, (abs(v) >> al)
    ke = se
    while ke > 0 and val(ke)[1] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while True:
            v, a = val(k)
            if a:
                enc.encode(st, i + 1, 1)
                enc.encode(fixed, 0, 1 if v < 0 else 0)
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        _ac_mag(enc, st, i + 2, a, k, K)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _ac_refine(enc, st, fixed, blk, ss, se, al, ah):
    """``encode_mcu_AC_refine``: the bit ``al`` of coefficients ss..se."""
    def a_at(k, sh): return abs(int(blk[NAT[k]])) >> sh
    ke = se
    while ke > 0 and a_at(ke, al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and a_at(kex, ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            v = int(blk[NAT[k]])
            a = abs(v) >> al
            if a:
                if a >> 1:
                    enc.encode(st, i + 2, a & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(fixed, 0, 1 if v < 0 else 0)
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def arith_jpeg(coefs, sampling, hgt, wid, q, progressive=False, restart=0, app=("jfif",),
               adobe_transform=None, ids=None, dac=None):
    """coefs[ci]: (hb_stored, wb_stored, 64) natural-order quantized int blocks (MCU-padded).
    dac: {("dc", 0): (L, U), ("ac", 0): K}."""
    nc = len(sampling)
    ids = ids or list(range(1, nc + 1))
    dac = dac or {}
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    L, U = dac.get(("dc", 0), (0, 1)); K = dac.get(("ac", 0), 5)

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload
    out = b"\xff\xd8"
    if "jfif" in app:
        out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe_transform]))
    out += seg(0xDB, b"\x00" + bytes(np.asarray(q)[NAT].astype(np.uint8)))
    out += seg(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, hgt, wid, nc) + b"".join(
        bytes([ids[ci], h << 4 | v, 0]) for ci, (h, v) in enumerate(sampling)))
    if dac:
        p = b""
        for (kind, t), val in dac.items():
            p += bytes([(0x10 if kind == "ac" else 0) | t, val if kind == "ac" else (val[1] << 4 | val[0])])
        out += seg(0xCC, p)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))

    def units(comps):
        if len(comps) > 1:
            for my in range(mcuy):
                for mx in range(mcux):
                    yield [(ci, my * v + y, mx * h + x) for ci in comps
                           for (h, v) in [sampling[ci]] for y in range(v) for x in range(h)]
        else:
            ci = comps[0]
            h, v = sampling[ci]
            dw, dh = -(-wid * h // hmax), -(-hgt * v // vmax)
            for y in range(-(-dh // 8)):
                for x in range(-(-dw // 8)):
                    yield [(ci, y, x)]

    if progressive:
        script = [(list(range(nc)), 0, 0, 0, 1)]
        script += [([ci], 1, 5, 0, 1) for ci in range(nc)]
        script += [([ci], 6, 63, 0, 0) for ci in range(nc)]
        script += [(list(range(nc)), 0, 0, 1, 0)]
        script += [([ci], 1, 5, 1, 0) for ci in range(nc)]
    else:
        script = [(list(range(nc)), 0, 63, 0, 0)]
    for comps, ss, se, ah, al in script:
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[ci], 0x00]) for ci in comps)
                   + bytes([ss, se, ah << 4 | al]))
        enc = QMEncoder()
        dcst = bytearray(64)
        acst = bytearray(256)
        fixed = bytearray([113])
        last = [0] * nc
        ctx = [0] * nc
        rst = 0
        for u, unit in enumerate(units(comps)):
            if restart and u and u % restart == 0:
                out += enc.finish() + bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
                enc = QMEncoder()
                dcst = bytearray(64)
                acst = bytearray(256)
                last = [0] * nc
                ctx = [0] * nc
            for ci, y, x in unit:
                blk = coefs[ci][y, x]
                if not progressive:
                    _dc(enc, dcst, ctx, ci, int(blk[0]), last, L, U)
                    _ac_seq(enc, acst, fixed, blk, 1, 63, 0, K)
                elif ss == 0 and ah == 0:
                    _dc(enc, dcst, ctx, ci, int(blk[0]) >> al, last, L, U)
                elif ss == 0:
                    enc.encode(fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    _ac_seq(enc, acst, fixed, blk, ss, se, al, K)
                else:
                    _ac_refine(enc, acst, fixed, blk, ss, se, al, ah)
        out += enc.finish()
    return out + b"\xff\xd9"


# --- a lossless encoder ----------------------------------------------------------

class _LWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0
    def put(self, v, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = 0
                self.n = 0
    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)

def _seg(marker, payload): return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

def lossless_jpeg(img, psv=1, pt=0, precision=8, restart_rows=0, jfif=True, sof=0xC3, ids=None):
    h, w, nc = img.shape
    ids = ids or [k + 1 for k in range(nc)]
    counts = [0] * 16
    counts[4] = 17
    dht = bytes([0x00]) + bytes(counts) + bytes(range(17))
    out = b"\xff\xd8"
    if jfif: out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _seg(0xC4, dht)
    out += _seg(sof, struct.pack(">BHHB", precision, h, w, nc) + b"".join(bytes([i, 0x11, 0]) for i in ids))
    if restart_rows: out += _seg(0xDD, struct.pack(">H", restart_rows * w))
    out += _seg(0xDA, bytes([nc]) + b"".join(bytes([i, 0x00]) for i in ids) + bytes([psv, 0, pt]))
    x = img.astype(np.int64) >> pt
    wr = _LWriter()
    rst = 0
    for y in range(h):
        first = y == 0 or (restart_rows and y % restart_rows == 0)
        if restart_rows and y and y % restart_rows == 0:
            wr.flush()
            out += bytes(wr.out) + bytes([0xFF, 0xD0 + rst % 8])
            rst += 1
            wr = _LWriter()
        for xx in range(w):
            for c in range(nc):
                if first:
                    pred = (1 << (precision - pt - 1)) if xx == 0 else x[y, xx - 1, c]
                elif xx == 0:
                    pred = x[y - 1, 0, c]
                else:
                    ra, rb, rc = x[y, xx - 1, c], x[y - 1, xx, c], x[y - 1, xx - 1, c]
                    pred = [0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv]
                d = int(x[y, xx, c] - pred) & 0xFFFF
                if d >= 32768:
                    d -= 65536
                if d == -32768:
                    d = 32768
                s = abs(d).bit_length() if d != 32768 else 16
                wr.put(s, 5)
                if s and s < 16:
                    wr.put(d if d > 0 else d + (1 << s) - 1, s)
    wr.flush()
    out += bytes(wr.out)
    return out + b"\xff\xd9"


def coefs_of(img: np.ndarray, sampling, q: np.ndarray) -> list:
    """Quantized natural-order blocks per component, MCU-padded."""
    hgt, wid = img.shape[:2]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    out = []
    for ci, (h, v) in enumerate(sampling):
        dw, dh = -(-wid * h // hmax), -(-hgt * v // vmax)
        plane = img[::vmax // v, ::hmax // h, ci][:dh, :dw]
        plane = np.pad(plane, ((0, mcuy * v * 8 - dh), (0, mcux * h * 8 - dw)),
                       mode="edge")
        zz = _dct_blocks(plane, q)
        nat = np.empty_like(zz)
        nat[..., NAT] = zz
        out.append(nat)
    return out


def arith_file(img, sampling, **kw) -> bytes:
    q = np.full(64, 5, np.int64)
    q[0] = 4
    return arith_jpeg(coefs_of(img, sampling, q), sampling, img.shape[0],
                      img.shape[1], q, **kw)


S444, S420, S422 = ((1, 1),) * 3, ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))
ARITH_CASES = {
    "seq_444": (S444, {}),
    "seq_420": (S420, {}),
    "seq_420_restart_2": (S420, {"restart": 2}),
    "seq_422_dac": (S422, {"dac": {("dc", 0): (2, 5), ("ac", 0): 9}}),
    "prog_444": (S444, {"progressive": True}),
    "prog_420_restart_3": (S420, {"progressive": True, "restart": 3}),
    "gray_seq": (((1, 1),), {}),
    "gray_prog": (((1, 1),), {"progressive": True}),
    "ycck_seq": (((1, 1),) * 4, {"adobe_transform": 2, "app": ()}),
}


@pytest.mark.parametrize("name", list(ARITH_CASES))
@pytest.mark.parametrize("shape", [(29, 43), (8, 8)])
def test_arithmetic_jpeg_matches_pil(name, shape):
    """SOF9 and SOF10 (every progressive procedure: DC first and
    refinement, AC first and refinement), restarts, DAC conditioning,
    gray, YCCK: byte-equal to PIL."""
    sampling, kw = ARITH_CASES[name]
    img = photo(*shape, seed=3)
    if len(sampling) == 4:
        img = np.concatenate([img, img[..., 1:2]], -1)
    data = arith_file(img[..., :len(sampling)], sampling, **kw)
    assert np.array_equal(decode_upload(data), pil_rgb(data))


def test_qm_table_is_t81_d2():
    """The probability estimation table: 114 entries, Qe of the first and
    the state machine's fixed point (113: the fixed 1/2 bin)."""
    assert len(ARITAB) == 114
    assert ARITAB[0] == 0x5A1D0181 and ARITAB[113] == 0x5A1D7171


CMYK_CASES = {
    "pil_adobe_cmyk": lambda img: _pil_cmyk(img, quality=90),
    "pil_adobe_cmyk_progressive": lambda img: _pil_cmyk(img, quality=70,
                                                        progressive=True),
    "cmyk_no_adobe": lambda img: own_jpeg(_four(img), sampling=((1, 1),) * 4,
                                          app=(), ids=(1, 2, 3, 4)),
    "cmyk_adobe_0": lambda img: own_jpeg(_four(img), sampling=((1, 1),) * 4,
                                         app=(), ids=(1, 2, 3, 4),
                                         adobe_transform=0),
    "ycck_adobe_2_subsampled": lambda img: own_jpeg(
        _four(img), sampling=((2, 2), (1, 1), (1, 1), (2, 2)), app=(),
        ids=(1, 2, 3, 4), adobe_transform=2),
    "ycck_adobe_1": lambda img: own_jpeg(_four(img), sampling=((1, 1),) * 4,
                                         app=(), ids=(1, 2, 3, 4),
                                         adobe_transform=1),
}


def _four(img):
    return np.concatenate([img, img[..., 1:2] // 2], -1)


def _pil_cmyk(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", list(CMYK_CASES))
def test_cmyk_and_ycck_jpeg_match_pil(name):
    """4 components: CMYK (no Adobe marker, or transform 0) and YCCK
    (transform 2, and 1, which libjpeg takes as YCCK), read inverted as
    PIL does and through its cmyk2rgb: byte-equal."""
    data = CMYK_CASES[name](photo(29, 43, seed=5))
    assert np.array_equal(decode_upload(data), pil_rgb(data))


LOSSLESS_CASES = {
    "psv1": {"jfif": False}, "psv2": {"jfif": False, "psv": 2},
    "psv3": {"jfif": False, "psv": 3}, "psv4": {"jfif": False, "psv": 4},
    "psv5_restart_rows_3": {"jfif": False, "psv": 5, "restart_rows": 3},
    "psv6": {"jfif": False, "psv": 6}, "psv7_pt2": {"jfif": False, "psv": 7,
                                                     "pt": 2},
    "rgb_ids": {"jfif": False, "ids": [82, 71, 66]},
    "adobe_0": {"jfif": False, "adobe": 0},
}


def _lossless(img, adobe=None, **kw) -> bytes:
    data = lossless_jpeg(img, **kw)
    if adobe is not None:
        data = data[:2] + _seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe])) + data[2:]
    return data


@pytest.mark.parametrize("name", list(LOSSLESS_CASES))
def test_lossless_jpeg_matches_pil(name):
    """SOF3 at 8 bits, every predictor, the point transform, restarts:
    libjpeg-turbo converts no colour here, and the samples come back as
    coded: byte-equal to PIL."""
    img = photo(19, 23, seed=6)
    data = _lossless(img, **LOSSLESS_CASES[name])
    got = decode_upload(data)
    assert np.array_equal(got, pil_rgb(data))
    pt = LOSSLESS_CASES[name].get("pt", 0)
    assert np.array_equal(got, (img >> pt) << pt)


@pytest.mark.parametrize("channels", [1, 4])
def test_lossless_gray_and_cmyk_match_pil(channels):
    img = photo(17, 21, seed=7)
    img = img[..., :1] if channels == 1 else _four(img)
    data = lossless_jpeg(img, jfif=channels == 1)
    assert np.array_equal(decode_upload(data), pil_rgb(data))


REFUSED = {
    # PIL refuses each of these bytes; so does the decoder
    "lossless_ycbcr_by_jfif": lambda img: lossless_jpeg(img),
    "lossless_ycbcr_by_adobe_1": lambda img: _lossless(img, jfif=False, adobe=1),
    "lossless_12_bit": lambda img: lossless_jpeg(img, jfif=False, precision=12),
    "lossless_6_bit": lambda img: lossless_jpeg(img >> 2, jfif=False, precision=6),
    "hierarchical_sof7": lambda img: lossless_jpeg(img, jfif=False, sof=0xC7),
    "arithmetic_lossless_sof11": lambda img: lossless_jpeg(img, jfif=False,
                                                           sof=0xCB),
    "two_components": lambda img: own_jpeg(img[..., :2], sampling=((1, 1),) * 2),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_jpeg_variants_pil_refuses_are_refused(name):
    """What PIL (Pillow 12.1) refuses: lossless files marked YCbCr (JFIF,
    Adobe transform 1: libjpeg-turbo will not convert colour in lossless
    mode), samples of other than 8 bits, hierarchical and arithmetic
    lossless frames, 2 components."""
    data = REFUSED[name](photo(13, 15, seed=8))
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError):
        decode_upload(data)


def _flip_in_interval(data: bytes, seed: int) -> bytes:
    """``data`` with one entropy-coded byte of its (only) scan XORed, away
    from 0xFF and markers."""
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    rng = np.random.default_rng(seed)
    out = bytearray(data)
    while True:
        p = int(rng.integers(start + 4, len(data) - 4))
        if b"\xff" not in data[p - 2:p + 2] and data[p] ^ 0x55 != 0xFF:
            out[p] ^= 0x55
            return bytes(out)


@pytest.mark.parametrize("restart", [2, 0])
@pytest.mark.parametrize("seed", range(4))
def test_corrupt_entropy_data_matches_pil(restart, seed):
    """One flipped byte inside a restart interval (and in a file without
    restarts): libjpeg recovers (bad codes read as 0 after 17 bits, the
    rest of an interval zero once its bits run out, a saturating IDCT)
    and PIL returns that image; the decoder gives the same bytes."""
    kw = {"restart_marker_blocks": restart} if restart else {}
    data = _flip_in_interval(pil_jpeg(photo(64, 96, seed=2), quality=90, **kw),
                             seed)
    assert np.array_equal(decode_upload(data), pil_rgb(data))


@pytest.mark.parametrize("cut", ["half", "no_eoi"])
def test_truncated_jpeg_refused_as_pil_refuses(cut):
    """Data that ends inside the scan, or only its EOI missing: libjpeg
    asks for more data and PIL raises "image file is truncated" (without
    ``LOAD_TRUNCATED_IMAGES``); so does the decoder."""
    data = pil_jpeg(photo(64, 64, seed=1), quality=90)
    data = data[:len(data) // 2] if cut == "half" else data[:-2]
    with pytest.raises(OSError, match="truncated"):
        pil_rgb(data)
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(data)


# --- lossless with subsampled components -------------------------------------------

def lossless_subsampled(img, sampling, psv=1, restart_mcu_rows=0,
                        ids=(82, 71, 66)) -> bytes:
    """A lossless (SOF3) file of RGB-labelled components sampled as
    ``sampling`` (H, V per component): each component's plane taken every
    Hmax/H, Vmax/V pixels and padded to whole MCUs by repeating its edge;
    H×V samples of each component an MCU, interleaved; the first row of
    each component (of the scan, of each restart interval) predicted from
    2^7 and the left."""
    h, w, nc = img.shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    counts = [0] * 16
    counts[4] = 17
    out = b"\xff\xd8" + _seg(0xC4, bytes([0]) + bytes(counts) + bytes(range(17)))
    out += _seg(0xC3, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i, (s[0] << 4) | s[1], 0]) for i, s in zip(ids, sampling)))
    if restart_mcu_rows:
        out += _seg(0xDD, struct.pack(">H", restart_mcu_rows * mcux))
    out += _seg(0xDA, bytes([nc]) + b"".join(bytes([i, 0]) for i in ids)
                + bytes([psv, 0, 0]))
    planes = []
    for c, (hh, vv) in enumerate(sampling):
        p = img[::vmax // vv, ::hmax // hh, c].astype(np.int64)
        planes.append(np.pad(p, ((0, mcuy * vv - p.shape[0]),
                                 (0, mcux * hh - p.shape[1])), mode="edge"))
    wr = _LWriter()
    rst = 0
    for my in range(mcuy):
        start = restart_mcu_rows and my and my % restart_mcu_rows == 0
        if start:
            wr.flush()
            out += bytes(wr.out) + bytes([0xFF, 0xD0 + rst % 8])
            rst += 1
            wr = _LWriter()
        first_row = my == 0 or start
        for mx in range(mcux):
            for c, (hh, vv) in enumerate(sampling):
                p = planes[c]
                for dv in range(vv):
                    for dh in range(hh):
                        y, x = my * vv + dv, mx * hh + dh
                        if first_row and dv == 0:
                            pred = 128 if x == 0 else p[y, x - 1]
                        elif x == 0:
                            pred = p[y - 1, 0]
                        else:
                            ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                            pred = [0, ra, rb, rc, ra + rb - rc,
                                    ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                                    (ra + rb) >> 1][psv]
                        d = int(p[y, x] - pred)
                        s = abs(d).bit_length()
                        wr.put(s, 5)
                        if s:
                            wr.put(d if d > 0 else d + (1 << s) - 1, s)
    wr.flush()
    return out + bytes(wr.out) + b"\xff\xd9"


SUBSAMPLED_LOSSLESS = {
    "h2v2": (((2, 2), (1, 1), (1, 1)), {}),
    "h2v1_odd": (((2, 1), (1, 1), (1, 1)), {"psv": 4}),
    "h1v2_psv7": (((1, 2), (1, 1), (1, 1)), {"psv": 7}),
    "h2v2_restart": (((2, 2), (1, 1), (1, 1)), {"restart_mcu_rows": 3,
                                                "psv": 5}),
    "chroma_full_luma_half": (((1, 1), (2, 2), (2, 2)), {"psv": 6}),
}


@pytest.mark.parametrize("name", list(SUBSAMPLED_LOSSLESS))
def test_subsampled_lossless_jpeg_matches_pil(name):
    """PIL (libjpeg-turbo) decodes a lossless JPEG whose components are
    subsampled, replicating each subsampled sample over its Hmax/H ×
    Vmax/V pixels: the port gives the same bytes (odd sizes, predictors,
    restarts)."""
    sampling, kw = SUBSAMPLED_LOSSLESS[name]
    img = photo(21, 27, seed=9)
    data = lossless_subsampled(img, sampling, **kw)
    assert np.array_equal(decode_upload(data), pil_rgb(data))
