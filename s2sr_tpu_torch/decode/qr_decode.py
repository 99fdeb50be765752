"""QR decoder: module-matrix bit decode + full-image decode.

Capability match for the reference client's jsQR usage
(`client/src/app/services/qr-ocr.service.ts:87-106`, including
``inversionAttempts: 'attemptBoth'``), rebuilt server-side: the image
binarization runs in torch on the card (:mod:`.locate`), locating and
bit-level decoding are host numpy. A copy of the JAX package's
``decode/qr_decode.py``.

Matrix decode pipeline: version from size → format info (nearest valid
BCH word) → zigzag codeword read under the data mask → block
de-interleave → Reed-Solomon correction per block → segment parse
(numeric / alphanumeric / byte / ECI).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .galois import rs_decode
from .qr_tables import (
    ALIGNMENT, EC_BLOCKS, ECL_FROM_BITS, FORMAT_WORDS, MAX_VERSION,
    mask_fn, version_for_size,
)

ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"


@dataclass
class QRResult:
    text: str
    version: int
    ec_level: str
    mask: int
    errors_corrected: int
    inverted: bool = False
    mirrored: bool = False
    location: list | None = None  # 4 corner (x, y) pairs when image-decoded
    meta: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# matrix-level decode
# ---------------------------------------------------------------------------


def _read_format(m: np.ndarray) -> tuple[int, int, int]:
    """Return (ec_bits, mask_id, hamming_distance) from the two format
    copies, matched against all 32 valid words (≤3-bit correction)."""
    size = m.shape[0]
    # copy 1: around the top-left finder
    c1_pos = [(8, c) for c in (0, 1, 2, 3, 4, 5, 7, 8)] + \
             [(r, 8) for r in (7, 5, 4, 3, 2, 1, 0)]
    # copy 2: below top-right finder + right of bottom-left finder
    c2_pos = [(size - 1 - r, 8) for r in range(7)] + \
             [(8, size - 8 + c) for c in range(8)]

    def word(positions):
        bits = 0
        for r, c in positions:
            bits = (bits << 1) | int(m[r, c])
        return bits

    best = (99, 0)
    for w in (word(c1_pos), word(c2_pos)):
        for idx, valid in enumerate(FORMAT_WORDS):
            d = bin(w ^ valid).count("1")
            if d < best[0]:
                best = (d, idx)
    dist, idx = best
    if dist > 3:
        raise ValueError("format info unreadable")
    return idx >> 3, idx & 0b111, dist


def _function_mask(version: int, size: int) -> np.ndarray:
    """True where the module is a function pattern (not data)."""
    f = np.zeros((size, size), bool)
    # finders + separators + format areas
    f[:9, :9] = True
    f[:9, size - 8:] = True
    f[size - 8:, :9] = True
    # timing
    f[6, :] = True
    f[:, 6] = True
    # alignment
    centers = ALIGNMENT[version]
    for r in centers:
        for c in centers:
            if (r < 9 and c < 9) or (r < 9 and c > size - 10) \
                    or (r > size - 10 and c < 9):
                continue
            f[r - 2:r + 3, c - 2:c + 3] = True
    if version >= 7:
        f[size - 11:size - 8, :6] = True
        f[:6, size - 11:size - 8] = True
    return f


def _read_codewords(m: np.ndarray, version: int, mask_id: int) -> np.ndarray:
    size = m.shape[0]
    func = _function_mask(version, size)
    mfn = mask_fn(mask_id)
    bits = []
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:           # skip the vertical timing column entirely
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if func[r, c]:
                    continue
                v = int(m[r, c])
                if mfn(r, c):
                    v ^= 1
                bits.append(v)
        upward = not upward
        col -= 2
    n_bytes = len(bits) // 8
    arr = np.array(bits[: n_bytes * 8], np.uint8).reshape(n_bytes, 8)
    return (arr << np.arange(7, -1, -1)).sum(axis=1).astype(np.int32)


def _deinterleave(cw: np.ndarray, version: int, level: str
                  ) -> tuple[np.ndarray, int]:
    """Undo block interleaving, RS-correct each block, return
    (data bytes, total errors corrected)."""
    ec, groups = EC_BLOCKS[version][level]
    sizes = [d for n, d in groups for _ in range(n)]
    n_blocks = len(sizes)
    total_data = sum(sizes)
    if len(cw) < total_data + ec * n_blocks:
        raise ValueError("codeword count short for version/level")

    data_blocks = [np.zeros(s, np.int32) for s in sizes]
    idx = 0
    for byte_i in range(max(sizes)):
        for b in range(n_blocks):
            if byte_i < sizes[b]:
                data_blocks[b][byte_i] = cw[idx]
                idx += 1
    ec_blocks = [np.zeros(ec, np.int32) for _ in range(n_blocks)]
    for byte_i in range(ec):
        for b in range(n_blocks):
            ec_blocks[b][byte_i] = cw[idx]
            idx += 1

    out = []
    fixed = 0
    for b in range(n_blocks):
        word = np.concatenate([data_blocks[b], ec_blocks[b]])
        dec, ne = rs_decode(word, ec)
        fixed += ne
        out.append(dec)
    return np.concatenate(out), fixed


class _BitReader:
    def __init__(self, data: np.ndarray):
        self.bits = np.unpackbits(data.astype(np.uint8)[:, None], axis=1).ravel()
        self.pos = 0

    def take(self, n: int) -> int:
        if self.pos + n > len(self.bits):
            raise ValueError("bitstream exhausted")
        v = 0
        for b in self.bits[self.pos:self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def remaining(self) -> int:
        return len(self.bits) - self.pos


def _char_count_bits(mode: int, version: int) -> int:
    table = {1: (10, 12, 14), 2: (9, 11, 13), 4: (8, 16, 16), 8: (8, 10, 12)}
    tier = 0 if version <= 9 else (1 if version <= 26 else 2)
    return table[mode][tier]


def _parse_stream(data: np.ndarray, version: int) -> str:
    r = _BitReader(data)
    out = bytearray()
    saw_kanji = False
    while r.remaining() >= 4:
        mode = r.take(4)
        if mode == 0:                       # terminator
            break
        if mode == 0b0011:                  # structured append — skip the
            r.take(16)                      # 16-bit header (symbol seq +
            continue                        # parity), decode this symbol's
                                            # content like jsQR does
        if mode == 0b0111:                  # ECI — skip the designator
            first = r.take(8)
            if first & 0b1000_0000 == 0:
                pass                         # 1-byte designator (0-127)
            elif first & 0b1100_0000 == 0b1000_0000:
                r.take(8)                    # 2-byte (prefix 10)
            elif first & 0b1110_0000 == 0b1100_0000:
                r.take(16)                   # 3-byte (prefix 110)
            else:
                raise ValueError("invalid ECI designator")
            continue
        if mode == 0b0001:                  # numeric
            n = r.take(_char_count_bits(1, version))
            while n >= 3:
                v = r.take(10)
                if v > 999:
                    raise ValueError("invalid numeric triple")
                out += f"{v:03d}".encode()
                n -= 3
            if n == 2:
                v = r.take(7)
                if v > 99:
                    raise ValueError("invalid numeric pair")
                out += f"{v:02d}".encode()
            elif n == 1:
                v = r.take(4)
                if v > 9:
                    raise ValueError("invalid numeric digit")
                out += f"{v:01d}".encode()
        elif mode == 0b0010:                # alphanumeric
            n = r.take(_char_count_bits(2, version))
            while n >= 2:
                v = r.take(11)
                if v >= 45 * 45:
                    raise ValueError("invalid alphanumeric pair")
                out += (ALNUM[v // 45] + ALNUM[v % 45]).encode()
                n -= 2
            if n:
                v = r.take(6)
                if v >= 45:
                    raise ValueError("invalid alphanumeric char")
                out += ALNUM[v].encode()
        elif mode == 0b0100:                # byte
            n = r.take(_char_count_bits(4, version))
            for _ in range(n):
                out.append(r.take(8))
        elif mode == 0b1000:                # kanji — pass raw Shift-JIS
            saw_kanji = True
            n = r.take(_char_count_bits(8, version))
            for _ in range(n):
                v = r.take(13)
                hi, lo = divmod(v, 0xC0)
                sjis = (hi << 8) | lo
                sjis += 0x8140 if sjis < 0x1F00 else 0xC140
                out += bytes([(sjis >> 8) & 0xFF, sjis & 0xFF])
        else:
            raise ValueError(f"unsupported mode {mode:04b}")
    # byte mode's spec default charset is ISO-8859-1; only streams that
    # actually carried kanji segments should try Shift-JIS (a Latin-1
    # payload's high bytes can be valid SJIS and would misdecode)
    codecs = ("utf-8", "shift_jis") if saw_kanji else ("utf-8",)
    for codec in codecs:
        try:
            return out.decode(codec)
        except UnicodeDecodeError:
            continue
    return out.decode("latin-1")


def decode_matrix(modules: np.ndarray) -> QRResult:
    """Decode a square boolean module matrix (True = dark)."""
    m = np.asarray(modules, bool)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError("module matrix must be square")
    version = version_for_size(m.shape[0])
    if version > MAX_VERSION:
        raise ValueError(f"QR version {version} > supported {MAX_VERSION}")

    last_err: Exception | None = None
    for mirrored in (False, True):
        mm = m.T if mirrored else m
        try:
            ec_bits, mask_id, _ = _read_format(mm)
            level = ECL_FROM_BITS[ec_bits]
            cw = _read_codewords(mm, version, mask_id)
            data, fixed = _deinterleave(cw, version, level)
            text = _parse_stream(data, version)
            return QRResult(text=text, version=version, ec_level=level,
                            mask=mask_id, errors_corrected=fixed,
                            mirrored=mirrored)
        except (ValueError, ZeroDivisionError) as e:
            last_err = e
    raise ValueError(f"matrix decode failed: {last_err}")


# ---------------------------------------------------------------------------
# image-level decode
# ---------------------------------------------------------------------------


def decode_qr(image: np.ndarray, *, attempt_both: bool = True,
              device="cuda") -> QRResult | None:
    """Decode a QR code from an image array (H×W gray or H×W×3 RGB uint8).

    Mirrors jsQR semantics: returns ``None`` when no decodable code is
    found; ``attempt_both`` also tries the inverted (light-on-dark)
    interpretation, like the reference's ``inversionAttempts:
    'attemptBoth'``. Binarization runs on ``device``.
    """
    from .locate import binarize, extract_matrices

    img = np.asarray(image)
    # multi-scale: block binarization has a fixed 8-px block, so very
    # large module sizes need a coarser view (same reason app decoders
    # downscale camera frames before jsQR)
    scales = [1, 2, 4]
    for s in scales:
        view = img[::s, ::s] if s > 1 else img
        if min(view.shape[:2]) < 21:
            break
        bin_img = binarize(view, device=device)
        attempts = [(bin_img, False)]
        if attempt_both:
            attempts.append((~bin_img, True))
        for b, inverted in attempts:
            for modules, corners in extract_matrices(b):
                try:
                    res = decode_matrix(modules)
                except ValueError:
                    continue
                res.inverted = inverted
                res.location = [(x * s, y * s) for x, y in corners]
                return res
    return None
