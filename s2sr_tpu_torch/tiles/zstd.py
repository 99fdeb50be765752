"""Zstandard frames (RFC 8878) decoded in pure Python.

libtiff's ZSTD compression (TIFF compression 50000) stores each strip or
tile as one Zstandard frame, and PIL opens such files; the standard
library has no zstd module and the card's machine no ``zstandard``
package, so ``tiles/tiff.py`` decodes them here. Everything a frame may
hold is read: skippable frames; the frame header (window, dictionary id,
content size, checksum flag); raw, RLE and compressed blocks; literals
raw, RLE, Huffman-coded with a new tree (direct or FSE-compressed
weights) or the previous one (treeless), in 1 or 4 streams; sequences
with literal-length, offset and match-length codes under predefined,
RLE, FSE-described or repeated tables; the three repeat offsets; and the
content checksum (the low 32 bits of XXH64), verified when present.
Dictionaries are refused, as libtiff never writes them.

Backward bitstreams are read through an 8-byte window at the bit offset
(never one shift of the whole stream), so a strip of a megabyte decodes
in seconds in Python.
"""

from __future__ import annotations

import struct

_MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50          # ...5F: the low 4 bits are free
_MAX_BLOCK = 128 * 1024

# literal-length and match-length codes → (baseline, extra bits)
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# the predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
                2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, -1, -1, -1, -1, -1], 5)
_MAX_LOG = {"ll": 9, "of": 8, "ml": 9}
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}


class ZstdError(ValueError):
    pass


def _corrupt(what: str):
    raise ZstdError(f"ZSTD data is corrupt: {what}")


# --- bit readers ------------------------------------------------------------------

class _Forward:
    """Little-endian bits read forward (FSE table descriptions)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, pos * 8

    def read(self, n: int) -> int:
        i = self.bit >> 3
        w = int.from_bytes(self.data[i:i + 8], "little")
        self.bit += n
        if (self.bit + 7) >> 3 > len(self.data):
            _corrupt("table description runs past its block")
        return (w >> (self.bit - n - i * 8)) & ((1 << n) - 1)

    def byte_pos(self) -> int:
        return (self.bit + 7) >> 3


def _backward_start(stream: bytes) -> int:
    """Bit offset below a backward stream's end marker."""
    if not stream or stream[-1] == 0:
        _corrupt("backward bitstream without its end marker")
    return len(stream) * 8 - 8 + stream[-1].bit_length() - 1


def _read_back(data: bytes, off: int, n: int) -> tuple:
    """(value of the ``n`` bits below bit ``off``, new offset); bits below
    the stream's start read as zeros."""
    off -= n
    if off >= 0:
        i = off >> 3
        return ((int.from_bytes(data[i:i + 8], "little") >> (off & 7))
                & ((1 << n) - 1)), off
    if off + n <= 0:
        return 0, off
    return (int.from_bytes(data[:8], "little")
            & ((1 << (off + n)) - 1)) << -off, off


# --- FSE ----------------------------------------------------------------------------

def _fse_table(freqs: list, log: int) -> tuple:
    """(symbol, bits, base) per state of the FSE decoding table."""
    size = 1 << log
    symbols = [0] * size
    high = size
    desc = [0] * len(freqs)
    for s, f in enumerate(freqs):
        if f == -1:
            high -= 1
            symbols[high] = s
            desc[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, f in enumerate(freqs):
        if f <= 0:
            continue
        desc[s] = f
        for _ in range(f):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos >= high:
                pos = (pos + step) & mask
    if pos != 0:
        _corrupt("FSE distribution does not fill its table")
    bits = [0] * size
    base = [0] * size
    for i in range(size):
        d = desc[symbols[i]]
        desc[symbols[i]] = d + 1
        nb = log - (d.bit_length() - 1)
        bits[i] = nb
        base[i] = (d << nb) - size
    return symbols, bits, base, log


def _fse_rle(symbol: int) -> tuple:
    return [symbol], [0], [0], 0


def _read_fse_description(data: bytes, pos: int, max_log: int,
                          max_symbol: int) -> tuple:
    """(table, position after the description)."""
    r = _Forward(data, pos)
    log = r.read(4) + 5
    if log > max_log:
        _corrupt("FSE accuracy log too large")
    remaining = 1 << log
    freqs = []
    while remaining > 0 and len(freqs) <= max_symbol:
        bits = (remaining + 1).bit_length()
        val = r.read(bits)
        lower = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - (remaining + 1)
        if (val & lower) < threshold:
            r.bit -= 1
            val &= lower
        elif val > lower:
            val -= threshold
        proba = val - 1
        remaining -= -proba if proba < 0 else proba
        freqs.append(proba)
        if proba == 0:
            while True:
                repeat = r.read(2)
                freqs.extend([0] * repeat)
                if repeat != 3:
                    break
    if remaining != 0 or len(freqs) > max_symbol + 1:
        _corrupt("FSE distribution does not sum to its table")
    return _fse_table(freqs, log), r.byte_pos()


# --- Huffman literals ------------------------------------------------------------

def _huffman_weights(data: bytes, pos: int) -> tuple:
    """(weights of every symbol but the last, position after)."""
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            _corrupt("Huffman weights are truncated")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], pos + (n + 1) // 2
    end = pos + head
    table, start = _read_fse_description(data[:end], pos, 6, 255)
    stream = data[start:end]
    symbols, nbits, base, log = table
    off = _backward_start(stream)
    s1, off = _read_back(stream, off, log)
    s2, off = _read_back(stream, off, log)
    weights = []
    while True:
        weights.append(symbols[s1])
        v, off = _read_back(stream, off, nbits[s1])
        s1 = base[s1] + v
        if off < 0:
            weights.append(symbols[s2])
            break
        weights.append(symbols[s2])
        v, off = _read_back(stream, off, nbits[s2])
        s2 = base[s2] + v
        if off < 0:
            weights.append(symbols[s1])
            break
        if len(weights) > 255:
            _corrupt("too many Huffman weights")
    return weights, end


def _huffman_table(weights: list) -> tuple:
    """(symbol, bits) per ``max_bits``-bit peek value, and max_bits."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _corrupt("Huffman weights are all zero")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        _corrupt("Huffman weights do not complete a tree")
    weights = weights + [left.bit_length()]
    if max_bits > 11:
        _corrupt("Huffman code too long")
    lens = [max_bits + 1 - w if w else 0 for w in weights]
    count = [0] * (max_bits + 2)
    for n in lens:
        count[n] += 1
    start = [0] * (max_bits + 2)
    for n in range(max_bits, 0, -1):
        start[n - 1] = start[n] + count[n] * (1 << (max_bits - n))
    size = 1 << max_bits
    sym = [0] * size
    bits = [0] * size
    for s, n in enumerate(lens):
        if n:
            span = 1 << (max_bits - n)
            at = start[n]
            sym[at:at + span] = [s] * span
            bits[at:at + span] = [n] * span
            start[n] = at + span
    return sym, bits, max_bits


def _huffman_stream(stream: bytes, count: int, table: tuple) -> bytearray:
    sym, bits, max_bits = table
    out = bytearray(count)
    off = _backward_start(stream)
    mask = (1 << max_bits) - 1
    frombytes = int.from_bytes
    for k in range(count):
        lo = off - max_bits
        if lo >= 0:
            i = lo >> 3
            v = (frombytes(stream[i:i + 8], "little") >> (lo & 7)) & mask
        else:
            v = (frombytes(stream[:8], "little") << -lo) & mask
        out[k] = sym[v]
        off -= bits[v]
    if off != 0:
        _corrupt("Huffman stream not consumed exactly")
    return out


def _literals(data: bytes, pos: int, end: int, state: dict) -> tuple:
    """(literal bytes, position of the sequences section)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            if pos + size > end:
                _corrupt("raw literals run past their block")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            _corrupt("RLE literals are truncated")
        return bytes([data[pos]]) * size, pos + 1
    head = (3, 3, 4, 5)[fmt]
    c = int.from_bytes(data[pos:pos + head], "little")
    bits = (10, 10, 14, 18)[fmt]
    regen = (c >> 4) & ((1 << bits) - 1)
    comp = (c >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    pos += head
    if pos + comp > end or regen > _MAX_BLOCK:
        _corrupt("compressed literals run past their block")
    lit_end = pos + comp
    if kind == 2:
        weights, pos = _huffman_weights(data[:lit_end], pos)
        state["huffman"] = _huffman_table(weights)
    elif state.get("huffman") is None:
        _corrupt("treeless literals without a previous tree")
    table = state["huffman"]
    if streams == 1:
        return bytes(_huffman_stream(data[pos:lit_end], regen, table)), lit_end
    s1, s2, s3 = (int.from_bytes(data[pos + k:pos + k + 2], "little")
                  for k in (0, 2, 4))
    pos += 6
    cuts = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, lit_end]
    if cuts[3] > lit_end:
        _corrupt("Huffman jump table runs past its literals")
    each = (regen + 3) // 4
    counts = [each, each, each, regen - 3 * each]
    if counts[3] < 0:
        _corrupt("Huffman streams are shorter than their literals")
    out = bytearray()
    for k in range(4):
        out += _huffman_stream(data[cuts[k]:cuts[k + 1]], counts[k], table)
    return bytes(out), lit_end


# --- sequences ----------------------------------------------------------------------

_DEFAULT_TABLES = {"ll": _fse_table(*_LL_DEFAULT),
                   "of": _fse_table(*_OF_DEFAULT),
                   "ml": _fse_table(*_ML_DEFAULT)}


def _sequences(data: bytes, pos: int, end: int, state: dict) -> list:
    """[(literal length, offset value, match length)] of one block."""
    b0 = data[pos]
    if b0 == 0:
        return []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        _corrupt("reserved bits of the sequence modes are set")
    tables = {}
    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = (modes >> shift) & 3
        if mode == 0:
            tables[name] = _DEFAULT_TABLES[name]
        elif mode == 1:
            if data[pos] > _MAX_SYMBOL[name]:
                _corrupt("RLE sequence symbol out of range")
            tables[name] = _fse_rle(data[pos])
            pos += 1
        elif mode == 2:
            tables[name], pos = _read_fse_description(
                data[:end], pos, _MAX_LOG[name], _MAX_SYMBOL[name])
        else:
            if name not in state["tables"]:
                _corrupt("repeated sequence table without a previous one")
            tables[name] = state["tables"][name]
    state["tables"] = tables
    stream = data[pos:end]
    ll_sym, ll_bits, ll_base, ll_log = tables["ll"]
    of_sym, of_bits, of_base, of_log = tables["of"]
    ml_sym, ml_bits, ml_base, ml_log = tables["ml"]
    off = _backward_start(stream)
    ll_s, off = _read_back(stream, off, ll_log)
    of_s, off = _read_back(stream, off, of_log)
    ml_s, off = _read_back(stream, off, ml_log)
    out = []
    for k in range(n):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            _corrupt("sequence code out of range")
        v, off = _read_back(stream, off, of_code)
        offset = (1 << of_code) + v
        mb, mn = _ML[ml_code]
        v, off = _read_back(stream, off, mn)
        match = mb + v
        lb, ln = _LL[ll_code]
        v, off = _read_back(stream, off, ln)
        out.append((lb + v, offset, match))
        if k + 1 < n:
            v, off = _read_back(stream, off, ll_bits[ll_s])
            ll_s = ll_base[ll_s] + v
            v, off = _read_back(stream, off, ml_bits[ml_s])
            ml_s = ml_base[ml_s] + v
            v, off = _read_back(stream, off, of_bits[of_s])
            of_s = of_base[of_s] + v
    if off != 0:
        _corrupt("sequence bitstream not consumed exactly")
    return out


def _execute(out: bytearray, literals: bytes, seqs: list, rep: list,
             window: int, frame_start: int) -> None:
    """Append the block's sequences to ``out``, updating ``rep``."""
    lit = 0
    for ll, ov, ml in seqs:
        if ll:
            if lit + ll > len(literals):
                _corrupt("sequence asks for more literals than the block has")
            out += literals[lit:lit + ll]
            lit += ll
        if ov > 3:
            offset = ov - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = ov - 1 + (ll == 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if idx > 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
        have = len(out) - frame_start
        if offset <= 0 or offset > have or offset > window:
            _corrupt("match offset beyond the window")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            chunk = out[start:]
            reps, rest = divmod(ml, offset)
            out += chunk * reps + chunk[:rest]
    out += literals[lit:]


# --- frames --------------------------------------------------------------------------

def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame at ``pos`` (after its magic) into ``out``; the
    position after it."""
    start = len(out)
    fhd = data[pos]
    pos += 1
    single = (fhd >> 5) & 1
    if fhd & 8:
        _corrupt("reserved bit of the frame header is set")
    checksum = (fhd >> 2) & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (single, 2, 4, 8)[fhd >> 6]
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        exp, mant = wd >> 3, wd & 7
        base = 1 << (10 + exp)
        window = base + (base >> 3) * mant
    if did_size:
        if int.from_bytes(data[pos:pos + did_size], "little"):
            raise ZstdError("ZSTD frames with a dictionary are not decoded")
        pos += did_size
    content = None
    if fcs_size:
        content = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content += 256
        pos += fcs_size
    if window is None:
        window = content
    state = {"huffman": None, "tables": {}}
    rep = [1, 4, 8]
    while True:
        if pos + 3 > len(data):
            _corrupt("block header is truncated")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if pos + size > len(data):
                _corrupt("raw block is truncated")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos >= len(data):
                _corrupt("RLE block is truncated")
            out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            end = pos + size
            if end > len(data) or size > _MAX_BLOCK:
                _corrupt("compressed block is truncated or too large")
            literals, p = _literals(data, pos, end, state)
            seqs = _sequences(data, p, end, state)
            _execute(out, literals, seqs, rep, window or (1 << 62), start)
            pos = end
        else:
            _corrupt("reserved block type")
        if last:
            break
    if content is not None and len(out) - start != content:
        _corrupt("frame content size disagrees with its blocks")
    if checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        if pos + 4 > len(data) or \
                xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            _corrupt("content checksum mismatch")
        pos += 4
    return pos


def decompress(data: bytes) -> bytes:
    """Every frame of ``data`` decoded and concatenated (skippable frames
    skipped); ``ZstdError`` (a ``ValueError``) on corrupt data."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    try:
        while pos < len(data):
            magic = int.from_bytes(data[pos:pos + 4], "little")
            if magic & 0xFFFFFFF0 == _SKIPPABLE:
                size = int.from_bytes(data[pos + 4:pos + 8], "little")
                pos += 8 + size
                if pos > len(data):
                    _corrupt("skippable frame is truncated")
                continue
            if magic != _MAGIC:
                _corrupt("not a ZSTD frame")
            pos = _frame(data, pos + 4, out)
    except IndexError:
        raise ZstdError("ZSTD data is corrupt: data ends early") from None
    return bytes(out)


# --- XXH64 --------------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (Zstandard's content checksum is its low 32 bits)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for k in range(0, len(lanes), 4):
            v1 = _rotl((v1 + lanes[k] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[k + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[k + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[k + 3] * _P2) & _M64, 31) * _P1 & _M64
        pos = (n // 32) * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        k1 = _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h ^ k1, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= int.from_bytes(data[pos:pos + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= data[pos] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        pos += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)
