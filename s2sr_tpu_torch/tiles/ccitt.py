"""CCITT fax strips (TIFF compressions 2, 3 and 4) decoded in Python.

libtiff's codecs, as PIL opens them: Modified Huffman run lengths with
every row on a byte boundary (compression 2, ``tiff_ccitt``); ITU T.4
(compression 3, ``group3``) with an EOL before each row, fill bits before
an EOL when ``T4Options`` (tag 292) bit 2 is set, and 1-D rows only or,
with bit 0, a tag bit per row choosing a 1-D row or a 2-D one coded
against the row above; ITU T.6 (compression 4, ``group4``): 2-D rows
only, the first against an all-white row. Uncompressed mode (the
extension code) is refused, as libtiff refuses it.

A row comes out as libtiff gives it: a white run as 0 bits, a black run
as 1 bits; the photometric interpretation is applied by the caller.
``FillOrder`` 2 (bits stored least significant first) is read by
reversing each byte, as libtiff's fax reader does.

A T.6 strip that ends early is decoded as libtiff's ``Fax4Decode``
decodes it ("don't error on badly-terminated strips"): past the end of
the data it reads zeros while bits remain in its accumulator, the row it
was in is filled with the runs it had, and the strip stops there; the
rows never reached are left as 0 samples (PIL hands back its buffer,
whose bytes there were never written). If no row was complete, the
strip is refused, as libtiff refuses it. T.4 and Modified Huffman
strips cut short are refused, as libtiff refuses them.
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
# 2-D modes: pass, horizontal, vertical a1 − b1 ∈ −3..3, extension
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2,
          "0000011": 3, "010": -1, "000010": -2, "0000010": -3,
          "0000001": "X"}
_PEEK = 13


def _table(codes: dict) -> tuple:
    """(value, code length) per 13-bit peek; length 0 where no code
    starts."""
    val = [0] * (1 << _PEEK)
    length = [0] * (1 << _PEEK)
    for code, v in codes.items():
        n = len(code)
        at = int(code, 2) << (_PEEK - n)
        span = 1 << (_PEEK - n)
        val[at:at + span] = [v] * span
        length[at:at + span] = [n] * span
    return val, length


def _runs(term: list, makeup: list) -> dict:
    codes = {c: i for i, c in enumerate(term)}
    codes.update({c: 64 * (i + 1) for i, c in enumerate(makeup)})
    codes.update({c: 1792 + 64 * i for i, c in enumerate(_EXT_MAKEUP)})
    return codes


_WHITE = _table(_runs(_WHITE_TERM, _WHITE_MAKEUP))
_BLACK = _table(_runs(_BLACK_TERM, _BLACK_MAKEUP))
_MODE = _table(_MODES)
_REVERSE = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


class _Bits:
    """MSB-first bits of a strip; reads past its end give zeros."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.end = data, 0, len(data) * 8

    def peek(self) -> int:
        i = self.pos >> 3
        w = int.from_bytes(self.data[i:i + 4].ljust(4, b"\0"), "big")
        return (w >> (32 - _PEEK - (self.pos & 7))) & ((1 << _PEEK) - 1)

    def code(self, table: tuple, what: str):
        if self.pos >= self.end:
            raise ValueError("CCITT strip ends inside a row")
        v = self.peek()
        n = table[1][v]
        if n == 0:
            raise ValueError(f"CCITT strip holds an invalid {what} code")
        self.pos += n
        return table[0][v]

    def run(self, black: bool) -> int:
        total = 0
        while True:
            r = self.code(_BLACK if black else _WHITE, "run-length")
            total += r
            if r < 64:
                return total

    def eol(self) -> None:
        """Skip to just after the next EOL (11+ zeros, then a 1)."""
        zeros = 0
        while self.pos < self.end:
            if self.bit():
                if zeros >= 11:
                    return
                raise ValueError("CCITT strip lacks the EOL of a row")
            zeros += 1
        raise ValueError("CCITT strip ends before a row's EOL")

    def bit(self) -> int:
        if self.pos >= self.end:
            raise ValueError("CCITT strip ends inside a row")
        b = (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _push(changes: list, c: int) -> None:
    """Append a changing element; a zero-length run (two changes at one
    position) cancels out."""
    if changes and changes[-1] == c:
        changes.pop()
    else:
        changes.append(c)


def _row_1d(bits: _Bits, width: int) -> list:
    """Changing elements of a Modified Huffman row."""
    changes: list = []
    a0, black = 0, False
    while a0 < width:
        a0 += bits.run(black)
        if a0 > width:
            raise ValueError("CCITT row is longer than the image")
        _push(changes, a0)
        black = not black
    return changes


def _row_2d(bits: _Bits, width: int, ref: list) -> list:
    """Changing elements of a 2-D row coded against ``ref``'s (a change
    at an even index turns black, at an odd one white)."""
    changes: list = []
    a0, black = -1, False
    n = len(ref)
    while a0 < width:
        # b1: the first change of ref right of a0 to the colour a0 is not
        i = bisect_right(ref, a0)
        if i % 2 != black:
            i += 1
        b1 = ref[i] if i < n else width
        b2 = ref[i + 1] if i + 1 < n else width
        mode = bits.code(_MODE, "mode")
        if mode == "P":
            a0 = b2
        elif mode == "H":
            a1 = max(a0, 0) + bits.run(black)
            a2 = a1 + bits.run(not black)
            if a2 > width:
                raise ValueError("CCITT row is longer than the image")
            _push(changes, a1)
            _push(changes, a2)
            a0 = a2
        elif mode == "X":
            raise ValueError("CCITT uncompressed mode is not decoded")
        else:
            a1 = b1 + mode
            if a1 < max(a0, 0) or a1 > width:
                raise ValueError("CCITT vertical mode leaves the row")
            _push(changes, a1)
            a0 = a1
            black = not black
    return changes


def _pixels(changes: list, width: int) -> np.ndarray:
    """0/1 (white/black) samples of one row from its changing elements."""
    row = np.zeros(width + 1, np.int8)
    row[changes[0::2]] += 1
    row[changes[1::2]] -= 1
    return (np.cumsum(row[:width]) > 0).astype(np.uint8)


def decode_fax(data: bytes, compression: int, width: int, rows: int,
               t4_options: int = 0, fill_order: int = 1) -> np.ndarray:
    """One strip or tile → (rows, width) 0/1 samples (1 = black run)."""
    data = bytes(data)
    if fill_order == 2:
        data = data.translate(_REVERSE)
    try:
        return _decode(data, compression, width, rows, t4_options)
    except ValueError:
        if compression != 4:
            raise
        out, _written, stopped = fax4_libtiff(data, width, rows)
        if not stopped:
            raise
        return out


def _decode(data: bytes, compression: int, width: int, rows: int,
            t4_options: int) -> np.ndarray:
    bits = _Bits(data)
    out = np.zeros((rows, width), np.uint8)
    ref: list = []
    for y in range(rows):
        if compression == 2:
            bits.align()
            changes = _row_1d(bits, width)
        elif compression == 3:
            bits.eol()
            two_d = False
            if t4_options & 1:
                two_d = bits.bit() == 0
            changes = (_row_2d(bits, width, ref) if two_d
                       else _row_1d(bits, width))
        elif compression == 4:
            changes = _row_2d(bits, width, ref)
        else:
            raise ValueError(f"TIFF compression {compression} is not fax")
        out[y] = _pixels(changes, width)
        ref = [c for c in changes if c < width]
    return out


# --- T.6 as libtiff's Fax4Decode reads a strip that ends early --------------
#
# libtiff's tables (tif_fax3sm.c): a 7-bit lookup for the 2-D modes, 12
# bits for white runs, 13 for black; 7 zero bits are an EOL in the first,
# 11 in the others; a lookup that matches no code consumes nothing.


def _libtiff_table(width: int, codes: dict) -> list:
    """(state, length, param) per ``width``-bit peek."""
    table = [("null", 0, 0)] * (1 << width)
    for code, entry in codes.items():
        at = int(code, 2) << (width - len(code))
        table[at:at + (1 << (width - len(code)))] = \
            [entry] * (1 << (width - len(code)))
    return table


def _libtiff_runs(term: list, makeup: list) -> dict:
    codes = {c: ("term", len(c), i) for i, c in enumerate(term)}
    codes.update({c: ("makeup", len(c), 64 * (i + 1))
                  for i, c in enumerate(makeup)})
    codes.update({c: ("makeup", len(c), 1792 + 64 * i)
                  for i, c in enumerate(_EXT_MAKEUP)})
    codes["0" * 11] = ("eol", 11, 0)
    return codes


_LT_MAIN = _libtiff_table(7, {
    "0001": ("pass", 4, 0), "001": ("horiz", 3, 0), "1": ("v0", 1, 0),
    "011": ("vr", 3, 1), "000011": ("vr", 6, 2), "0000011": ("vr", 7, 3),
    "010": ("vl", 3, 1), "000010": ("vl", 6, 2), "0000010": ("vl", 7, 3),
    "0000001": ("ext", 7, 0), "0000000": ("eol", 7, 0)})
_LT_WHITE = _libtiff_table(12, _libtiff_runs(_WHITE_TERM, _WHITE_MAKEUP))
_LT_BLACK = _libtiff_table(13, _libtiff_runs(_BLACK_TERM, _BLACK_MAKEUP))


class _Eof(Exception):
    """The data ran out with no bit left in the accumulator."""


class _BadCode(Exception):
    """A code libtiff reports and skips to the end of the row on."""


class _Acc:
    """libtiff's bit accumulator (``NeedBits8``/``NeedBits16``): bytes
    are loaded as a lookup needs them; past the end of the data a lookup
    is padded with zeros unless the accumulator is empty."""

    def __init__(self, data: bytes):
        self.data, self.cp, self.acc, self.avail = data, 0, 0, 0

    def need(self, n: int) -> None:
        while self.avail < n:
            if self.cp >= len(self.data):
                if self.avail == 0:
                    raise _Eof
                self.acc <<= n - self.avail
                self.avail = n
            else:
                self.acc = (self.acc << 8) | self.data[self.cp]
                self.cp += 1
                self.avail += 8

    def get(self, n: int) -> int:
        return (self.acc >> (self.avail - n)) & ((1 << n) - 1)

    def clear(self, n: int) -> None:
        self.avail -= n
        self.acc &= (1 << max(self.avail, 0)) - 1

    def lookup(self, width: int, table: list) -> tuple:
        self.need(width)
        entry = table[self.get(width)]
        self.clear(entry[1])
        return entry


class _Fax4:
    """The state of libtiff's 2-D decoder over one strip: one run array
    of 2·nruns entries, zeroed, whose halves are the row being decoded
    and the reference row (runs alternate white, black)."""

    def __init__(self, data: bytes, width: int):
        self.bits = _Acc(data)
        self.lastx = width
        self.nruns = 2 * ((width + 31) // 32 * 32)
        self.runs = [0] * (2 * self.nruns)
        self.cur, self.ref = 0, self.nruns
        self.runs[self.ref] = width          # the reference: one white row
        self.eol = False

    def setvalue(self, x: int) -> None:
        if self.pa >= self.cur + self.nruns:
            raise ValueError("CCITT row overflows libtiff's run buffer")
        self.runs[self.pa] = self.run_length + x
        self.pa += 1
        self.a0 += x
        self.run_length = 0

    def check_b1(self) -> None:
        if self.pa != self.cur:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.ref + self.nruns:
                    raise ValueError("CCITT reference row overflow")
                self.b1 += self.runs[self.pb] + self.runs[self.pb + 1]
                self.pb += 2

    def next_b(self) -> int:
        v = self.runs[self.pb]
        self.pb += 1
        return v

    def horizontal(self) -> None:
        """Two runs, the first in the colour of the run being coded."""
        order = ((_LT_WHITE, 12), (_LT_BLACK, 13))
        if (self.pa - self.cur) & 1:
            order = order[::-1]
        for table, width in order:
            while True:
                state, _, param = self.bits.lookup(width, table)
                if state == "term":
                    self.setvalue(param)
                    break
                if state != "makeup":
                    raise _BadCode
                self.a0 += param
                self.run_length += param

    def expand2d(self) -> bool:
        """One row (``EXPAND2D``); False where the data ran out."""
        lastx = self.lastx
        try:
            try:
                while self.a0 < lastx:
                    if self.pa >= self.cur + self.nruns:
                        raise ValueError("CCITT row overflows libtiff's "
                                         "run buffer")
                    state, _, param = self.bits.lookup(7, _LT_MAIN)
                    if state == "pass":
                        self.check_b1()
                        if self.pb + 1 >= self.ref + self.nruns:
                            raise ValueError("CCITT reference row overflow")
                        self.b1 += self.next_b()
                        self.run_length += self.b1 - self.a0
                        self.a0 = self.b1
                        self.b1 += self.next_b()
                    elif state == "horiz":
                        self.horizontal()
                        self.check_b1()
                    elif state == "v0" or state == "vr":
                        self.check_b1()
                        self.setvalue(self.b1 - self.a0 + param)
                        self.b1 += self.next_b()
                    elif state == "vl":
                        self.check_b1()
                        if self.b1 < self.a0 + param:
                            raise _BadCode
                        self.setvalue(self.b1 - self.a0 - param)
                        self.pb -= 1
                        self.b1 -= self.runs[self.pb]
                    else:                      # ext, eol
                        self.runs[self.pa] = lastx - self.a0
                        self.pa += 1
                        if state == "eol":
                            self.bits.need(4)
                            self.bits.clear(4)
                            self.eol = True
                        raise _BadCode
                if self.run_length:
                    if self.run_length + self.a0 < lastx:
                        self.bits.need(1)
                        if not self.bits.get(1):
                            raise _BadCode
                        self.bits.clear(1)
                    self.setvalue(0)
            except _BadCode:
                pass
        except _Eof:
            self.cleanup()
            return False
        self.cleanup()
        return True

    def cleanup(self) -> None:
        """``CLEANUP_RUNS``: a row that does not end at its width is cut
        or padded with white."""
        lastx = self.lastx
        if self.run_length:
            self.setvalue(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > self.cur:
                self.pa -= 1
                self.a0 -= self.runs[self.pa]
            if self.a0 < lastx:
                self.a0 = max(self.a0, 0)
                if (self.pa - self.cur) & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)

    def fill(self, row: np.ndarray) -> None:
        """``_TIFFFax3fillruns``: the runs in order, each cut at the
        row's end (in the run array too)."""
        runs, x, lastx = self.runs, 0, self.lastx
        end = self.pa
        if (end - self.cur) & 1:
            runs[end] = 0
            end += 1
        for i in range(self.cur, end):
            run = runs[i]
            if x + run > lastx or run > lastx:
                runs[i] = run = lastx - x
            if run:
                row[x:x + run] = (i - self.cur) & 1
                x += run


def fax4_libtiff(data: bytes, width: int, rows: int) -> tuple:
    """A T.6 strip decoded as libtiff decodes it → ((rows, width) 0/1
    samples, rows written, whether the strip stopped early: the data ran
    out or an EOL came). Rows past the one it stopped in stay 0. Raises
    where libtiff fails the strip: it stopped before any row was
    complete."""
    st = _Fax4(bytes(data), width)
    out = np.zeros((rows, width), np.uint8)
    for y in range(rows):
        st.a0 = st.run_length = 0
        st.pa = st.cur
        st.pb = st.ref
        st.b1 = st.next_b()
        if not st.expand2d() or st.eol:
            st.fill(out[y])
            if y == 0:
                raise ValueError("CCITT strip ends before its first row")
            return out, y + 1, True
        st.fill(out[y])
        st.setvalue(0)                 # the reference's closing change
        st.cur, st.ref = st.ref, st.cur
    return out, rows, False
