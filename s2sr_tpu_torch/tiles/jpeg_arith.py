"""Arithmetic-coded JPEG scans (SOF9 sequential, SOF10 progressive).

libjpeg-turbo's ``jdarith.c`` in Python: the QM-coder (ITU T.81 Annex D,
its probability estimation table D.2) and the statistical models of
Annex F (sequential DC and AC) and G (progressive first and refinement
passes), with the DAC conditioning (L, U for DC; K for AC; defaults 0,
1, 5). A coding error (a magnitude or spectral overflow) stops the
scan's decoding until the next restart, as libjpeg does; past its
segment the coder reads zeros.
"""

from __future__ import annotations

# T.81 Table D.2, as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS
_QE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
)
ARITAB = tuple((qe << 16) | (nm << 8) | (sw << 7) | nl
               for qe, nl, nm, sw in _QE)


class ArithDecoder:
    """The QM decoder over one entropy-coded segment (stuffing removed)."""

    __slots__ = ("seg", "pos", "c", "a", "ct")

    def __init__(self, seg: bytes):
        self.seg, self.pos = seg, 0
        self.c = self.a = 0
        self.ct = -16                    # read two bytes to fill C first

    def bit(self, st: bytearray, i: int) -> int:
        a, ct = self.a, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                p = self.pos
                data = self.seg[p] if p < len(self.seg) else 0
                self.pos = p + 1
                self.c = (self.c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        temp = a - qe
        a = temp
        temp <<= ct
        if self.c >= temp:
            self.c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.ct = a, ct
        return sv >> 7


class _Overflow(Exception):
    """A magnitude or spectral overflow: libjpeg's ``ct = -1``."""


def _magnitude(dec, st: bytearray, i: int, first: int) -> tuple:
    """Figures F.23 and F.24 from the category bins at ``i`` (``first``:
    the X1 bin of the magnitude chain when the first bit is set) →
    (|v| - 1, the M bins used)."""
    m = dec.bit(st, i)
    if m:
        if first is None:                       # DC: X1 = 20
            i = 20
            while dec.bit(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _Overflow
                i += 1
        elif dec.bit(st, i):
            m <<= 1
            i = first
            while dec.bit(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _Overflow
                i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.bit(st, i):
            v |= m
        m >>= 1
    return v, m


def _wrap16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def decode_scan_arith(segs: list, comps: list, blocks, coef: list, mcus: int,
                      restart: int, dac: dict, ss: int, se: int, ah: int,
                      al: int, progressive: bool, natural: list) -> None:
    """Decode one arithmetic-coded scan into ``coef`` (per component a flat
    int16 memoryview, 64 natural-order coefficients a block)."""
    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not progressive or se > 0
    dc_stats = {c["td"]: bytearray(64) for c in comps}
    ac_stats = {c["ta"]: bytearray(256) for c in comps}
    fixed = bytearray((113,))
    last = [0] * len(comps)
    ctx = [0] * len(comps)
    p1, m1 = 1 << al, -1 << al

    def reset():
        for c in comps:
            if need_dc:
                dc_stats[c["td"]][:] = bytes(64)
            if need_ac:
                ac_stats[c["ta"]][:] = bytes(256)
        last[:] = [0] * len(comps)
        ctx[:] = [0] * len(comps)

    seg = 0
    dec = ArithDecoder(segs[0])
    broken = False
    for m in range(mcus):
        if restart and m and m % restart == 0:
            seg += 1
            dec = ArithDecoder(segs[seg] if seg < len(segs) else b"")
            reset()
            broken = False
        if broken:
            continue
        try:
            for slot, blk in blocks[m]:
                c = comps[slot]
                out = coef[c["index"]]
                base = blk * 64
                if need_dc and (not progressive or ss == 0):
                    st = dc_stats[c["td"]]
                    i = ctx[slot]
                    if dec.bit(st, i) == 0:
                        ctx[slot] = 0
                    else:
                        sign = dec.bit(st, i + 1)
                        mag, _ = _magnitude(dec, st, i + 2 + sign, None)
                        lo, hi = dac.get(("dc", c["td"]), (0, 1))
                        top = mag                     # 2^(category-1)
                        while top & (top - 1):
                            top &= top - 1
                        if top < (1 << lo) >> 1:
                            ctx[slot] = 0
                        elif top > (1 << hi) >> 1:
                            ctx[slot] = 12 + sign * 4
                        else:
                            ctx[slot] = 4 + sign * 4
                        v = mag + 1
                        last[slot] = (last[slot] + (-v if sign else v)) & 0xFFFF
                    out[base] = _wrap16(last[slot] << al)
                    if progressive:
                        continue
                elif progressive and ss == 0:          # DC refinement
                    if dec.bit(fixed, 0):
                        out[base] = _wrap16(out[base] | p1)
                    continue
                if not need_ac:
                    continue
                st = ac_stats[c["ta"]]
                kk = dac.get(("ac", c["ta"]), 5)
                if progressive and ah:                 # AC refinement
                    kex = se
                    while kex > 0 and not out[base + natural[kex]]:
                        kex -= 1
                    k = ss
                    while k <= se:
                        i = 3 * (k - 1)
                        if k > kex and dec.bit(st, i):
                            break
                        while True:
                            at = base + natural[k]
                            cur = out[at]
                            if cur:
                                if dec.bit(st, i + 2):
                                    out[at] = _wrap16(cur + (m1 if cur < 0 else p1))
                                break
                            if dec.bit(st, i + 1):
                                out[at] = m1 if dec.bit(fixed, 0) else p1
                                break
                            i += 3
                            k += 1
                            if k > se:
                                raise _Overflow
                        k += 1
                    continue
                k = ss if progressive else 1
                end = se if progressive else 63
                while k <= end:
                    i = 3 * (k - 1)
                    if dec.bit(st, i):                # end of block
                        break
                    while dec.bit(st, i + 1) == 0:
                        i += 3
                        k += 1
                        if k > end:
                            raise _Overflow
                    sign = dec.bit(fixed, 0)
                    i += 2
                    v = dec.bit(st, i)
                    if v:
                        if dec.bit(st, i):
                            v = 2
                            i = 189 if k <= kk else 217
                            while dec.bit(st, i):
                                v <<= 1
                                if v == 0x8000:
                                    raise _Overflow
                                i += 1
                    mag = v
                    i += 14
                    v >>= 1
                    while v:
                        if dec.bit(st, i):
                            mag |= v
                        v >>= 1
                    mag += 1
                    out[base + natural[k]] = _wrap16((-mag if sign else mag) << al)
                    k += 1
        except _Overflow:
            broken = True
