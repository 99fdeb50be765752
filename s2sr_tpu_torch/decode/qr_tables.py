"""QR symbol tables (versions 1-40, all four EC levels).

Sources: ISO/IEC 18004 table data (public spec constants). Every entry
is invariant-checked in tests: group sizes must sum to the version's
total codeword count derived from module geometry, and group-2 blocks
carry exactly one more data byte than group 1.

Versions 1-10 are hand-entered from the spec; versions 11-40 were
derived *empirically against the OpenCV QR codec* (see
``scripts/derive_qr_tables.py``): alignment coordinates read out of
cv2-encoded symbols (intersected over several payloads), and EC block
structures found by searching the small space of structurally-possible
(ec, blocks) splits for the unique one whose Reed-Solomon parity and
interleave a conformant decoder accepts — validated in BOTH directions
(our encoder → cv2 decoder, cv2 encoder → our decoder). v21 uses the
spec values directly because cv2's own v21 encoder fails to round-trip
(its symbols carry a misplaced alignment pattern). The derived v40 row
equals the well-known published values, and every entry satisfies the
total-codeword geometry invariant (asserted in tests).

A copy of the JAX package's ``decode/qr_tables.py`` (the port imports
nothing of that package).
"""

from __future__ import annotations

MAX_VERSION = 40

# EC level two-bit codes as they appear in the (unmasked) format info.
ECL_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}
ECL_FROM_BITS = {v: k for k, v in ECL_BITS.items()}

# version -> level -> (ec_per_block, [(num_blocks, data_codewords), ...])
EC_BLOCKS: dict[int, dict[str, tuple[int, list[tuple[int, int]]]]] = {
    1: {"L": (7, [(1, 19)]), "M": (10, [(1, 16)]),
        "Q": (13, [(1, 13)]), "H": (17, [(1, 9)])},
    2: {"L": (10, [(1, 34)]), "M": (16, [(1, 28)]),
        "Q": (22, [(1, 22)]), "H": (28, [(1, 16)])},
    3: {"L": (15, [(1, 55)]), "M": (26, [(1, 44)]),
        "Q": (18, [(2, 17)]), "H": (22, [(2, 13)])},
    4: {"L": (20, [(1, 80)]), "M": (18, [(2, 32)]),
        "Q": (26, [(2, 24)]), "H": (16, [(4, 9)])},
    5: {"L": (26, [(1, 108)]), "M": (24, [(2, 43)]),
        "Q": (18, [(2, 15), (2, 16)]), "H": (22, [(2, 11), (2, 12)])},
    6: {"L": (18, [(2, 68)]), "M": (16, [(4, 27)]),
        "Q": (24, [(4, 19)]), "H": (28, [(4, 15)])},
    7: {"L": (20, [(2, 78)]), "M": (18, [(4, 31)]),
        "Q": (18, [(2, 14), (4, 15)]), "H": (26, [(4, 13), (1, 14)])},
    8: {"L": (24, [(2, 97)]), "M": (22, [(2, 38), (2, 39)]),
        "Q": (22, [(4, 18), (2, 19)]), "H": (26, [(4, 14), (2, 15)])},
    9: {"L": (30, [(2, 116)]), "M": (22, [(3, 36), (2, 37)]),
        "Q": (20, [(4, 16), (4, 17)]), "H": (24, [(4, 12), (4, 13)])},
    10: {"L": (18, [(2, 68), (2, 69)]), "M": (26, [(4, 43), (1, 44)]),
         "Q": (24, [(6, 19), (2, 20)]), "H": (28, [(6, 15), (2, 16)])},
}

# version -> alignment pattern centre coordinates (row and column)
ALIGNMENT: dict[int, list[int]] = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30],
    6: [6, 34], 7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46],
    10: [6, 28, 50],
}

_ALIGN_HI = {
    11: [6, 30, 54],
    12: [6, 32, 58],
    13: [6, 34, 62],
    14: [6, 26, 46, 66],
    15: [6, 26, 48, 70],
    16: [6, 26, 50, 74],
    17: [6, 30, 54, 78],
    18: [6, 30, 56, 82],
    19: [6, 30, 58, 86],
    20: [6, 34, 62, 90],
    21: [6, 28, 50, 72, 94],
    22: [6, 26, 50, 74, 98],
    23: [6, 30, 54, 78, 102],
    24: [6, 28, 54, 80, 106],
    25: [6, 32, 58, 84, 110],
    26: [6, 30, 58, 86, 114],
    27: [6, 34, 62, 90, 118],
    28: [6, 26, 50, 74, 98, 122],
    29: [6, 30, 54, 78, 102, 126],
    30: [6, 26, 52, 78, 104, 130],
    31: [6, 30, 56, 82, 108, 134],
    32: [6, 34, 60, 86, 112, 138],
    33: [6, 30, 58, 86, 114, 142],
    34: [6, 34, 62, 90, 118, 146],
    35: [6, 30, 54, 78, 102, 126, 150],
    36: [6, 24, 50, 76, 102, 128, 154],
    37: [6, 28, 54, 80, 106, 132, 158],
    38: [6, 32, 58, 84, 110, 136, 162],
    39: [6, 26, 54, 82, 110, 138, 166],
    40: [6, 30, 58, 86, 114, 142, 170],
}

_EC_HI = {
    11: {"L": (20, [(4, 81)]), "M": (30, [(1, 50), (4, 51)]),
        "Q": (28, [(4, 22), (4, 23)]), "H": (24, [(3, 12), (8, 13)])},
    12: {"L": (24, [(2, 92), (2, 93)]), "M": (22, [(6, 36), (2, 37)]),
        "Q": (26, [(4, 20), (6, 21)]), "H": (28, [(7, 14), (4, 15)])},
    13: {"L": (26, [(4, 107)]), "M": (22, [(8, 37), (1, 38)]),
        "Q": (24, [(8, 20), (4, 21)]), "H": (22, [(12, 11), (4, 12)])},
    14: {"L": (30, [(3, 115), (1, 116)]), "M": (24, [(4, 40), (5, 41)]),
        "Q": (20, [(11, 16), (5, 17)]), "H": (24, [(11, 12), (5, 13)])},
    15: {"L": (22, [(5, 87), (1, 88)]), "M": (24, [(5, 41), (5, 42)]),
        "Q": (30, [(5, 24), (7, 25)]), "H": (24, [(11, 12), (7, 13)])},
    16: {"L": (24, [(5, 98), (1, 99)]), "M": (28, [(7, 45), (3, 46)]),
        "Q": (24, [(15, 19), (2, 20)]), "H": (30, [(3, 15), (13, 16)])},
    17: {"L": (28, [(1, 107), (5, 108)]), "M": (28, [(10, 46), (1, 47)]),
        "Q": (28, [(1, 22), (15, 23)]), "H": (28, [(2, 14), (17, 15)])},
    18: {"L": (30, [(5, 120), (1, 121)]), "M": (26, [(9, 43), (4, 44)]),
        "Q": (28, [(17, 22), (1, 23)]), "H": (28, [(2, 14), (19, 15)])},
    19: {"L": (28, [(3, 113), (4, 114)]), "M": (26, [(3, 44), (11, 45)]),
        "Q": (26, [(17, 21), (4, 22)]), "H": (26, [(9, 13), (16, 14)])},
    20: {"L": (28, [(3, 107), (5, 108)]), "M": (26, [(3, 41), (13, 42)]),
        "Q": (30, [(15, 24), (5, 25)]), "H": (28, [(15, 15), (10, 16)])},
    21: {"L": (28, [(4, 116), (4, 117)]), "M": (26, [(17, 42)]),
        "Q": (28, [(17, 22), (6, 23)]), "H": (30, [(19, 16), (6, 17)])},
    22: {"L": (28, [(2, 111), (7, 112)]), "M": (28, [(17, 46)]),
        "Q": (30, [(7, 24), (16, 25)]), "H": (24, [(34, 13)])},
    23: {"L": (30, [(4, 121), (5, 122)]), "M": (28, [(4, 47), (14, 48)]),
        "Q": (30, [(11, 24), (14, 25)]), "H": (30, [(16, 15), (14, 16)])},
    24: {"L": (30, [(6, 117), (4, 118)]), "M": (28, [(6, 45), (14, 46)]),
        "Q": (30, [(11, 24), (16, 25)]), "H": (30, [(30, 16), (2, 17)])},
    25: {"L": (26, [(8, 106), (4, 107)]), "M": (28, [(8, 47), (13, 48)]),
        "Q": (30, [(7, 24), (22, 25)]), "H": (30, [(22, 15), (13, 16)])},
    26: {"L": (28, [(10, 114), (2, 115)]), "M": (28, [(19, 46), (4, 47)]),
        "Q": (28, [(28, 22), (6, 23)]), "H": (30, [(33, 16), (4, 17)])},
    27: {"L": (30, [(8, 122), (4, 123)]), "M": (28, [(22, 45), (3, 46)]),
        "Q": (30, [(8, 23), (26, 24)]), "H": (30, [(12, 15), (28, 16)])},
    28: {"L": (30, [(3, 117), (10, 118)]), "M": (28, [(3, 45), (23, 46)]),
        "Q": (30, [(4, 24), (31, 25)]), "H": (30, [(11, 15), (31, 16)])},
    29: {"L": (30, [(7, 116), (7, 117)]), "M": (28, [(21, 45), (7, 46)]),
        "Q": (30, [(1, 23), (37, 24)]), "H": (30, [(19, 15), (26, 16)])},
    30: {"L": (30, [(5, 115), (10, 116)]), "M": (28, [(19, 47), (10, 48)]),
        "Q": (30, [(15, 24), (25, 25)]), "H": (30, [(23, 15), (25, 16)])},
    31: {"L": (30, [(13, 115), (3, 116)]), "M": (28, [(2, 46), (29, 47)]),
        "Q": (30, [(42, 24), (1, 25)]), "H": (30, [(23, 15), (28, 16)])},
    32: {"L": (30, [(17, 115)]), "M": (28, [(10, 46), (23, 47)]),
        "Q": (30, [(10, 24), (35, 25)]), "H": (30, [(19, 15), (35, 16)])},
    33: {"L": (30, [(17, 115), (1, 116)]), "M": (28, [(14, 46), (21, 47)]),
        "Q": (30, [(29, 24), (19, 25)]), "H": (30, [(11, 15), (46, 16)])},
    34: {"L": (30, [(13, 115), (6, 116)]), "M": (28, [(14, 46), (23, 47)]),
        "Q": (30, [(44, 24), (7, 25)]), "H": (30, [(59, 16), (1, 17)])},
    35: {"L": (30, [(12, 121), (7, 122)]), "M": (28, [(12, 47), (26, 48)]),
        "Q": (30, [(39, 24), (14, 25)]), "H": (30, [(22, 15), (41, 16)])},
    36: {"L": (30, [(6, 121), (14, 122)]), "M": (28, [(6, 47), (34, 48)]),
        "Q": (30, [(46, 24), (10, 25)]), "H": (30, [(2, 15), (64, 16)])},
    37: {"L": (30, [(17, 122), (4, 123)]), "M": (28, [(29, 46), (14, 47)]),
        "Q": (30, [(49, 24), (10, 25)]), "H": (30, [(24, 15), (46, 16)])},
    38: {"L": (30, [(4, 122), (18, 123)]), "M": (28, [(13, 46), (32, 47)]),
        "Q": (30, [(48, 24), (14, 25)]), "H": (30, [(42, 15), (32, 16)])},
    39: {"L": (30, [(20, 117), (4, 118)]), "M": (28, [(40, 47), (7, 48)]),
        "Q": (30, [(43, 24), (22, 25)]), "H": (30, [(10, 15), (67, 16)])},
    40: {"L": (30, [(19, 118), (6, 119)]), "M": (28, [(18, 47), (31, 48)]),
        "Q": (30, [(34, 24), (34, 25)]), "H": (30, [(20, 15), (61, 16)])},
}

EC_BLOCKS.update(_EC_HI)
ALIGNMENT.update(_ALIGN_HI)


FORMAT_MASK = 0b101010000010010
FORMAT_GEN = 0b10100110111        # BCH(15,5) generator x^10+x^8+x^5+x^4+x^2+x+1
VERSION_GEN = 0b1111100100101     # BCH(18,6) generator for version info


def bch_version(version: int) -> int:
    """18-bit version information word (6 data bits + 12 BCH bits)."""
    v = version << 12
    rem = v
    for i in range(5, -1, -1):
        if rem & (1 << (i + 12)):
            rem ^= VERSION_GEN << i
    return v | rem


def size_for_version(version: int) -> int:
    return 4 * version + 17


def version_for_size(size: int) -> int:
    if size < 21 or (size - 17) % 4:
        raise ValueError(f"invalid QR size {size}")
    return (size - 17) // 4


def bch_format(data5: int) -> int:
    """15-bit format word (5 data bits + 10 BCH bits), pre-mask."""
    v = data5 << 10
    rem = v
    for i in range(4, -1, -1):
        if rem & (1 << (i + 10)):
            rem ^= FORMAT_GEN << i
    return v | rem


# All 32 valid masked format words, index = (ecl_bits << 3) | mask_id.
FORMAT_WORDS = [bch_format(i) ^ FORMAT_MASK for i in range(32)]


def total_codewords(version: int) -> int:
    """Data+EC codeword count derived from module geometry (spec §7.1)."""
    size = size_for_version(version)
    modules = size * size
    modules -= 3 * 64                      # finder + separator 8×8 each
    align = ALIGNMENT[version]
    n_align = len(align) ** 2 - 3 if align else 0
    modules -= n_align * 25
    timing = (size - 16) * 2
    if align:
        # alignment patterns sitting on the timing rows already counted
        timing -= (len(align) - 2) * 2 * 5
    modules -= timing
    modules -= 31                          # format info + dark module
    if version >= 7:
        modules -= 36
    return modules // 8


def data_capacity(version: int, level: str) -> int:
    ec, groups = EC_BLOCKS[version][level]
    return sum(n * d for n, d in groups)


def mask_fn(mask_id: int):
    return [
        lambda r, c: (r + c) % 2 == 0,
        lambda r, c: r % 2 == 0,
        lambda r, c: c % 3 == 0,
        lambda r, c: (r + c) % 3 == 0,
        lambda r, c: (r // 2 + c // 3) % 2 == 0,
        lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
        lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
        lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
    ][mask_id]
