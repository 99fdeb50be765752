"""QR encoder (versions 1-40, all EC levels, standard mask selection).

Companion to :mod:`.qr_decode`: generates test vectors, and serves the
`/api/decode` demo page. Produces a boolean module matrix (True = dark)
with standard penalty-scored mask choice, interoperable with any
conformant reader (tests verify against cv2's detector).

A copy of the JAX package's ``decode/qr_encode.py`` (the port imports
nothing of that package).
"""

from __future__ import annotations

import numpy as np

from .galois import rs_encode
from .qr_decode import ALNUM, _function_mask
from .qr_tables import (
    ALIGNMENT, EC_BLOCKS, ECL_BITS, FORMAT_WORDS, MAX_VERSION,
    bch_version, data_capacity, mask_fn, size_for_version,
)


def _pick_mode(text: str) -> int:
    # isascii() guard: str.isdigit() is True for Unicode digits
    # (e.g. '٣', '²') which int() would mangle or reject
    if text.isascii() and text.isdigit():
        return 1
    if all(c in ALNUM for c in text):
        return 2
    return 4


def _count_bits(mode: int, version: int) -> int:
    tier = 0 if version <= 9 else (1 if version <= 26 else 2)
    return {1: (10, 12, 14), 2: (9, 11, 13), 4: (8, 16, 16)}[mode][tier]


def _encoded_bits(text: str, mode: int, version: int) -> list[int]:
    bits: list[int] = []

    def push(v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            bits.append((v >> i) & 1)

    push(mode, 4)
    data = text.encode("utf-8")
    n_chars = len(text) if mode != 4 else len(data)
    push(n_chars, _count_bits(mode, version))
    if mode == 1:
        for i in range(0, len(text), 3):
            chunk = text[i:i + 3]
            push(int(chunk), {3: 10, 2: 7, 1: 4}[len(chunk)])
    elif mode == 2:
        for i in range(0, len(text), 2):
            chunk = text[i:i + 2]
            if len(chunk) == 2:
                push(ALNUM.index(chunk[0]) * 45 + ALNUM.index(chunk[1]), 11)
            else:
                push(ALNUM.index(chunk[0]), 6)
    else:
        for b in data:
            push(b, 8)
    return bits


def _choose_version(text: str, mode: int, level: str) -> int:
    for v in range(1, MAX_VERSION + 1):
        need = len(_encoded_bits(text, mode, v))
        if need <= data_capacity(v, level) * 8:
            return v
    raise ValueError(f"payload too long for version ≤{MAX_VERSION} at level {level}")


def _codewords(text: str, mode: int, version: int, level: str) -> np.ndarray:
    cap = data_capacity(version, level)
    bits = _encoded_bits(text, mode, version)
    if len(bits) > cap * 8:
        raise ValueError(
            f"payload needs {len(bits)} bits but version {version} level "
            f"{level} holds {cap * 8}")
    bits += [0] * min(4, cap * 8 - len(bits))          # terminator
    while len(bits) % 8:
        bits.append(0)
    data = [int("".join(map(str, bits[i:i + 8])), 2)
            for i in range(0, len(bits), 8)]
    pad = (0xEC, 0x11)
    i = 0
    while len(data) < cap:
        data.append(pad[i % 2])
        i += 1
    data = np.array(data, np.int32)

    ec, groups = EC_BLOCKS[version][level]
    sizes = [d for n, d in groups for _ in range(n)]
    blocks, ecs = [], []
    off = 0
    for s in sizes:
        cw = rs_encode(data[off:off + s], ec)
        blocks.append(cw[:s])
        ecs.append(cw[s:])
        off += s
    out = []
    for i in range(max(sizes)):
        for b in blocks:
            if i < len(b):
                out.append(int(b[i]))
    for i in range(ec):
        for e in ecs:
            out.append(int(e[i]))
    return np.array(out, np.int32)


def _place_function_patterns(m: np.ndarray, version: int) -> None:
    size = m.shape[0]

    def finder(r0: int, c0: int) -> None:
        m[r0:r0 + 7, c0:c0 + 7] = True
        m[r0 + 1:r0 + 6, c0 + 1:c0 + 6] = False
        m[r0 + 2:r0 + 5, c0 + 2:c0 + 5] = True

    finder(0, 0)
    finder(0, size - 7)
    finder(size - 7, 0)
    for i in range(8, size - 8):
        m[6, i] = m[i, 6] = i % 2 == 0
    centers = ALIGNMENT[version]
    for r in centers:
        for c in centers:
            if (r < 9 and c < 9) or (r < 9 and c > size - 10) \
                    or (r > size - 10 and c < 9):
                continue
            m[r - 2:r + 3, c - 2:c + 3] = True
            m[r - 1:r + 2, c - 1:c + 2] = False
            m[r, c] = True
    m[size - 8, 8] = True                   # dark module
    if version >= 7:
        # version information: 18 BCH bits, bit i at (i//3, size-11+i%3)
        # and its transpose (zxing placement order)
        word = bch_version(version)
        for i in range(18):
            bit = bool((word >> i) & 1)
            r, c = i // 3, size - 11 + i % 3
            m[r, c] = bit
            m[c, r] = bit


def _place_format(m: np.ndarray, level: str, mask_id: int) -> None:
    size = m.shape[0]
    word = FORMAT_WORDS[(ECL_BITS[level] << 3) | mask_id]
    bits = [(word >> (14 - i)) & 1 for i in range(15)]
    c1_pos = [(8, c) for c in (0, 1, 2, 3, 4, 5, 7, 8)] + \
             [(r, 8) for r in (7, 5, 4, 3, 2, 1, 0)]
    c2_pos = [(size - 1 - r, 8) for r in range(7)] + \
             [(8, size - 8 + c) for c in range(8)]
    for (r, c), b in zip(c1_pos, bits):
        m[r, c] = bool(b)
    for (r, c), b in zip(c2_pos, bits):
        m[r, c] = bool(b)


def _place_data(m: np.ndarray, func: np.ndarray, cw: np.ndarray,
                mask_id: int) -> None:
    size = m.shape[0]
    bits = np.unpackbits(cw.astype(np.uint8)[:, None], axis=1).ravel()
    mfn = mask_fn(mask_id)
    k = 0
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if func[r, c]:
                    continue
                v = int(bits[k]) if k < len(bits) else 0
                k += 1
                if mfn(r, c):
                    v ^= 1
                m[r, c] = bool(v)
        upward = not upward
        col -= 2


def _runs_penalty(rows: np.ndarray) -> int:
    """N1 for a batch of rows: 3 + (run-5) for every run ≥ 5."""
    n, size = rows.shape
    score = 0
    for row in rows:          # row count is ≤ 2·177; inner work is numpy
        edges = np.flatnonzero(np.diff(row))
        lengths = np.diff(np.concatenate([[-1], edges, [size - 1]]))
        long = lengths[lengths >= 5]
        score += int((long - 2).sum())      # 3 + (len-5) == len-2
    return score


def _penalty(m: np.ndarray) -> int:
    size = m.shape[0]
    a = m.astype(np.int8)
    score = _runs_penalty(a) + _runs_penalty(np.ascontiguousarray(a.T))
    # N2: 2×2 blocks of one colour
    blocks = (a[:-1, :-1] == a[1:, :-1]) & (a[:-1, :-1] == a[:-1, 1:]) \
        & (a[:-1, :-1] == a[1:, 1:])
    score += 3 * int(blocks.sum())
    # N3: finder-like 1011101 with 4 light on either side (vectorised
    # sliding-window match over zero-padded rows, both orientations)
    pat_l = np.array([0, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1], np.int8)
    pat_r = pat_l[::-1]
    for grid in (a, a.T):
        ext = np.pad(grid, ((0, 0), (4, 4)))
        win = np.lib.stride_tricks.sliding_window_view(ext, 11, axis=1)
        score += 40 * int(((win == pat_l).all(-1)
                           | (win == pat_r).all(-1)).sum())
    # N4: dark-module proportion
    dark_pct = 100 * a.sum() / a.size
    score += 10 * int(abs(dark_pct - 50) // 5)
    return score


def encode_qr(text: str, level: str = "M", version: int | None = None,
              mask: int | None = None) -> np.ndarray:
    """Encode ``text`` → boolean module matrix (True = dark)."""
    mode = _pick_mode(text)
    v = version or _choose_version(text, mode, level)
    if not 1 <= v <= MAX_VERSION:
        raise ValueError(f"version {v} out of range 1..{MAX_VERSION}")
    size = size_for_version(v)
    cw = _codewords(text, mode, v, level)
    func = _function_mask(v, size)

    def build(mask_id: int) -> np.ndarray:
        m = np.zeros((size, size), bool)
        _place_function_patterns(m, v)
        _place_format(m, level, mask_id)
        _place_data(m, func, cw, mask_id)
        return m

    if mask is not None:
        if not 0 <= mask <= 7:
            raise ValueError(f"mask must be 0..7, got {mask}")
        return build(mask)
    candidates = [build(i) for i in range(8)]
    return candidates[int(np.argmin([_penalty(c) for c in candidates]))]


def render(modules: np.ndarray, scale: int = 8, border: int = 4) -> np.ndarray:
    """Module matrix → uint8 grayscale image (dark=0) with quiet zone."""
    m = np.pad(modules, border, constant_values=False)
    img = np.where(m, 0, 255).astype(np.uint8)
    return np.kron(img, np.ones((scale, scale), np.uint8))
