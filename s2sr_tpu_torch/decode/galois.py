"""GF(256) arithmetic + Reed-Solomon codec for QR codes.

QR uses GF(2^8) with primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d)
and generator α=2. Decoding is the classic pipeline: syndromes →
Berlekamp-Massey error locator → Chien search → Forney error values.
Vectorised with numpy table lookups (the payloads are ≤ 2956 bytes, so
this is host-side work; the device does the image processing).

A copy of the JAX package's ``decode/galois.py`` (the port imports
nothing of that package).
"""

from __future__ import annotations

import numpy as np

PRIM = 0x11D

# ---- log/antilog tables ------------------------------------------------
EXP = np.zeros(512, np.int32)
LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= PRIM
EXP[255:510] = EXP[:255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF division by zero")
    if a == 0:
        return 0
    return int(EXP[(LOG[a] - LOG[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % 255])


def gf_inv(a: int) -> int:
    return int(EXP[255 - LOG[a]])


def poly_mul(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Multiply polynomials (highest-degree-first coefficient arrays)."""
    out = np.zeros(len(p) + len(q) - 1, np.int32)
    for i, a in enumerate(p):
        if a == 0:
            continue
        la = LOG[a]
        nz = q != 0
        out[i:i + len(q)][nz] ^= EXP[la + LOG[q[nz]]]
    return out


def poly_eval(p: np.ndarray, x: int) -> int:
    """Horner evaluation of polynomial (highest-first) at x."""
    y = 0
    for c in p:
        y = gf_mul(y, x) ^ int(c)
    return y


def rs_generator(nsym: int) -> np.ndarray:
    """Generator polynomial ∏_{i=0}^{nsym-1} (x - α^i)."""
    g = np.array([1], np.int32)
    for i in range(nsym):
        g = poly_mul(g, np.array([1, EXP[i]], np.int32))
    return g


def rs_encode(data: np.ndarray, nsym: int) -> np.ndarray:
    """Append nsym RS parity bytes (systematic encoding)."""
    gen = rs_generator(nsym)
    rem = np.concatenate([np.asarray(data, np.int32), np.zeros(nsym, np.int32)])
    for i in range(len(data)):
        coef = rem[i]
        if coef != 0:
            lc = LOG[coef]
            nz = gen != 0
            idx = np.nonzero(nz)[0] + i
            rem[idx] ^= EXP[lc + LOG[gen[nz]]]
    return np.concatenate([np.asarray(data, np.int32), rem[len(data):]])


def rs_decode(codeword: np.ndarray, nsym: int) -> tuple[np.ndarray, int]:
    """Correct up to nsym//2 byte errors in place.

    Returns (corrected data bytes, number of errors fixed); raises
    ValueError when the word is uncorrectable.
    """
    cw = np.asarray(codeword, np.int32).copy()
    n = len(cw)

    # syndromes S_i = C(α^i), i = 0..nsym-1
    synd = np.array([poly_eval(cw, int(EXP[i])) for i in range(nsym)], np.int32)
    if not synd.any():
        return cw[: n - nsym], 0

    # Berlekamp-Massey (lowest-degree-first locator sigma)
    sigma = np.array([1], np.int32)
    prev = np.array([1], np.int32)
    L, m, b = 0, 1, 1
    for i in range(nsym):
        d = int(synd[i])
        for j in range(1, L + 1):
            if j < len(sigma):
                d ^= gf_mul(int(sigma[j]), int(synd[i - j]))
        if d == 0:
            m += 1
        elif 2 * L <= i:
            t = sigma.copy()
            coef = gf_mul(d, gf_inv(b))
            shifted = np.zeros(m + len(prev), np.int32)
            shifted[m:] = prev
            size = max(len(sigma), len(shifted))
            ns = np.zeros(size, np.int32)
            ns[: len(sigma)] ^= sigma
            nz = shifted != 0
            ns[: len(shifted)][nz] ^= EXP[LOG[coef] + LOG[shifted[nz]]]
            sigma = ns
            L = i + 1 - L
            prev = t
            b = d
            m = 1
        else:
            coef = gf_mul(d, gf_inv(b))
            shifted = np.zeros(m + len(prev), np.int32)
            shifted[m:] = prev
            size = max(len(sigma), len(shifted))
            ns = np.zeros(size, np.int32)
            ns[: len(sigma)] ^= sigma
            nz = shifted != 0
            ns[: len(shifted)][nz] ^= EXP[LOG[coef] + LOG[shifted[nz]]]
            sigma = ns
            m += 1

    n_err = L
    if n_err * 2 > nsym:
        raise ValueError("too many errors")

    # Chien search: roots of sigma → error positions
    positions = []
    for pos in range(n):
        x_inv = int(EXP[(255 - (n - 1 - pos)) % 255])
        acc = 0
        for j in range(len(sigma)):
            acc ^= gf_mul(int(sigma[j]), gf_pow(x_inv, j))
        if acc == 0:
            positions.append(pos)
    if len(positions) != n_err:
        raise ValueError("error locator degree mismatch")

    # Forney: omega = (synd * sigma) mod x^nsym  (lowest-first)
    synd_lf = synd  # already S_0..S_{nsym-1} lowest-first
    omega = np.zeros(nsym, np.int32)
    for i in range(len(sigma)):
        if sigma[i] == 0:
            continue
        for j in range(len(synd_lf)):
            if i + j < nsym and synd_lf[j] != 0:
                omega[i + j] ^= gf_mul(int(sigma[i]), int(synd_lf[j]))

    # formal derivative of sigma (lowest-first): odd-power terms
    for pos in positions:
        x_inv = int(EXP[(255 - (n - 1 - pos)) % 255])
        num = 0
        for j in range(len(omega)):
            num ^= gf_mul(int(omega[j]), gf_pow(x_inv, j))
        den = 0
        for j in range(1, len(sigma), 2):
            den ^= gf_mul(int(sigma[j]), gf_pow(x_inv, j - 1))
        if den == 0:
            raise ValueError("Forney denominator zero")
        # error magnitude e = x * omega(x^-1) / sigma'(x^-1), x = α^(n-1-pos)
        x = int(EXP[(n - 1 - pos) % 255])
        e = gf_mul(x, gf_div(num, den))
        cw[pos] ^= e

    # verify
    for i in range(nsym):
        if poly_eval(cw, int(EXP[i])) != 0:
            raise ValueError("residual syndrome after correction")
    return cw[: n - nsym], n_err
