"""CIELab samples to RGB, byte for byte as PIL converts mode ``LAB``.

A TIFF of photometric 8 (CIELab: L 0..255 for 0..100, a and b as signed
bytes) opens in PIL as mode ``LAB`` (a and b stored with 128 added), and
``convert("RGB")`` runs LittleCMS: ``buildTransform(createProfile("LAB"),
createProfile("sRGB"), "LAB", "RGB")``, perceptual, no flags. LittleCMS
optimizes that 8-bit transform into a 33³ table of 16-bit grid nodes,
sampled from its float pipeline, and reads it by 16-bit tetrahedral
interpolation; this module builds the same table and reads it the same
way, in integers:

- each node's input is LittleCMS's quantized grid value
  ``⌊i·65535/32 + ½⌋`` over 65535, rounded to float32;
- the float pipeline, each stage rounded to float32 as LittleCMS's
  stages are: Lab (v4 encoding) → XYZ against D50, scaled by 1/(1 +
  32767/32768); the inverse of the sRGB colorant matrix (Rec. 709
  primaries and D65 white adapted to D50 by Bradford, computed in
  double as ``cmsCreate_sRGBProfile`` does), scaled back; the inverse of
  sRGB's parametric curve (type 4: 2.4, 1/1.055, 0.055/1.055, 1/12.92,
  0.04045);
- each output to 16 bits by ``_cmsQuickSaturateWord`` (+½, then the
  floor of the value rounded to 2⁻¹⁶);
- an input byte v as 16-bit v·257, the table read by
  ``TetrahedralInterp16`` (fixed-point weights, its rounding), and the
  result to 8 bits by (v·65281 + 2²³) >> 24.

The white fix-up LittleCMS applies to such a table patches the node of
Lab white (0xFFFF, 0x8080, 0x8080), which is not a node of a 33-point
grid, so it changes nothing. The port's bytes equal PIL's over the whole
256³ cube (``tests/test_torch_decode_formats.py``).
"""

from __future__ import annotations

import functools

import numpy as np

_NODES = 33
_CHUNK = 1 << 20          # pixels a pass: bounds the temporaries
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0
_BRADFORD = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
             [0.0389, -0.0685, 1.0296]]
# sRGB's parametric curve (type 4): g, a, b, c, d
_G, _A, _B, _C, _D = 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045


def _inverse(m):
    """3×3 inverse by cofactors, in LittleCMS's order of operations."""
    c0 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c1 = -m[1][0] * m[2][2] + m[1][2] * m[2][0]
    c2 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    det = m[0][0] * c0 + m[0][1] * c1 + m[0][2] * c2
    return [[c0 / det, (m[0][2] * m[2][1] - m[0][1] * m[2][2]) / det,
             (m[0][1] * m[1][2] - m[0][2] * m[1][1]) / det],
            [c1 / det, (m[0][0] * m[2][2] - m[0][2] * m[2][0]) / det,
             (m[0][2] * m[1][0] - m[0][0] * m[1][2]) / det],
            [c2 / det, (m[0][1] * m[2][0] - m[0][0] * m[2][1]) / det,
             (m[0][0] * m[1][1] - m[0][1] * m[1][0]) / det]]


def _mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _apply(m, v):
    return [m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2] for i in range(3)]


def _srgb_to_xyz_d50():
    """sRGB's RGB → XYZ(D50) colorant matrix, as LittleCMS builds it."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb],
                            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
           [coef[0] * yr, coef[1] * yg, coef[2] * yb],
           [coef[0] * (1 - xr - yr), coef[1] * (1 - xg - yg),
            coef[2] * (1 - xb - yb)]]
    src = _apply(_BRADFORD, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _apply(_BRADFORD, list(_D50))
    cone = [[dst[0] / src[0], 0, 0], [0, dst[1] / src[1], 0],
            [0, 0, dst[2] / src[2]]]
    return _mul(_mul(_inverse(_BRADFORD), _mul(cone, _BRADFORD)), rgb)


def _f_inv(t):
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


def _curve_inverse(r):
    disc = (_A * _D + _B) ** _G
    r = r.astype(np.float64)
    with np.errstate(invalid="ignore"):
        out = np.where(r >= disc,
                       (np.power(np.maximum(r, 0.0), 1.0 / _G) - _B) / _A,
                       r / _C)
    return out.astype(np.float32)


def _pipeline(lab: np.ndarray) -> np.ndarray:
    """(..., 3) float32 Lab in LittleCMS's v4 float encoding → float32 RGB."""
    lab = lab.astype(np.float64)
    fy = (lab[..., 0] * 100.0 + 16.0) / 116.0
    fx = fy + 0.002 * (lab[..., 1] * 255.0 - 128.0)
    fz = fy - 0.005 * (lab[..., 2] * 255.0 - 128.0)
    xyz = [(_f_inv(f) * w / _MAX_XYZ).astype(np.float32).astype(np.float64)
           for f, w in zip((fx, fy, fz), _D50)]
    inv = [[v * _MAX_XYZ for v in row] for row in _inverse(_srgb_to_xyz_d50())]
    out = []
    for row in inv:
        t = xyz[0] * row[0]
        t = t + xyz[1] * row[1]
        t = t + xyz[2] * row[2]
        out.append(_curve_inverse(t.astype(np.float32)))
    return np.stack(out, -1)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """LittleCMS's ``_cmsQuickSaturateWord``."""
    d = d + 0.5
    floor = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)
                    ).astype(np.int64)


@functools.lru_cache(maxsize=1)
def _table() -> np.ndarray:
    """The 33³ grid of 16-bit RGB nodes, flattened (L slowest)."""
    q = _saturate_word(np.arange(_NODES) * 65535.0 / (_NODES - 1))
    grid = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1)
    rgb = _pipeline((grid / 65535.0).astype(np.float32))
    return _saturate_word(rgb.astype(np.float64) * 65535.0).reshape(-1, 3)


@functools.lru_cache(maxsize=1)
def _axes() -> tuple:
    """Per input byte v (16-bit v·257): the lower node, the fixed-point
    rest and whether a next node exists (not at 0xFFFF), as
    ``TetrahedralInterp16`` computes them."""
    a = np.arange(256, dtype=np.int64) * 257 * (_NODES - 1)
    f = a + (a + 0x7FFF) // 0xFFFF
    return f >> 16, f & 0xFFFF, (np.arange(256) != 255).astype(np.int64)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 CIELab as a TIFF stores it (a and b signed) →
    (H, W, 3) uint8 RGB: PIL's ``convert("RGB")`` of its mode ``LAB``.

    ``TetrahedralInterp16`` walks from the lower node along the axes in
    decreasing order of their rests: c0 + Σ rest·(next − previous node).
    That sum does not depend on how ties are ordered, so the walk here
    orders the axes by rest with ties broken L, a, b."""
    table = _table()
    chans = [np.ascontiguousarray(table[:, k]) for k in range(3)]
    node, rest, step = _axes()
    strides = (_NODES * _NODES, _NODES, 1)
    flat = lab.reshape(-1, 3)
    out = np.empty(flat.shape, np.uint8)
    for s in range(0, len(flat), _CHUNK):
        v = flat[s:s + _CHUNK].astype(np.intp)
        v[:, 1:] ^= 128                       # PIL's LAB bytes: a, b + 128
        base = np.zeros(len(v), np.int64)
        keys, offs, rests = [], [], []
        for k in range(3):
            base += node[v[:, k]] * strides[k]
            r = rest[v[:, k]]
            rests.append(r)
            offs.append(step[v[:, k]] * strides[k])
            keys.append(r * 4 + (2 - k))
        first = np.argmax(np.stack(keys), 0)
        last = np.argmin(np.stack(keys), 0)
        mid = 3 - first - last
        rs, os_ = np.stack(rests), np.stack(offs)
        idx = np.arange(len(v))
        r1, r2, r3 = rs[first, idx], rs[mid, idx], rs[last, idx]
        p1 = base + os_[first, idx]
        p2 = p1 + os_[mid, idx]
        p3 = p2 + os_[last, idx]
        for k in range(3):
            t = chans[k]
            c0, c1, c2, c3 = t[base], t[p1], t[p2], t[p3]
            acc = (c1 - c0) * r1 + (c2 - c1) * r2 + (c3 - c2) * r3 + 0x8001
            v16 = c0 + ((acc + (acc >> 16)) >> 16)
            out[s:s + _CHUNK, k] = (v16 * 65281 + 8388608) >> 24
    return out.reshape(lab.shape)
