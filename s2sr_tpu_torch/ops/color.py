"""Colorspace conversions matching OpenCV uint8 semantics, in PyTorch.

The port of ``s2sr_tpu/ops/color.py`` for the WOW chain: RGB↔Lab (D65,
sRGB gamma, L scaled to 0..255, a/b offset +128) and RGB↔HSV (H in
0..179). RGB→Lab and RGB→HSV are cv2's fixed-point pipelines; HSV→RGB
is cv2's float path with its fused multiply-add reproduced by an
error-free transformation; Lab→RGB is the float formula.

All functions take and return ``(..., 3)`` uint8 tensors and compute in
int32 / float32 on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB → XYZ (D65) matrix rows (OpenCV constants)
_XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XN = 0.950456
_ZN = 1.088754
_LAB_T = 0.008856
_LAB_K = 7.787
_LAB_OFF = 16.0 / 116.0

# cv2's fixed-point RGB→Lab (8U): an 11-bit sRGB gamma table, a 12-bit
# XYZ matrix with the D65 whitepoint folded into the coefficients, a
# 3072-entry cube-root table and round-half-up descales. The two table
# corrections are where OpenCV's softfloat table init rounds the other
# way (derived in the JAX package against the exhaustive 256³ cv2
# oracle).
_LAB_SHIFT = 12
_LAB_SHIFT2 = 15


def _lab_tables() -> tuple:
    i = np.arange(256) / 255.0
    gamma = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.floor(2040.0 * gamma + 0.5).astype(np.int32)
    x = np.arange(3072) / 2040.0
    f = np.where(x < 216.0 / 24389.0, x * 841.0 / 108.0 + 16.0 / 116.0,
                 np.cbrt(x))
    cbrt_tab = np.floor((1 << _LAB_SHIFT2) * f + 0.5).astype(np.int32)
    cbrt_tab[49] -= 1
    cbrt_tab[628] += 1
    coeffs = np.floor((1 << _LAB_SHIFT) * np.asarray(_XYZ)
                      / np.asarray([_XN, 1.0, _ZN])[:, None] + 0.5
                      ).astype(np.int32)
    return gamma_tab, cbrt_tab, coeffs


_LAB_GAMMA_TAB, _LAB_CBRT_TAB, _LAB_COEFFS = _lab_tables()


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def _lookup(idx: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(table).to(idx.device)[idx.long()]


def rgb_to_lab_u8(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB → uint8 Lab, cv2.COLOR_RGB2LAB's integer pipeline."""
    C = _LAB_COEFFS.tolist()
    i = rgb.to(torch.int32)
    r = _lookup(i[..., 0], _LAB_GAMMA_TAB)
    g = _lookup(i[..., 1], _LAB_GAMMA_TAB)
    b = _lookup(i[..., 2], _LAB_GAMMA_TAB)

    def f(row):
        return _lookup(_descale(r * C[row][0] + g * C[row][1] + b * C[row][2],
                                _LAB_SHIFT), _LAB_CBRT_TAB)

    fX, fY, fZ = f(0), f(1), f(2)
    l_scale = (116 * 255 + 50) // 100                        # 296
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = _descale(l_scale * fY + l_shift, _LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fY - fZ) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([L, a, bb], dim=-1).clamp(0, 255).to(torch.uint8)


def _lab_f_inv(ft: torch.Tensor) -> torch.Tensor:
    t3 = ft * ft * ft
    return torch.where(t3 > _LAB_T, t3, (ft - _LAB_OFF) / _LAB_K)


def _linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x ** (1.0 / 2.4) - 0.055)


def lab_to_rgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """uint8 Lab → uint8 RGB (cv2.COLOR_LAB2RGB semantics, float formula)."""
    L = lab[..., 0].float() * 100.0 / 255.0
    a = lab[..., 1].float() - 128.0
    b = lab[..., 2].float() - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    X = _lab_f_inv(fx) * _XN
    Y = _lab_f_inv(fy)
    Z = _lab_f_inv(fz) * _ZN
    r = 3.240479 * X - 1.537150 * Y - 0.498535 * Z
    g = -0.969256 * X + 1.875992 * Y + 0.041556 * Z
    bl = 0.055648 * X - 0.204043 * Y + 1.057311 * Z
    rgb = _linear_to_srgb(torch.stack([r, g, bl], dim=-1)) * 255.0
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)


_HSV_SHIFT = 12


def rgb_to_hsv_u8(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB → uint8 HSV with H in 0..179: cv2's fixed-point
    algorithm, its sdiv/hdiv division tables computed arithmetically
    (round-half-up integer division)."""
    i = rgb.to(torch.int32)
    r, g, b = i[..., 0], i[..., 1], i[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    half = 1 << (_HSV_SHIFT - 1)
    sdiv_v = torch.where(
        v > 0, (2 * (255 << _HSV_SHIFT) + v) // (2 * v.clamp(min=1)), 0)
    hdiv_d = torch.where(
        diff > 0,
        (2 * (180 << _HSV_SHIFT) + 6 * diff) // (12 * diff.clamp(min=1)), 0)
    s = (diff * sdiv_v + half) >> _HSV_SHIFT
    hnum = torch.where(
        v == r, g - b,
        torch.where(v == g, (b - r) + 2 * diff, (r - g) + 4 * diff))
    h = (hnum * hdiv_d + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def _fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest f32 ``a·b + c`` from plain IEEE f32 ops (Dekker
    two-product + two-sum), reproducing the single rounding of the
    hardware fma cv2's compiled HSV→RGB uses. Eager PyTorch rounds every
    op on its own and never contracts a multiply into an add, so each
    step keeps its one rounding without barriers."""
    split = 4097.0                  # 2^12 + 1 Dekker split for f32
    ca = split * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = split * b
    bhi = cb - (cb - b)
    blo = b - bhi
    p = a * b
    e1 = ahi * bhi - p
    e2 = e1 + ahi * blo
    e3 = e2 + alo * bhi
    e = e3 + alo * blo
    s = c + p
    bv = s - c
    err = (c - (s - bv)) + (p - bv)
    return s + (err + e)


# cv2's HSV→RGB sector table (b, g, r) ← tab index, color_hsv.cpp
_HSV_SECTOR = ((1, 3, 0), (1, 0, 2), (3, 0, 1),
               (0, 2, 1), (0, 1, 3), (2, 1, 0))


def hsv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """uint8 HSV (H 0..179) → uint8 RGB, cv2.COLOR_HSV2RGB: the float
    kernel on normalized s, v with h scaled by 6/180, ``1 - s·x`` as one
    fma, and the final ×255 truncated."""
    one = torch.ones((), dtype=torch.float32, device=hsv.device)
    s = hsv[..., 1].float() * np.float32(1.0 / 255.0).item()
    v = hsv[..., 2].float() * np.float32(1.0 / 255.0).item()
    h = hsv[..., 0].float() * np.float32(6.0 / 180.0).item()
    h = torch.where(h >= 6.0, h - 6.0, h)
    sector = torch.floor(h)
    frac = h - sector
    sec = sector.to(torch.int32).clamp(0, 5)
    tab = (v, v * (one - s), v * _fma_rn(-s, frac, one),
           v * _fma_rn(-s, one - frac, one))

    def pick(channel):
        out = torch.zeros_like(v)
        for k in range(6):
            out = torch.where(sec == k, tab[_HSV_SECTOR[k][channel]], out)
        return out

    rgb = torch.stack([pick(2), pick(1), pick(0)], dim=-1)
    return torch.trunc(rgb * 255.0).clamp(0, 255).to(torch.uint8)
