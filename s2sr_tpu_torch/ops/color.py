"""Colorspace conversions matching OpenCV uint8 semantics, in PyTorch.

The port of ``s2sr_tpu/ops/color.py`` for the WOW chain: RGB↔Lab (D65,
sRGB gamma, L scaled to 0..255, a/b offset +128) and RGB↔HSV (H in
0..179). RGB→Lab and RGB→HSV are cv2's fixed-point pipelines; HSV→RGB
is cv2's float path with its fused multiply-add reproduced by an
error-free transformation; Lab→RGB is the float formula.

All functions take and return ``(..., 3)`` uint8 tensors and compute in
int32 / float32 on the tensor's device, with the same bytes on the CPU
and the card: every float op is one IEEE-rounded op on both. Two spots
need care for that. PyTorch's CUDA kernels divide by a Python scalar as
a multiply by its float32 reciprocal, so :func:`div` divides by a
0-dim tensor on the device instead (a true division on both). And
CUDA's ``powf`` differs from the CPU's ``pow`` in the last bits, so
Lab→RGB's sRGB encoding looks its uint8 up in 255 float32 thresholds
(:func:`srgb_u8_thresholds`) with ``torch.searchsorted``.
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


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as one IEEE float32 division on either device."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


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
    return torch.where(t3 > _LAB_T, t3, div(ft - _LAB_OFF, _LAB_K))


# The sRGB encoding's uint8, round(255·(1.055·x^(1/2.4) − 0.055)) over
# float32 x in [0, 1] (x·12.92 below 0.0031308), is monotone in x: it is
# the count of these 255 float32 thresholds (bit patterns) that are ≤ x.
# Entry k − 1 is the least float32 whose encoding reaches k, found by
# bisection over the bit patterns of [0, 1] with the JAX package's eager
# float32 chain (tests/test_torch_enhance.py derives them again).
_SRGB_U8_THRESHOLD_BITS = np.array([
    0x391F22B5, 0x39EEB40E, 0x3A46EB62, 0x3A8B3E5D, 0x3AB3070C, 0x3ADACFB7,
    0x3B014C33, 0x3B153089, 0x3B2914E1, 0x3B3CF936, 0x3B50F2D1, 0x3B65FB9A,
    0x3B7C3404, 0x3B89D060, 0x3B962333, 0x3BA314BE, 0x3BB0A733, 0x3BBEDCB6,
    0x3BCDB770, 0x3BDD3966, 0x3BED64B2, 0x3BFE3B44, 0x3C07DF92, 0x3C10F919,
    0x3C1A6B35, 0x3C2436C7, 0x3C2E5CC9, 0x3C38DE19, 0x3C43BBA5, 0x3C4EF646,
    0x3C5A8EE5, 0x3C668654, 0x3C72DD73, 0x3C7F9512, 0x3C865703, 0x3C8D1490,
    0x3C940396, 0x3C9B247C, 0x3CA277A8, 0x3CA9FD79, 0x3CB1B654, 0x3CB9A299,
    0x3CC1C2A9, 0x3CCA16E3, 0x3CD29FA4, 0x3CDB5D4D, 0x3CE45034, 0x3CED78B6,
    0x3CF6D72F, 0x3D0035FC, 0x3D051BB6, 0x3D0A1CEE, 0x3D0F39D1, 0x3D14728A,
    0x3D19C745, 0x3D1F382B, 0x3D24C56A, 0x3D2A6F24, 0x3D303586, 0x3D3618B9,
    0x3D3C18E6, 0x3D423634, 0x3D4870CB, 0x3D4EC8D3, 0x3D553E77, 0x3D5BD1D3,
    0x3D62831C, 0x3D69526A, 0x3D703FF2, 0x3D774BCE, 0x3D7E762B, 0x3D82DF92,
    0x3D869376, 0x3D8A56CC, 0x3D8E29AF, 0x3D920C28, 0x3D95FE52, 0x3D9A0036,
    0x3D9E11EE, 0x3DA23384, 0x3DA66512, 0x3DAAA6A0, 0x3DAEF849, 0x3DB35A17,
    0x3DB7CC1F, 0x3DBC4E6C, 0x3DC0E118, 0x3DC5842A, 0x3DCA37BD, 0x3DCEFBD7,
    0x3DD3D092, 0x3DD8B5F6, 0x3DDDAC1C, 0x3DE2B30A, 0x3DE7CADC, 0x3DECF395,
    0x3DF22D52, 0x3DF7781A, 0x3DFCD401, 0x3E012088, 0x3E03DFB1, 0x3E06A77C,
    0x3E0977F8, 0x3E0C5127, 0x3E0F3316, 0x3E121DC6, 0x3E151145, 0x3E180D95,
    0x3E1B12C4, 0x3E1E20D1, 0x3E2137CC, 0x3E2457B7, 0x3E27809C, 0x3E2AB27C,
    0x3E2DED6A, 0x3E313160, 0x3E347E73, 0x3E37D49D, 0x3E3B33EE, 0x3E3E9C68,
    0x3E420E18, 0x3E4588FA, 0x3E490D25, 0x3E4C9A8F, 0x3E50314F, 0x3E53D15C,
    0x3E577ACD, 0x3E5B2D99, 0x3E5EE9D6, 0x3E62AF7C, 0x3E667EA1, 0x3E6A5740,
    0x3E6E3968, 0x3E722512, 0x3E761A58, 0x3E7A192D, 0x3E7E21AA, 0x3E8119E2,
    0x3E8327CA, 0x3E853A87, 0x3E875224, 0x3E896E9E, 0x3E8B8FFE, 0x3E8DB641,
    0x3E8FE172, 0x3E92118B, 0x3E944698, 0x3E968094, 0x3E98BF8B, 0x3E9B0377,
    0x3E9D4C63, 0x3E9F9A4B, 0x3EA1ED3A, 0x3EA4452A, 0x3EA6A228, 0x3EA9042D,
    0x3EAB6B46, 0x3EADD76B, 0x3EB048AC, 0x3EB2BF01, 0x3EB53A75, 0x3EB7BB01,
    0x3EBA40B4, 0x3EBCCB86, 0x3EBF5B84, 0x3EC1F0A7, 0x3EC48AFD, 0x3EC72A7D,
    0x3EC9CF35, 0x3ECC791E, 0x3ECF2845, 0x3ED1DCA2, 0x3ED49644, 0x3ED75521,
    0x3EDA1948, 0x3EDCE2B1, 0x3EDFB16A, 0x3EE2856A, 0x3EE55EBF, 0x3EE83D62,
    0x3EEB215F, 0x3EEE0AAF, 0x3EF0F961, 0x3EF3ED69, 0x3EF6E6D9, 0x3EF9E5A6,
    0x3EFCE9E0, 0x3EFFF37F, 0x3F018147, 0x3F030B82, 0x3F049879, 0x3F062827,
    0x3F07BA94, 0x3F094FBA, 0x3F0AE7A1, 0x3F0C8244, 0x3F0E1FAC, 0x3F0FBFD2,
    0x3F1162BF, 0x3F13086E, 0x3F14B0E6, 0x3F165C22, 0x3F180A2A, 0x3F19BAF9,
    0x3F1B6E97, 0x3F1D24FE, 0x3F1EDE37, 0x3F209A3B, 0x3F225914, 0x3F241ABB,
    0x3F25DF39, 0x3F27A688, 0x3F2970B0, 0x3F2B3DAC, 0x3F2D0D84, 0x3F2EE033,
    0x3F30B5C0, 0x3F328E25, 0x3F34696B, 0x3F36478C, 0x3F382891, 0x3F3A0C73,
    0x3F3BF33C, 0x3F3DDCE5, 0x3F3FC977, 0x3F41B8EB, 0x3F43AB4A, 0x3F45A08F,
    0x3F4798C1, 0x3F4993DA, 0x3F4B91E4, 0x3F4D92D8, 0x3F4F96BF, 0x3F519D91,
    0x3F53A75A, 0x3F55B410, 0x3F57C3BF, 0x3F59D65E, 0x3F5BEBF8, 0x3F5E0485,
    0x3F60200F, 0x3F623E91, 0x3F64600F, 0x3F668486, 0x3F68ABFE, 0x3F6AD671,
    0x3F6D03E8, 0x3F6F345B, 0x3F7167D5, 0x3F739E4D, 0x3F75D7CF, 0x3F781452,
    0x3F7A53E0, 0x3F7C9671, 0x3F7EDC11,
], dtype=np.uint32)
_THRESHOLDS: dict = {}


def srgb_u8_thresholds(device) -> torch.Tensor:
    """The 255 thresholds as a float32 tensor on ``device``."""
    key = str(device)
    if key not in _THRESHOLDS:
        _THRESHOLDS[key] = torch.from_numpy(
            _SRGB_U8_THRESHOLD_BITS.view(np.float32).copy()).to(device)
    return _THRESHOLDS[key]


def lab_to_rgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """uint8 Lab → uint8 RGB (cv2.COLOR_LAB2RGB semantics, float formula)."""
    L = div(lab[..., 0].float() * 100.0, 255.0)
    a = lab[..., 1].float() - 128.0
    b = lab[..., 2].float() - 128.0
    fy = div(L + 16.0, 116.0)
    fx = fy + div(a, 500.0)
    fz = fy - div(b, 200.0)
    X = _lab_f_inv(fx) * _XN
    Y = _lab_f_inv(fy)
    Z = _lab_f_inv(fz) * _ZN
    r = 3.240479 * X - 1.537150 * Y - 0.498535 * Z
    g = -0.969256 * X + 1.875992 * Y + 0.041556 * Z
    bl = 0.055648 * X - 0.204043 * Y + 1.057311 * Z
    lin = torch.stack([r, g, bl], dim=-1).contiguous()
    u8 = torch.searchsorted(srgb_u8_thresholds(lin.device), lin, right=True)
    return u8.to(torch.uint8)


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


# --- float YCrCb (cv2 COLOR_RGB2YCrCb float semantics) -----------------
#
# The reference's cv2.dnn_superres runs ESPCN/LapSRN on the luma channel
# of a float [0, 1] YCrCb image and upscales chroma with bicubic; the
# classic models' luma path reproduces that flow. cv2's float constants:
# delta = 0.5, Cr = (R − Y)·0.713 + delta, Cb = (B − Y)·0.564 + delta.

def rgb_to_ycrcb_f32(rgb: torch.Tensor) -> torch.Tensor:
    """float32 (..., 3) RGB → (..., 3) YCrCb, cv2's float formula."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 0.5
    cb = (b - y) * 0.564 + 0.5
    return torch.stack([y, cr, cb], dim=-1)


def ycrcb_to_rgb_f32(ycc: torch.Tensor) -> torch.Tensor:
    """float32 (..., 3) YCrCb → (..., 3) RGB, cv2's float formula."""
    y, cr, cb = ycc[..., 0], ycc[..., 1] - 0.5, ycc[..., 2] - 0.5
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    return torch.stack([r, g, b], dim=-1)
