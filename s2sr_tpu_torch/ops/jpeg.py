"""JPEG compression as a degradation (the DCT-quantization model), in
PyTorch on the tensor's device (the port of ``s2sr_tpu/ops/jpeg.py``).

JPEG's lossy core is 8×8 block DCT → quantization → IDCT; the entropy
stage is lossless and left out. The model:

- RGB → full-range BT.601 YCbCr (the JFIF convention),
- 4:2:0 chroma subsampling (2×2 mean; libjpeg's default sampling),
- per-channel orthonormal 8×8 DCT-II as two batched products per block,
  centred at −128,
- quantization ``round(coef / t_q) · t_q`` with the ITU T.81 Annex K
  tables scaled by libjpeg's quality curve (``q < 50 → 5000/q``, else
  ``200 − 2q``; per entry clipped to [1, 255]),
- IDCT, nearest chroma upsample, YCbCr → RGB, clip to [0, 1].

``quality`` may be a tensor with one value per image (the training
sampler's per-sample quality). A real libjpeg round trip on the host is
``tiles/jpeg.py::jpeg_roundtrip``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["jpeg_degrade", "dct8_matrix", "luma_qtable", "chroma_qtable"]


def dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix ``D`` (f_hat = D f D^T)."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    d[0] *= 1.0 / np.sqrt(2)
    return (d * 0.5).astype(np.float32)


# ITU-T T.81 Annex K.1 example quantization tables (public constants)
_LUMA_Q = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)

_CHROMA_Q = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """The float32 constant ``name`` on ``device``, copied there once (a
    copy from the host per call would wait for the device's queue)."""
    arr = {"dct": dct8_matrix(), "luma": _LUMA_Q, "chroma": _CHROMA_Q}[name]
    return torch.from_numpy(arr).to(device)


def luma_qtable(quality, device=None) -> torch.Tensor:
    return _scale_table("luma", quality, device)


def chroma_qtable(quality, device=None) -> torch.Tensor:
    return _scale_table("chroma", quality, device)


def _scale_table(base: str, quality, device=None) -> torch.Tensor:
    """libjpeg's quality → table mapping (``jpeg_quality_scaling`` +
    ``jpeg_add_quant_table``) in float32: (..., 8, 8) for a quality of
    shape (...). ``5000 / q`` is libjpeg's integer division, applied to
    floor(q) for a non-integer quality."""
    q = torch.as_tensor(quality, dtype=torch.float32, device=device)
    q = q.clamp(1.0, 100.0)[..., None, None]
    scale = torch.where(q < 50.0, torch.floor(5000.0 / torch.floor(q)),
                        200.0 - 2.0 * q)
    t = _const(base, q.device)
    return torch.floor((t * scale + 50.0) / 100.0).clamp(1.0, 255.0)


def _blocks(ch: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., H/8, W/8, 8, 8)"""
    *lead, h, w = ch.shape
    return ch.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)


def _unblocks(bl: torch.Tensor) -> torch.Tensor:
    *lead, nh, nw, _, _ = bl.shape
    return bl.transpose(-3, -2).reshape(*lead, nh * 8, nw * 8)


def _dct_quant_idct(ch: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Channels (..., H, W) in the 0..255 domain (H, W multiples of 8)
    through block DCT → quantize → IDCT; ``table`` (..., 8, 8)."""
    d = _const("dct", ch.device).to(ch.dtype)
    bl = _blocks(ch - 128.0)
    coef = d @ bl @ d.T
    t = table[..., None, None, :, :]
    coef = torch.round(coef / t) * t
    return _unblocks(d.T @ coef @ d) + 128.0


def jpeg_degrade(img: torch.Tensor, quality,
                 subsample: bool = True) -> torch.Tensor:
    """JPEG-compression degradation of ``img`` (..., H, W, 3) RGB in
    [0, 1]; ``quality`` in [1, 100], a number or a tensor of the leading
    shape. With ``subsample`` (libjpeg's 4:2:0, the default) H and W must
    be multiples of 16, else of 8. Returns the degraded image clipped to
    [0, 1] in ``img``'s dtype."""
    h, w = img.shape[-3], img.shape[-2]
    mult = 16 if subsample else 8
    if h % mult or w % mult:
        raise ValueError(f"jpeg_degrade needs H, W multiples of {mult}, "
                         f"got {h}x{w}")
    x = img.float() * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    tl = luma_qtable(quality, img.device)
    tc = chroma_qtable(quality, img.device)

    y = _dct_quant_idct(y, tl)
    if subsample:
        def down2(c):
            *lead, hh, ww = c.shape
            return c.reshape(*lead, hh // 2, 2, ww // 2, 2).mean((-3, -1))

        def up2(c):
            return c.repeat_interleave(2, -2).repeat_interleave(2, -1)

        cb = up2(_dct_quant_idct(down2(cb), tc))
        cr = up2(_dct_quant_idct(down2(cr), tc))
    else:
        cb = _dct_quant_idct(cb, tc)
        cr = _dct_quant_idct(cr, tc)

    cb = cb - 128.0
    cr = cr - 128.0
    out = torch.stack([
        y + 1.402 * cr,
        y - 0.344136 * cb - 0.714136 * cr,
        y + 1.772 * cb,
    ], dim=-1)
    return (out / 255.0).clamp(0.0, 1.0).to(img.dtype)
