"""Gaussian blur and weighted add with cv2's uint8 semantics, in PyTorch
(the port of ``s2sr_tpu/ops/blur.py``).

- auto kernel size for 8U input: ``ksize = round(σ·3·2 + 1) | 1``,
- ``BORDER_REFLECT_101`` edges (torch's ``reflect`` pad),
- cv2's fixed-point u8 path: an 8-bit kernel summing to 256, an exact
  horizontal pass, a vertical accumulation to value·2¹⁶ and a half-up
  descale. Every sum is an exact integer below 2²⁴ in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel for explicitly positive sigma."""
    c = (ksize - 1) / 2.0
    xs = np.arange(ksize, dtype=np.float64) - c
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def auto_ksize(sigma: float, depth_8u: bool = True) -> int:
    """cv2.GaussianBlur's ksize=(0,0) rule."""
    k = int(round(sigma * (3 if depth_8u else 4) * 2 + 1)) | 1
    return max(k, 1)


# cv2's own 8-bit kernel where it distributes the rounding residue
# differently from round(k·256) + centre correction (σ 2.0).
_FIXED_KERNELS = {
    (13, 2.0): np.array([1, 2, 7, 16, 31, 45, 52, 45, 31, 16, 7, 2, 1],
                        np.int64),
}


def _fixed_kernel_u8(ksize: int, sigma: float) -> np.ndarray:
    key = (ksize, round(float(sigma), 6))
    if key in _FIXED_KERNELS:
        return _FIXED_KERNELS[key]
    k = gaussian_kernel_1d(ksize, sigma).astype(np.float64)
    q = np.round(k * 256).astype(np.int64)
    q[ksize // 2] += 256 - q.sum()
    return q


def _reflect_pad(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Reflect-101 pad of an (H, W[, C]) float tensor along dim 0 or 1."""
    t = x if x.dim() == 3 else x[..., None]
    t = t.permute(2, 0, 1)[None]                        # (1, C, H, W)
    spec = (0, 0, pad, pad) if dim == 0 else (pad, pad, 0, 0)
    t = F.pad(t, spec, mode="reflect")[0].permute(1, 2, 0)
    return t if x.dim() == 3 else t[..., 0]


def gaussian_blur_u8(img: torch.Tensor, sigma: float,
                     ksize: Optional[int] = None) -> torch.Tensor:
    """uint8 in → uint8 out, cv2.GaussianBlur's fixed-point u8 path."""
    if ksize is None:
        ksize = auto_ksize(sigma)
    q = _fixed_kernel_u8(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape[0], img.shape[1]
    x = img.float()
    xp = _reflect_pad(x, pad, 0)
    acc = sum(xp[i:i + h] * float(q[i]) for i in range(ksize))
    ap = _reflect_pad(acc, pad, 1)
    v = sum(ap[:, i:i + w] * float(q[i]) for i in range(ksize))
    out = torch.floor((v + 32768.0) * 2.0 ** -16)
    return out.clamp(0, 255).to(torch.uint8)


def add_weighted_u8(a: torch.Tensor, alpha: float, b: torch.Tensor,
                    beta: float, gamma: float = 0.0) -> torch.Tensor:
    """cv2.addWeighted on uint8 (saturating, round-to-nearest)."""
    out = a.float() * alpha + b.float() * beta + gamma
    return torch.round(out).clamp(0, 255).to(torch.uint8)
