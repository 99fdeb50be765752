"""The crop-enhancement chains, uint8 → uint8, in PyTorch (the port of
``s2sr_tpu/ops/enhance.py``). They run on the tensor's device.

- WOW (``enhance_for_crops``): Lab CLAHE (clip 2.5, 8×8) → unsharp
  (σ 1.2, 1.4/−0.4) → HSV green-mask (35 < H < 85) saturation ×1.2;
- farm (``enhance_farm``): Lab CLAHE (clip 2.5, 8×8) → unsharp (σ 1.5,
  2.2/−1.2) → green saturation ×1.3;
- ``enhance_local_contrast``: CLAHE on L alone.

Both boosts truncate the boosted float HSV array to uint8, as the
reference does.
"""

from __future__ import annotations

import torch

from .blur import add_weighted_u8, gaussian_blur_u8
from .clahe import clahe_u8
from .color import hsv_to_rgb_u8, lab_to_rgb_u8, rgb_to_hsv_u8, rgb_to_lab_u8


def _clahe_on_l(img: torch.Tensor, clip_limit: float, grid: int) -> torch.Tensor:
    lab = rgb_to_lab_u8(img)
    l_eq = clahe_u8(lab[..., 0], clip_limit, grid, grid)
    lab = torch.cat([l_eq[..., None], lab[..., 1:]], dim=-1)
    return lab_to_rgb_u8(lab)


def _vegetation_boost(img: torch.Tensor, boost: float) -> torch.Tensor:
    hsv = rgb_to_hsv_u8(img).float()
    h, s = hsv[..., 0], hsv[..., 1]
    green = (h > 35.0) & (h < 85.0)
    s = torch.where(green, (s * boost).clamp(0.0, 255.0), s)
    hsv = torch.stack([h, s, hsv[..., 2]], dim=-1)
    # the reference casts float32 → uint8 (truncation) before HSV2RGB
    return hsv_to_rgb_u8(torch.trunc(hsv).to(torch.uint8))


def enhance_for_crops(img: torch.Tensor) -> torch.Tensor:
    """The WOW chain: uint8 (H, W, 3) → uint8 (H, W, 3)."""
    enhanced = _clahe_on_l(img, 2.5, 8)
    sharpened = add_weighted_u8(
        enhanced, 1.4, gaussian_blur_u8(enhanced, 1.2), -0.4)
    return _vegetation_boost(sharpened, 1.2)


def enhance_farm(img: torch.Tensor) -> torch.Tensor:
    """The farm chain: uint8 (H, W, 3) → uint8 (H, W, 3)."""
    enhanced = _clahe_on_l(img, 2.5, 8)
    sharpened = add_weighted_u8(
        enhanced, 1.0 + 1.2, gaussian_blur_u8(enhanced, 1.5), -1.2)
    return _vegetation_boost(sharpened, 1.3)


def enhance_local_contrast(img: torch.Tensor, clip_limit: float = 3.0,
                           grid_size: int = 8) -> torch.Tensor:
    """CLAHE on the Lab L channel alone: uint8 → uint8."""
    return _clahe_on_l(img, clip_limit, grid_size)
