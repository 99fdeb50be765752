from .blur import add_weighted_u8, gaussian_blur, gaussian_blur_u8, unsharp_mask_u8
from .clahe import clahe_u8
from .color import hsv_to_rgb_u8, lab_to_rgb_u8, rgb_to_hsv_u8, rgb_to_lab_u8
from .enhance import enhance_farm, enhance_for_crops, enhance_local_contrast

__all__ = [
    "add_weighted_u8",
    "gaussian_blur",
    "gaussian_blur_u8",
    "unsharp_mask_u8",
    "clahe_u8",
    "hsv_to_rgb_u8",
    "lab_to_rgb_u8",
    "rgb_to_hsv_u8",
    "rgb_to_lab_u8",
    "enhance_farm",
    "enhance_for_crops",
    "enhance_local_contrast",
]
