"""SR model registry.

Name/config-compatible with the reference registries:
``server/app/cnn_super_resolution.py:28-45`` (Real-ESRGAN family),
``server/app/swinir.py:21-34`` (SwinIR) and
``server/app/super_resolution.py:22-59`` (OpenCV-DNN EDSR/ESPCN/LapSRN).
URLs are retained for provenance; in offline environments weights must be
converted from a locally provided checkpoint via
:mod:`s2sr_tpu_torch.models.weights`.
"""

from __future__ import annotations

from typing import Dict

MODELS: Dict[str, dict] = {
    # --- RRDBNet / Real-ESRGAN family (flagship) ---
    "realesrgan_x4": {
        "family": "rrdbnet",
        "url": "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.1.0/RealESRGAN_x4plus.pth",
        "scale": 4,
        "channels": 64,
        "blocks": 23,
        "growth": 32,
        "num_in_ch": 3,
        "description": "General photos (best quality)",
    },
    "realesrgan_anime": {
        "family": "rrdbnet",
        "url": "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.2.4/RealESRGAN_x4plus_anime_6B.pth",
        "scale": 4,
        "channels": 64,
        "blocks": 6,
        "growth": 32,
        "num_in_ch": 3,
        "description": "Sharp edges (best for text/plates)",
    },
    # --- SwinIR (transformer SR; present-for-parity, ref swinir.py) ---
    # the reference registry ships BOTH classical scales
    # (``server/app/swinir.py:21-34``: swinir_x2 + swinir_x4)
    "swinir_x2": {
        "family": "swinir",
        "url": "https://github.com/JingyunLiang/SwinIR/releases/download/v0.0/001_classicalSR_DIV2K_s48w8_SwinIR-M_x2.pth",
        "scale": 2,
        "embed_dim": 180,
        "depths": (6, 6, 6, 6, 6, 6),
        "num_heads": (6, 6, 6, 6, 6, 6),
        "window_size": 8,
        "description": "Transformer SR (classical x2)",
    },
    "swinir_x4": {
        "family": "swinir",
        "url": "https://github.com/JingyunLiang/SwinIR/releases/download/v0.0/001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth",
        "scale": 4,
        "embed_dim": 180,
        "depths": (6, 6, 6, 6, 6, 6),
        "num_heads": (6, 6, 6, 6, 6, 6),
        "window_size": 8,
        "description": "Transformer SR (classical x4)",
    },
    # --- Classic CNN SR (the cv2.dnn_superres set, ref super_resolution.py) ---
    "edsr_x2": {"family": "edsr", "scale": 2, "channels": 256, "blocks": 32,
                 "description": "EDSR x2 (quality)"},
    "edsr_x3": {"family": "edsr", "scale": 3, "channels": 256, "blocks": 32,
                 "description": "EDSR x3 (quality)"},
    "edsr_x4": {"family": "edsr", "scale": 4, "channels": 256, "blocks": 32,
                 "description": "EDSR x4 (quality)"},
    "espcn_x2": {"family": "espcn", "scale": 2, "description": "ESPCN x2 (fast)"},
    "espcn_x3": {"family": "espcn", "scale": 3, "description": "ESPCN x3 (fast)"},
    "espcn_x4": {"family": "espcn", "scale": 4, "description": "ESPCN x4 (fast)"},
    "lapsrn_x2": {"family": "lapsrn", "scale": 2, "description": "LapSRN x2"},
    "lapsrn_x4": {"family": "lapsrn", "scale": 4, "description": "LapSRN x4"},
    "lapsrn_x8": {"family": "lapsrn", "scale": 8, "description": "LapSRN x8"},
}


def get_model_config(name: str) -> dict:
    if name not in MODELS:
        raise ValueError(f"Unknown model: {name}. Available: {sorted(MODELS)}")
    return MODELS[name]
