"""Farm super-resolution pipeline (4-step chain).

The port of ``s2sr_tpu/pipelines/farm_sr.py``: Real-ESRGAN x{scale} →
CLAHE (clip 2.5, 8×8) → unsharp (σ 1.5, 2.2/−1.2) → vegetation boost
×1.3, with the same artifacts (GeoTIFF with the transform divided by
the scale, PNG twin, sidecar JSON) and metadata keys. The engine
returns the SR output to the host; it goes back to the device for the
enhancement chain (:func:`..ops.enhance.enhance_farm`) and the final
uint8 image comes back for encoding. Runs on ``cuda`` unless
``device="cpu"``.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..models.engine import get_engine
from ..ops.enhance import enhance_farm
from ..utils import StageTimer, setup_logging
from .io import load_rgb, save_sr_output

logger = setup_logging("s2sr_tpu_torch.farm_sr")


def apply_farm_sr(
    input_path: Path | str,
    output_path: Path | str,
    scale: int = 4,
    weights_dir: Path | str = "models",
    device: str = "cuda",
) -> Tuple[Path, dict]:
    logger.info("Farm SR pipeline: %s", input_path)
    timer = StageTimer(total_stages=4)
    img, transform, crs = load_rgb(input_path)
    original_shape = img.shape[:2]

    with timer.stage(f"Real-ESRGAN x{scale} upscaling"):
        # the model name comes from the requested scale, as in the
        # reference: scales without a registered model raise
        engine = get_engine(f"realesrgan_x{scale}",
                            weights_dir=str(weights_dir), device=device)
        sr_dev = torch.as_tensor(
            np.ascontiguousarray(engine.enhance_serving(np.asarray(img)))
        ).to(engine.device)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        actual_scale = engine.scale

    with timer.stage("CLAHE + sharpening + vegetation (fused)"):
        final_dev = enhance_farm(sr_dev)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    output_rgb = final_dev.cpu().numpy()
    final_output = save_sr_output(
        output_rgb, Path(output_path), transform, crs, actual_scale
    )

    metadata = {
        "input_file": str(input_path),
        "output_file": str(final_output),
        "scale": actual_scale,
        "pipeline": "Real-ESRGAN + CLAHE + Unsharp + Vegetation",
        "steps": [
            f"Real-ESRGAN x{actual_scale} upscaling",
            "Local contrast enhancement (CLAHE)",
            "Edge sharpening for crop rows",
            "Vegetation enhancement",
        ],
        "original_size": list(original_shape),
        "output_size": list(output_rgb.shape[:2]),
        "original_resolution_m": 10.0,
        "effective_resolution_m": 10.0 / actual_scale,
        "pretrained": engine.pretrained,
        "timing": timer.summary(),
    }
    return final_output, metadata


def process_farm_sr(
    input_tif: Path | str,
    output_dir: Path | str,
    scale: int = 4,
    weights_dir: Path | str = "models",
    device: str = "cuda",
) -> dict:
    """Job wrapper + sidecar metadata JSON."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    base_name = Path(input_tif).stem
    sr_tif = output_dir / f"{base_name}_farm_sr.tif"

    output_path, sr_metadata = apply_farm_sr(
        input_path=input_tif, output_path=sr_tif,
        scale=scale, weights_dir=weights_dir, device=device,
    )
    result = {
        "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
        "input": str(input_tif),
        "outputs": {
            "sr_tif": str(sr_tif) if sr_tif.exists() else None,
            "sr_png": (
                str(sr_tif.with_suffix(".png"))
                if sr_tif.with_suffix(".png").exists() else None
            ),
        },
        "sr_metadata": sr_metadata,
    }
    meta_file = output_dir / f"{base_name}_farm_sr_metadata.json"
    with open(meta_file, "w") as f:
        json.dump(result, f, indent=2)
    return result
