"""WOW super-resolution pipeline: x4 GAN SR + crop-visibility enhancement.

The port of ``s2sr_tpu/pipelines/wow_sr.py``: the same two stages
(Real-ESRGAN x4 → CLAHE/unsharp/vegetation boost), the same artifacts
(GeoTIFF with the transform divided by the scale, PNG twin, sidecar
metadata JSON) and the same metadata keys. As in the JAX pipeline, the
engine returns the SR output to the host (it stitches its windows
there); the image is uploaded again for the enhancement chain, and the
final uint8 image comes back for encoding. Runs on ``cuda`` unless
``device="cpu"``.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.engine import get_engine
from ..ops.enhance import enhance_for_crops
from ..utils import StageTimer, setup_logging
from .io import load_rgb, save_sr_output

logger = setup_logging("s2sr_tpu_torch.wow_sr")

MODEL_DISPLAY = {
    "realesrgan_x4": "Real-ESRGAN x4",
    "realesrgan_anime": "Real-ESRGAN Anime 6B (text/plates)",
}


def apply_wow_sr(
    input_path: Path | str,
    output_path: Path | str,
    enhance_crops: bool = True,
    model: str = "realesrgan_x4",
    weights_dir: Path | str = "models",
    timer: Optional[StageTimer] = None,
    precomputed_sr=None,
    precision: Optional[str] = None,
    device: str = "cuda",
) -> Tuple[Path, dict]:
    """SR + enhancement → saved raster, metadata.

    ``precision``: None/"default" follows ``Settings.sr_dtype``;
    "bfloat16"/"float32"/"int8" pin the engine dtype for this job ("int8":
    the int8-mixed trunk, ``models/rrdbnet_int8.py``)."""
    model_display = MODEL_DISPLAY.get(model, model)
    logger.info("WOW Super-Resolution (%s + Enhanced): %s", model_display,
                input_path)
    timer = timer or StageTimer(total_stages=2)

    img, transform, crs = load_rgb(input_path)
    original_shape = img.shape[:2]

    engine_kwargs = {"device": device}
    if precision and precision != "default":
        engine_kwargs["dtype"] = precision
    with timer.stage(f"{model_display} (GAN upscaling)"):
        engine = get_engine(model, weights_dir=str(weights_dir),
                            **engine_kwargs)
        sr = (engine.enhance_serving(np.asarray(img))
              if precomputed_sr is None else precomputed_sr)
        sr_dev = torch.as_tensor(np.ascontiguousarray(sr)).to(engine.device)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        scale = engine.scale

    pipeline_stages = [{"model": model, "scale": scale,
                        "purpose": "GAN upscaling"}]

    if enhance_crops:
        with timer.stage("Crop visibility enhancement"):
            sr_dev = enhance_for_crops(sr_dev)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
        pipeline_stages.append(
            {"post_processing": "Enhanced", "purpose": "Crop visibility"})

    output_rgb = sr_dev.cpu().numpy()
    final_shape = output_rgb.shape[:2]

    final_output = save_sr_output(
        output_rgb, Path(output_path), transform, crs, scale)
    logger.info("Saved: %s (%dx%d)", final_output, final_shape[1],
                final_shape[0])

    metadata = {
        "input_file": str(input_path),
        "output_file": str(final_output),
        "scale": scale,
        # constant string regardless of model/enhance flags, as in the
        # reference; the provenance lives in "stages"/"enhancements"
        "pipeline": "Real-ESRGAN x4 + Enhanced",
        "stages": pipeline_stages,
        "enhancements": (
            ["CLAHE local contrast", "Unsharp mask", "Vegetation boost"]
            if enhance_crops else []
        ),
        "original_size": list(original_shape),
        "output_size": list(final_shape),
        "original_resolution_m": 10.0,
        "effective_resolution_m": 10.0 / scale,
        "optimized_for": "z18_crop_visibility",
        "pretrained": engine.pretrained,
        "precision": engine.precision,
        "timing": timer.summary(),
    }
    if engine.quantized:
        metadata["precision_note"] = (
            "int8-mixed trunk: the 64->192 x conv of each residual dense "
            "block in int8 (opt-in turbo mode)")
    return final_output, metadata


def process_wow_sr(
    input_tif: Path | str,
    output_dir: Path | str,
    enhance_crops: bool = True,
    model: str = "realesrgan_x4",
    weights_dir: Path | str = "models",
    precomputed_sr=None,
    precision: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Job wrapper + sidecar metadata JSON."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    base_name = Path(input_tif).stem
    wow_tif = output_dir / f"{base_name}_wow_sr.tif"

    output_path, sr_metadata = apply_wow_sr(
        input_path=input_tif,
        output_path=wow_tif,
        enhance_crops=enhance_crops,
        model=model,
        weights_dir=weights_dir,
        precomputed_sr=precomputed_sr,
        precision=precision,
        device=device,
    )

    result = {
        "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
        "input": str(input_tif),
        "outputs": {
            "sr_tif": str(wow_tif) if wow_tif.exists() else None,
            "sr_png": (
                str(wow_tif.with_suffix(".png"))
                if wow_tif.with_suffix(".png").exists() else None
            ),
        },
        "sr_metadata": sr_metadata,
    }
    meta_file = output_dir / f"{base_name}_wow_sr_metadata.json"
    with open(meta_file, "w") as f:
        json.dump(result, f, indent=2)
    logger.info("WOW Super-Resolution complete: %s", meta_file)
    return result
