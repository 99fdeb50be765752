"""High-zoom ESRGAN tile generation (z18–z20), the port of
``s2sr_tpu/pipelines/esrgan_tiles.py``.

WOW SR on the source raster (``apply_wow_sr``: every residual dense block
in ``csrc/rdb.cu`` on the card), then an XYZ pyramid at z18–20 into
``tiles_esrgan/`` with lanczos-3 resampling at these over-zoomed levels,
on ``device`` (the card unless the caller asks for the CPU). Resumes with
``skip_sr`` + ``sr_output`` from an existing SR raster.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..geo import read_geotiff
from ..tiles import create_tileset_metadata, get_raster_info
from ..tiles.pyramid import generate_xyz_tiles as pyramid_tiles
from ..utils import StageTimer, setup_logging
from .wow_sr import apply_wow_sr

logger = setup_logging("s2sr_tpu_torch.esrgan_tiles")


def run_esrgan_and_tiles(
    input_tif: Path | str,
    output_dir: Path | str,
    min_zoom: int = 18,
    max_zoom: int = 20,
    enhance_crops: bool = True,
    skip_sr: bool = False,
    sr_output: Optional[Path | str] = None,
    weights_dir: Path | str = "models",
    device: str = "cuda",
) -> dict:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    timer = StageTimer(total_stages=2)

    if skip_sr and sr_output and Path(sr_output).exists():
        sr_tif = Path(sr_output)
        logger.info("Resuming from existing SR output: %s", sr_tif)
    else:
        with timer.stage("WOW SR"):
            sr_tif, _meta = apply_wow_sr(
                input_tif, output_dir / "esrgan_sr",
                enhance_crops=enhance_crops, weights_dir=weights_dir,
                device=device,
            )

    tiles_dir = output_dir / "tiles_esrgan"
    with timer.stage(f"tiles z{min_zoom}-{max_zoom}"):
        raster = read_geotiff(sr_tif)
        pyramid_tiles(raster, tiles_dir, min_zoom=min_zoom, max_zoom=max_zoom,
                      resampling="lanczos", device=device)
        info = get_raster_info(sr_tif, raster=raster)
        create_tileset_metadata(
            tiles_dir, info.bounds_4326, min_zoom, max_zoom,
            tile_template="/tiles_esrgan/{z}/{x}/{y}.png",
        )

    tile_count = sum(1 for _ in tiles_dir.glob("*/*/*.png"))
    logger.info("esrgan tiles complete: %d tiles", tile_count)
    return {
        "sr_output": str(sr_tif),
        "tiles_dir": str(tiles_dir),
        "tile_count": tile_count,
        "zoom_range": [min_zoom, max_zoom],
        "timing": timer.summary(),
    }
