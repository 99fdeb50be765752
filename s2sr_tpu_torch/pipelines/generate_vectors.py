"""Vector-generation wrapper: finds the best raster, runs v1 extraction.

The port of ``s2sr_tpu/pipelines/generate_vectors.py``: search order
wow > sr > source (newest mtime), then field extraction into
``data/vectors``, on ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..config import get_settings
from ..utils import setup_logging
from ..vectors.extraction import ExtractionConfig, extract_field_polygons

logger = setup_logging("s2sr_tpu_torch.generate_vectors")


def find_best_raster(data_dir: Path | str) -> Optional[Path]:
    """wow > sr > source, newest first."""
    data_dir = Path(data_dir)
    for sub in ("wow", "sr", "source"):
        d = data_dir / sub
        if d.exists():
            tifs = sorted(d.rglob("*.tif"), key=lambda p: p.stat().st_mtime,
                          reverse=True)
            if tifs:
                logger.info("Using raster from %s: %s", sub, tifs[0].name)
                return tifs[0]
    return None


def generate_vectors(
    aoi_path: Optional[Path | str] = None,
    raster_path: Optional[Path | str] = None,
    out_dir: Optional[Path | str] = None,
    config: Optional[ExtractionConfig] = None,
    device: str = "cuda",
) -> dict:
    settings = get_settings()
    data_dir = Path(settings.data_dir)
    aoi_path = Path(aoi_path or settings.aoi_path)
    if raster_path is None:
        raster_path = find_best_raster(data_dir)
        if raster_path is None:
            raise FileNotFoundError(
                "No raster found under data/{wow,sr,source}; run the "
                "pipeline first or pass raster_path")
    out_dir = Path(out_dir or data_dir / "vectors")
    return extract_field_polygons(aoi_path, [Path(raster_path)], out_dir,
                                  config, device=device)
