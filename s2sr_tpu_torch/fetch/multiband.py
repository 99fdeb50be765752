"""Multiband (B04/B08/SCL) fetch + stack for NDVI vector extraction (the
port of ``s2sr_tpu/fetch/multiband.py``).

STAC search, per-band windowed download, the bands warped onto one
EPSG:4326 grid on ``device`` (the card unless the caller asks for the
CPU): bilinear for red and NIR, nearest for the SCL class codes, which
must never be interpolated. The 3-band uint16 stack is written as a
GeoTIFF. Offline mode produces the deterministic synthetic multiband
fixture.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Settings, get_settings
from ..geo import Affine, CRS, GeoTiff, write_geotiff
from ..geo.warp import control_grid, warp_bilinear_batch, warp_nearest_batch
from ..utils import ensure_directory, setup_logging, write_json
from .client import (
    EARTH_SEARCH,
    PublicSentinel2Client,
    Scene,
    _aoi_bounds,
    http_json,
    stac_payload,
)
from .synthetic import synthetic_multiband

logger = setup_logging("s2sr_tpu_torch.fetch_multiband")


@dataclass
class FetchConfig:
    max_age_days: int = 30
    max_cloud_pct: float = 30.0
    out_size: int = 1024
    collections: tuple = ("sentinel-2-l2a",)


def _stac_search(aoi_geometry: dict, config: FetchConfig) -> Optional[Scene]:
    payload = stac_payload(aoi_geometry, config.max_age_days,
                           config.max_cloud_pct, 5, config.collections)
    features = http_json(EARTH_SEARCH, 30, json_body=payload).get(
        "features", [])
    return Scene.from_stac_feature(features[0]) if features else None


def _warp_band_to_grid(band: GeoTiff, dst_transform: Affine,
                       dst_crs: CRS, size: int,
                       categorical: bool = False,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """One band warped onto the output grid on ``device`` → (size, size)
    float32. ``categorical`` selects nearest-neighbour (SCL class
    codes)."""
    ctrl = control_grid(dst_transform, dst_crs, band.transform,
                        band.crs or dst_crs, size, size)
    src = torch.from_numpy(band.data[:, :, :1].astype(np.float32)).to(device)
    warp = warp_nearest_batch if categorical else warp_bilinear_batch
    out, _ = warp(src, torch.from_numpy(ctrl)[None].to(device), size, size)
    return out[0, :, :, 0].cpu().numpy()


def fetch_and_stack_multiband(
    aoi_geometry: dict,
    output_dir: Path | str,
    config: Optional[FetchConfig] = None,
    settings: Optional[Settings] = None,
    device: str | torch.device = "cuda",
) -> Tuple[Path, dict]:
    """B04/B08/SCL → single 3-band uint16 GeoTIFF in EPSG:4326.
    ``settings`` (default :func:`get_settings`) gives ``offline``."""
    settings = settings or get_settings()
    config = config or FetchConfig()
    output_dir = ensure_directory(output_dir)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    out_path = Path(output_dir) / f"{ts}_multiband.tif"

    w, s, e, n = _aoi_bounds(aoi_geometry)
    dst_transform = Affine.from_bounds(w, s, e, n,
                                       config.out_size, config.out_size)

    if settings.offline:
        logger.info("offline: synthesizing multiband fixture")
        raster = synthetic_multiband(size=(config.out_size, config.out_size),
                                     bounds=(w, s, e, n))
        write_geotiff(raster, out_path)
        metadata = {
            "scene_id": "synthetic_multiband",
            "bands": ["B04", "B08", "SCL"],
            "source": "synthetic_fallback",
            "file_path": str(out_path),
        }
        write_json(metadata, out_path.with_suffix(".json"))
        return out_path, metadata

    scene = _stac_search(aoi_geometry, config)
    if scene is None:
        raise RuntimeError("no scenes found for multiband fetch")
    client = PublicSentinel2Client(settings, device=device)

    bands = {}
    for key in ("red", "nir", "scl"):
        href = scene.assets.get(key, {}).get("href")
        if not href:
            raise RuntimeError(f"scene {scene.scene_id} missing asset {key}")
        bands[key] = client._download_asset(href, aoi_geometry)

    size = config.out_size
    grid = (dst_transform, CRS(4326), size)
    red = _warp_band_to_grid(bands["red"], *grid, device=device)
    nir = _warp_band_to_grid(bands["nir"], *grid, device=device)
    scl = _warp_band_to_grid(bands["scl"], *grid, categorical=True,
                             device=device)
    stack = np.stack([
        np.clip(red, 0, 65535), np.clip(nir, 0, 65535),
        np.clip(scl, 0, 255),
    ], axis=-1).astype(np.uint16)
    write_geotiff(GeoTiff(stack, transform=dst_transform, crs=CRS(4326)),
                  out_path)
    metadata = {
        "scene_id": scene.scene_id,
        "acquisition_date": scene.acquisition_date.isoformat(),
        "cloud_cover_pct": scene.cloud_cover,
        "bands": ["B04", "B08", "SCL"],
        "source": "aws_earth_search",
        "file_path": str(out_path),
    }
    write_json(metadata, out_path.with_suffix(".json"))
    return out_path, metadata
