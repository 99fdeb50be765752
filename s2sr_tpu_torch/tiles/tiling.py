"""Raster→tiles façade (the port of ``s2sr_tpu/tiles/tiling.py``).

The same public surface (RasterInfo, get_raster_info,
reproject_to_web_mercator, generate_xyz_tiles, create_tileset_metadata,
process_raster_to_tiles) on the in-process GeoTIFF codec and the device
warp. Each function that warps takes a ``device`` (default ``cuda``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from ..geo.crs import CRS, transform_bounds
from ..geo.geotiff import GeoTiff, read_geotiff, write_geotiff
from ..geo.warp import warp_to_mercator
from ..utils import setup_logging, write_json
from . import pyramid

logger = setup_logging("s2sr_tpu_torch.tiling")


@dataclass
class RasterInfo:
    """Raster metadata (what ``gdalinfo -json`` extracts)."""

    path: Path
    crs: str
    bounds: list          # [west, south, east, north] native CRS
    bounds_4326: list     # [west, south, east, north] EPSG:4326
    width: int
    height: int
    bands: int
    dtype: str


_GDAL_DTYPES = {
    "uint8": "Byte", "uint16": "UInt16", "int16": "Int16",
    "uint32": "UInt32", "int32": "Int32",
    "float32": "Float32", "float64": "Float64",
}


def get_raster_info(raster_path: Path | str,
                    raster: "GeoTiff | None" = None) -> RasterInfo:
    """Metadata for *raster_path*. Pass an already-read ``raster`` to
    skip a second full decode (multi-hundred-MB SR rasters on one core)."""
    raster_path = Path(raster_path)
    r = raster if raster is not None else read_geotiff(raster_path)
    crs = r.crs or CRS(4326)
    w, s, e, n = r.bounds
    if crs.is_geographic:
        bounds_4326 = [w, s, e, n]
    else:
        bounds_4326 = list(transform_bounds(crs, CRS(4326), w, s, e, n))
    return RasterInfo(
        path=raster_path,
        crs=str(crs),
        bounds=[w, s, e, n],
        bounds_4326=bounds_4326,
        width=r.width,
        height=r.height,
        bands=r.count,
        dtype=_GDAL_DTYPES.get(str(r.data.dtype), str(r.data.dtype)),
    )


def reproject_to_web_mercator(
    input_path: Path | str,
    output_path: Path | str,
    resample_method: str = "bilinear",
    device: str | torch.device = "cuda",
) -> Path:
    """EPSG:3857 intermediate raster (``tiling.py:100-135`` equivalent).
    ``resample_method``: "bilinear" (gdalwarp default here) or
    "near"/"nearest" for categorical rasters."""
    logger.info("Reprojecting to EPSG:3857: %s", input_path)
    raster = read_geotiff(input_path)
    warped = warp_to_mercator(raster, method=resample_method, device=device)
    write_geotiff(warped, output_path)
    logger.info("Reprojection complete: %s", output_path)
    return Path(output_path)


def generate_xyz_tiles(
    input_path: Path | str,
    output_dir: Path | str,
    min_zoom: int = 10,
    max_zoom: int = 16,
    tile_size: int = 256,
    resampling: str = "average",
    device: str | torch.device = "cuda",
) -> Path:
    raster = read_geotiff(input_path)
    # 'average' (the gdal2tiles default) maps to bilinear base-zoom
    # sampling + the alpha-weighted 2x2 'average' overviews;
    # 'lanczos' takes the device lanczos3 warp
    base_resampling = "lanczos" if resampling == "lanczos" else "bilinear"
    return pyramid.generate_xyz_tiles(
        raster, output_dir, min_zoom=min_zoom, max_zoom=max_zoom,
        tile_size=tile_size, resampling=base_resampling, device=device,
    )


def create_tileset_metadata(
    tiles_dir: Path | str,
    bounds_4326: list,
    min_zoom: int,
    max_zoom: int,
    tile_template: str = "/tiles/{z}/{x}/{y}.png",
) -> dict:
    """``tileset.json``, byte-equal to the JAX package's."""
    metadata = {
        "bounds": bounds_4326,
        "minzoom": min_zoom,
        "maxzoom": max_zoom,
        "tileTemplate": tile_template,
        "attribution": "Sentinel-2 SR via UP42",
        "format": "png",
        "tileSize": 256,
    }
    metadata_path = Path(tiles_dir) / "tileset.json"
    write_json(metadata, metadata_path)
    logger.info("Tileset metadata saved: %s", metadata_path)
    return metadata


def process_raster_to_tiles(
    input_path: Path | str,
    tiles_dir: Path | str,
    min_zoom: int = 10,
    max_zoom: int = 16,
    device: str | torch.device = "cuda",
) -> dict:
    """Full raster→tiles pipeline: info, direct device warp into the
    pyramid, tiles, tileset.json. There is no ``<stem>_3857.tif``
    intermediate on disk: the base-zoom warp gathers straight from the
    source raster (:func:`reproject_to_web_mercator` writes one for
    callers that want it)."""
    input_path = Path(input_path)
    logger.info("Processing raster to tiles: %s", input_path)
    raster = read_geotiff(input_path)
    info = get_raster_info(input_path, raster=raster)
    logger.info("Raster CRS: %s bounds(4326): %s", info.crs, info.bounds_4326)
    pyramid.generate_xyz_tiles(
        raster, tiles_dir, min_zoom=min_zoom, max_zoom=max_zoom,
        device=device,
    )
    return create_tileset_metadata(tiles_dir, info.bounds_4326,
                                   min_zoom, max_zoom)
