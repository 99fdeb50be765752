"""XYZ tile-pyramid generation with device-side warping (the port of
``s2sr_tpu/tiles/pyramid.py``).

- base (max) zoom: every intersecting tile is produced by the batched
  inverse-mapping bilinear warp straight from the source raster on the
  device, 32 tiles per batch, warped, quantised and packed to RGBA
  uint8 there, with one device-to-host copy per batch;
- lower zooms: 2×2 alpha-weighted averaging of child tiles on the host
  (the ``average`` resampler);
- output: ``{out}/{z}/{x}/{y}.png`` RGBA, XYZ addressing, encoded by the
  port's pure-Python PNG encoder.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..geo.affine import Affine
from ..geo.crs import CRS, transform_bounds
from ..geo.geotiff import GeoTiff
from ..geo.warp import control_grid, warp_bilinear_batch, warp_lanczos_batch
from ..ops.color import div
from ..utils import ensure_directory, setup_logging
from .mercator import TILE_SIZE, resolution, tile_bounds, tiles_for_bounds
from .png import encode_png

logger = setup_logging("s2sr_tpu_torch.tiles")

TileKey = Tuple[int, int]
TileStore = Dict[TileKey, np.ndarray]  # (256, 256, 4) uint8 RGBA


def base_zoom_batches(raster: GeoTiff, zoom: int,
                      tile_size: int = TILE_SIZE, batch: int = 32,
                      grid: int = 17):
    """Yield (tile keys, (n, grid, grid, 2) float32 control grids) for
    every batch of the XYZ tiles at ``zoom`` that intersect the raster."""
    assert raster.crs is not None
    w, s, e, n = raster.bounds
    bounds_3857 = transform_bounds(raster.crs, CRS(3857), w, s, e, n)
    keys = list(tiles_for_bounds(bounds_3857, zoom))
    res = resolution(zoom, tile_size)
    for i in range(0, len(keys), batch):
        chunk = keys[i:i + batch]
        ctrls = np.stack([
            control_grid(
                Affine.from_origin(tile_bounds(zoom, x, y)[0],
                                   tile_bounds(zoom, x, y)[3], res, res),
                CRS(3857), raster.transform, raster.crs,
                tile_size, tile_size, grid=grid,
            )
            for x, y in chunk
        ])
        yield chunk, ctrls


def _base_zoom_tiles(
    raster: GeoTiff,
    zoom: int,
    tile_size: int = TILE_SIZE,
    batch: int = 32,
    grid: int = 17,
    resampling: str = "bilinear",
    device: str | torch.device = "cuda",
) -> TileStore:
    """Warp source → all intersecting XYZ tiles at *zoom* (device batched)."""
    src = torch.from_numpy(_rgba_source(raster)).to(device)
    store: TileStore = {}
    for chunk, ctrls in base_zoom_batches(raster, zoom, tile_size, batch,
                                          grid):
        rgba = _warp_tiles_rgba_u8(src, torch.from_numpy(ctrls).to(device),
                                   tile_size, resampling == "lanczos")
        rgba = rgba.cpu().numpy()   # uint8 off the device: 4× less copy
        for j, key in enumerate(chunk):
            if rgba[j, :, :, 3].any():
                store[key] = rgba[j]
    return store


def _rgba_source(raster: GeoTiff) -> np.ndarray:
    """(H, W, 4) float32 RGB + 0-255 validity channel: honours a source
    alpha band and the raster's nodata value, so gdal2tiles'
    transparency comes out where a bare ``[:, :, :3]`` slice would render
    opaque black."""
    data = raster.data
    rgb = data[:, :, :3].astype(np.float32)
    alpha = np.full(rgb.shape[:2], 255.0, np.float32)
    if data.ndim == 3 and data.shape[2] >= 4:
        a = data[:, :, 3].astype(np.float32)
        if data.dtype == np.uint16:
            a = a / 257.0          # 65535 → 255
        elif data.dtype != np.uint8:
            a = np.clip(a, 0.0, 1.0) * 255.0
        alpha = a
    nodata = getattr(raster, "nodata", None)
    if nodata is not None:
        alpha = np.where(np.all(data[:, :, :3] == nodata, axis=-1),
                         0.0, alpha)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def _warp_tiles_rgba_u8(src: torch.Tensor, ctrls: torch.Tensor,
                        tile_size: int, lanczos: bool) -> torch.Tensor:
    """Warp + quantise + pack RGBA on the device: (B, T, T, 4) uint8.

    ``src`` is (H, W, 3) RGB or (H, W, 4) RGB+validity; the final alpha
    is the footprint coverage times the warped source validity."""
    warp_fn = warp_lanczos_batch if lanczos else warp_bilinear_batch
    out, coverage = warp_fn(src, ctrls, tile_size, tile_size)
    if src.shape[-1] >= 4:
        rgb = out[..., :3]
        alpha = div(out[..., 3].clamp(0, 255), 255.0) * coverage
    else:
        rgb = out
        alpha = coverage
    rgb_u8 = torch.round(rgb).clamp(0, 255).to(torch.uint8)
    alpha_u8 = torch.round(alpha * 255).to(torch.uint8)
    return torch.cat([rgb_u8, alpha_u8[..., None]], dim=-1)


def _downsample_level(children: TileStore, tile_size: int = TILE_SIZE) -> TileStore:
    """Parent zoom level from children: 2×2 alpha-weighted average."""
    parents: TileStore = {}
    half = tile_size // 2
    for (cx, cy), child in children.items():
        px, py = cx // 2, cy // 2
        if (px, py) not in parents:
            parents[(px, py)] = np.zeros((tile_size, tile_size, 4), np.uint8)
        # 2×2 alpha-weighted block mean
        c = child.astype(np.float32)
        a = c[..., 3:4] / 255.0
        wsum = a.reshape(half, 2, half, 2, 1).sum(axis=(1, 3))
        csum = (c[..., :3] * a).reshape(half, 2, half, 2, 3).sum(axis=(1, 3))
        rgb = np.where(wsum > 0, csum / np.maximum(wsum, 1e-6), 0.0)
        alpha = wsum / 4.0 * 255.0
        quad = np.concatenate(
            [np.clip(np.round(rgb), 0, 255),
             np.clip(np.round(alpha), 0, 255)], axis=-1).astype(np.uint8)
        oy = (cy % 2) * half
        ox = (cx % 2) * half
        parents[(px, py)][oy:oy + half, ox:ox + half] = quad
    return parents


def generate_xyz_tiles(
    raster: GeoTiff,
    output_dir: Path | str,
    min_zoom: int = 10,
    max_zoom: int = 16,
    tile_size: int = TILE_SIZE,
    batch: int = 32,
    png_level: int = 3,
    resampling: str = "bilinear",
    device: str | torch.device = "cuda",
) -> Path:
    """Full pyramid → ``{z}/{x}/{y}.png`` tree under *output_dir*."""
    output_dir = ensure_directory(output_dir)
    logger.info("Generating XYZ tiles: zoom %d-%d", min_zoom, max_zoom)
    level = _base_zoom_tiles(raster, max_zoom, tile_size, batch,
                             resampling=resampling, device=device)
    count = 0
    for z in range(max_zoom, min_zoom - 1, -1):
        for (x, y), tile in level.items():
            tile_path = output_dir / str(z) / str(x) / f"{y}.png"
            tile_path.parent.mkdir(parents=True, exist_ok=True)
            tile_path.write_bytes(encode_png(tile, level=png_level))
            count += 1
        if z > min_zoom:
            level = _downsample_level(level, tile_size)
    logger.info("Tile generation complete: %d tiles → %s", count, output_dir)
    return output_dir
