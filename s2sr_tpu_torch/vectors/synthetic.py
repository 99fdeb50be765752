"""Planted-field scenes: rasters whose field count is known to be > 0.

The offline synthetic source scene is flat and segments to no field, so
it proves nothing about the vector chain. A planted scene holds
irregular green fields (unions of a few ellipses) on a grey, slightly
noisy background at 2.5 m pixels: each field's distance-transform core
falls between the default ``min_area_ha`` and ``max_area_ha``. Made
from a seed with numpy.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..geo import CRS, Affine, GeoTiff, write_geotiff

PIXEL_M = 2.5
ORIGIN = (35.0, 32.0)          # lon, lat of the top-left corner


def planted_field_rgb(size: int, seed: int = 0) -> np.ndarray:
    """(size, size, 3) uint8: green fields on a grey background."""
    rng = np.random.default_rng(seed)
    rmax = min(50.0, size / 6.0)
    cell = int(2.5 * rmax)
    fields = np.zeros((size, size), bool)
    for cy0 in range(0, size - cell + 1, cell):
        for cx0 in range(0, size - cell + 1, cell):
            if rng.random() < 0.2:
                continue
            cy = cy0 + cell / 2 + rng.uniform(-0.1, 0.1) * cell
            cx = cx0 + cell / 2 + rng.uniform(-0.1, 0.1) * cell
            # the lobes stay inside the cell: evaluate them there only
            yy, xx = np.mgrid[cy0:cy0 + cell, cx0:cx0 + cell].astype(np.float32)
            win = fields[cy0:cy0 + cell, cx0:cx0 + cell]
            for _ in range(3):
                ry, rx = rng.uniform(0.55, 0.95, 2) * rmax
                oy, ox = rng.uniform(-0.3, 0.3, 2) * rmax
                ang = rng.uniform(0, np.pi)
                dy, dx = yy - (cy + oy), xx - (cx + ox)
                u = dy * np.cos(ang) + dx * np.sin(ang)
                v = -dy * np.sin(ang) + dx * np.cos(ang)
                win |= (u / ry) ** 2 + (v / rx) ** 2 <= 1.0
    bg = np.array([122, 120, 118], np.float32)
    green = np.array([62, 132, 52], np.float32)
    rgb = np.where(fields[..., None], green, bg)
    rgb = rgb + rng.normal(0, 3, (size, size, 3)) * np.where(
        fields[..., None], 2.5, 1.0)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def planted_transform(pixel_m: float = PIXEL_M) -> Affine:
    deg = pixel_m / 111000.0
    return Affine.from_origin(ORIGIN[0], ORIGIN[1], deg, deg)


def planted_bands(size: int, seed: int = 0) -> np.ndarray:
    """(size, size, 5) uint8: the planted RGB, then a near-infrared band
    bright on the fields and a red-edge band between."""
    rgb = planted_field_rgb(size, seed)
    fields = rgb[..., 1].astype(np.int32) - rgb[..., 0] > 30
    rng = np.random.default_rng(seed + 1)
    nir = np.where(fields, 190, 70) + rng.normal(0, 4, (size, size))
    edge = np.where(fields, 140, 90) + rng.normal(0, 4, (size, size))
    extra = np.clip(np.rint(np.stack([nir, edge], -1)), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, extra], -1)


def write_planted_scene(out_dir: Path | str, size: int, seed: int = 0,
                        name: str = "planted", bands: int = 3) -> tuple:
    """Write ``<name>.tif`` (EPSG:4326, 2.5 m pixels; 3 bands, or 5 with
    :func:`planted_bands`) and an AOI GeoJSON inset by 2% of the side →
    (tif path, aoi path)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    transform = planted_transform()
    tif = out_dir / f"{name}.tif"
    data = planted_bands(size, seed) if bands == 5 else planted_field_rgb(size, seed)
    write_geotiff(GeoTiff(data, transform=transform, crs=CRS(4326)), tif)
    deg = transform.a
    inset = 0.02 * size * deg
    x0, y1 = ORIGIN[0] + inset, ORIGIN[1] - inset
    x1, y0 = ORIGIN[0] + size * deg - inset, ORIGIN[1] - size * deg + inset
    aoi = out_dir / f"{name}_aoi.geojson"
    aoi.write_text(json.dumps({
        "type": "Feature", "properties": {},
        "geometry": {"type": "Polygon", "coordinates": [[
            [x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]]]}}))
    return tif, aoi
