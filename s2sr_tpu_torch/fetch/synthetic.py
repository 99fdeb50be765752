"""Deterministic synthetic Sentinel-2-like fixtures.

The reference degrades to a random "fields" raster when downloads fail
(``server/app/up42_client.py:664-698``); here that generator is promoted
to a first-class, *seeded* fixture source so the whole framework runs and
tests offline (SURVEY §4). Two products:

- :func:`synthetic_scene` — RGB uint8 GeoTIFF of agricultural parcels
  with roads, field texture and crop rows (EPSG:4326 by default).
- :func:`synthetic_multiband` — (B04, B08, SCL) uint16 stack matching the
  multiband fetcher's output contract (``server/app/fetch_multiband.py:89-193``)
  for NDVI / vector-extraction testing.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..geo import Affine, CRS, GeoTiff, write_geotiff

DEFAULT_BOUNDS = (35.0, 32.0, 35.05, 32.05)  # lon/lat, ~5 km AOI


def _split_parcels(
    rng: np.random.Generator, w: int, h: int, min_size: int
) -> List[Tuple[int, int, int, int]]:
    """Recursive binary-space partition into field parcels (x0, y0, x1, y1)."""
    stack = [(0, 0, w, h)]
    parcels: List[Tuple[int, int, int, int]] = []
    while stack:
        x0, y0, x1, y1 = stack.pop()
        pw, ph = x1 - x0, y1 - y0
        must_split = pw > 3 * min_size or ph > 3 * min_size
        done = pw <= 2 * min_size and ph <= 2 * min_size
        if not must_split and (done or rng.random() < 0.15):
            parcels.append((x0, y0, x1, y1))
            continue
        if pw >= ph:
            cut = int(rng.integers(x0 + min_size, x1 - min_size))
            stack += [(x0, y0, cut, y1), (cut, y0, x1, y1)]
        else:
            cut = int(rng.integers(y0 + min_size, y1 - min_size))
            stack += [(x0, y0, x1, cut), (x0, cut, x1, y1)]
    return parcels


def synthetic_fields(
    size: Tuple[int, int] = (512, 512),
    seed: int = 0,
    min_parcel: int = 48,
) -> np.ndarray:
    """Seeded RGB uint8 agricultural scene (H, W, 3)."""
    h, w = size
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), dtype=np.float32)

    # crop / bare-soil palette (RGB)
    palette = np.array([
        [60, 110, 45],    # dense crop
        [85, 140, 60],    # young crop
        [120, 150, 70],   # mixed vegetation
        [150, 125, 85],   # dry field
        [170, 150, 110],  # bare soil
        [110, 95, 70],    # ploughed
    ], dtype=np.float32)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for (x0, y0, x1, y1) in _split_parcels(rng, w, h, min_parcel):
        base = palette[rng.integers(len(palette))]
        tone = base * float(rng.uniform(0.85, 1.15))
        patch = np.broadcast_to(tone, (y1 - y0, x1 - x0, 3)).copy()
        # crop-row texture: sinusoid along a random orientation
        theta = float(rng.uniform(0, np.pi))
        period = float(rng.uniform(4.0, 9.0))
        proj = (xx[y0:y1, x0:x1] * np.cos(theta)
                + yy[y0:y1, x0:x1] * np.sin(theta))
        rows = 6.0 * np.sin(2 * np.pi * proj / period)
        patch += rows[:, :, None]
        img[y0:y1, x0:x1] = patch
        # parcel boundary (dirt track)
        img[y0:y1, x0] = [140, 125, 100]
        img[y0, x0:x1] = [140, 125, 100]

    # a couple of roads crossing the AOI
    for _ in range(2):
        x = float(rng.uniform(0.2, 0.8)) * w
        drift = rng.normal(0, 0.4, h).cumsum()
        cols = np.clip((x + drift).astype(int), 1, w - 2)
        r = np.arange(h)
        for dx in (-1, 0, 1):
            img[r, cols + dx] = [185, 180, 170]

    img += rng.normal(0, 2.5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_scene(
    path: Optional[Path | str] = None,
    size: Tuple[int, int] = (512, 512),
    bounds: Sequence[float] = DEFAULT_BOUNDS,
    crs: int = 4326,
    seed: int = 0,
) -> GeoTiff:
    """Georeferenced RGB fixture scene; optionally written to *path*."""
    h, w = size
    img = synthetic_fields(size=size, seed=seed)
    west, south, east, north = bounds
    transform = Affine.from_bounds(west, south, east, north, w, h)
    raster = GeoTiff(img, transform=transform, crs=CRS(crs))
    if path is not None:
        write_geotiff(raster, path)
    return raster


def synthetic_multiband(
    path: Optional[Path | str] = None,
    size: Tuple[int, int] = (256, 256),
    bounds: Sequence[float] = DEFAULT_BOUNDS,
    seed: int = 0,
) -> GeoTiff:
    """(B04 red, B08 nir, SCL) uint16 stack with realistic NDVI contrast.

    Vegetated parcels get high NIR/low red (NDVI ≈ 0.6–0.9), bare parcels
    the reverse; a stripe of SCL=9 (cloud) exercises SCL masking
    (``server/app/vector_extraction_v2.py:269-271``).
    """
    h, w = size
    rng = np.random.default_rng(seed)
    red = np.zeros((h, w), np.float32)
    nir = np.zeros((h, w), np.float32)
    for (x0, y0, x1, y1) in _split_parcels(rng, w, h, max(24, min(h, w) // 8)):
        vegetated = rng.random() < 0.6
        if vegetated:
            r, n = rng.uniform(300, 700), rng.uniform(2500, 4200)
        else:
            r, n = rng.uniform(1500, 2600), rng.uniform(1800, 2900)
        red[y0:y1, x0:x1] = r + rng.normal(0, 40, (y1 - y0, x1 - x0))
        nir[y0:y1, x0:x1] = n + rng.normal(0, 60, (y1 - y0, x1 - x0))
    scl = np.full((h, w), 4, np.uint16)            # vegetation class
    scl[:, : w // 16] = 9                           # cloud-high-prob stripe
    stack = np.stack([
        np.clip(red, 1, 10000).astype(np.uint16),
        np.clip(nir, 1, 10000).astype(np.uint16),
        scl,
    ], axis=-1)
    west, south, east, north = bounds
    transform = Affine.from_bounds(west, south, east, north, w, h)
    raster = GeoTiff(stack, transform=transform, crs=CRS(4326))
    if path is not None:
        write_geotiff(raster, path)
    return raster
