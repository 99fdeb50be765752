"""XYZ / Web-Mercator tile grid math (what gdal2tiles computes internally).

The port's copy of ``s2sr_tpu/tiles/mercator.py``: 256-px tiles, XYZ
naming (y counts from the north), EPSG:3857 square world.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

from ..geo.crs import MERCATOR_EXTENT

TILE_SIZE = 256
WORLD = 2.0 * MERCATOR_EXTENT  # full world width in metres


def resolution(zoom: int, tile_size: int = TILE_SIZE) -> float:
    """Metres per pixel at *zoom*."""
    return WORLD / (tile_size * (1 << zoom))


def tile_bounds(z: int, x: int, y: int) -> Tuple[float, float, float, float]:
    """(west, south, east, north) of XYZ tile in EPSG:3857 metres."""
    size = WORLD / (1 << z)
    west = -MERCATOR_EXTENT + x * size
    north = MERCATOR_EXTENT - y * size
    return (west, north - size, west + size, north)


def mercator_to_tile(mx: float, my: float, z: int) -> Tuple[int, int]:
    """XYZ tile containing a mercator point."""
    size = WORLD / (1 << z)
    x = int(math.floor((mx + MERCATOR_EXTENT) / size))
    y = int(math.floor((MERCATOR_EXTENT - my) / size))
    n = (1 << z) - 1
    return (min(max(x, 0), n), min(max(y, 0), n))


def tiles_for_bounds(
    bounds_3857: Tuple[float, float, float, float], z: int
) -> Iterator[Tuple[int, int]]:
    """All XYZ tiles at *z* intersecting mercator *bounds* (w, s, e, n)."""
    w, s, e, n = bounds_3857
    x0, y0 = mercator_to_tile(w, n, z)   # NW corner
    x1, y1 = mercator_to_tile(e, s, z)   # SE corner
    # exclusive upper edges: a bound exactly on a tile seam should not
    # drag in the next (empty) tile row/column
    size = WORLD / (1 << z)
    if x1 > x0 and math.isclose((e + MERCATOR_EXTENT) / size, x1, abs_tol=1e-9):
        x1 -= 1
    if y1 > y0 and math.isclose((MERCATOR_EXTENT - s) / size, y1, abs_tol=1e-9):
        y1 -= 1
    for ty in range(y0, y1 + 1):
        for tx in range(x0, x1 + 1):
            yield (tx, ty)


def tile_count(bounds_3857, min_zoom: int, max_zoom: int) -> int:
    return sum(
        len(list(tiles_for_bounds(bounds_3857, z)))
        for z in range(min_zoom, max_zoom + 1)
    )
