"""Coordinate reference systems and datum math (no pyproj/GDAL).

Supports the CRS set the reference actually uses (SURVEY §1 L2):
EPSG:4326 (WGS84 lat/lon), EPSG:3857 (spherical Web Mercator — what
``gdalwarp -t_srs EPSG:3857`` produces, ``server/app/tiling.py:120-129``),
and UTM zones EPSG:326xx/327xx (Sentinel-2 native grids).

UTM uses the 6th-order Krüger/Karney transverse-Mercator series
(sub-millimetre accuracy); Web Mercator uses the exact spherical
formulas. All transforms are vectorised numpy and round-trip to <1e-9 deg.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# WGS84 ellipsoid
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
# Third flattening and rectifying-sphere radius for the Krüger series
_N = WGS84_F / (2.0 - WGS84_F)
_A_BAR = WGS84_A / (1.0 + _N) * (1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0)
_ALPHA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 5.0 * _N**3 / 16.0,
    13.0 * _N**2 / 48.0 - 3.0 * _N**3 / 5.0,
    61.0 * _N**3 / 240.0,
)
_BETA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 37.0 * _N**3 / 96.0,
    _N**2 / 48.0 + _N**3 / 15.0,
    17.0 * _N**3 / 480.0,
)
_DELTA = (
    2.0 * _N - 2.0 * _N**2 / 3.0 - 2.0 * _N**3,
    7.0 * _N**2 / 3.0 - 8.0 * _N**3 / 5.0,
    56.0 * _N**3 / 15.0,
)
_UTM_K0 = 0.9996
_UTM_FE = 500_000.0
_UTM_FN_SOUTH = 10_000_000.0

# Spherical Web Mercator radius (EPSG:3857)
MERCATOR_R = 6378137.0
MERCATOR_EXTENT = math.pi * MERCATOR_R  # half-width of the world in metres


@dataclass(frozen=True)
class CRS:
    epsg: int

    @classmethod
    def from_string(cls, s: "str | CRS | int") -> "CRS":
        if isinstance(s, CRS):
            return s
        if isinstance(s, int):
            return cls(s)
        m = re.match(r"(?i)epsg:\s*(\d+)$", s.strip())
        if not m:
            raise ValueError(f"unsupported CRS string: {s!r}")
        return cls(int(m.group(1)))

    def __str__(self) -> str:
        return f"EPSG:{self.epsg}"

    @property
    def is_geographic(self) -> bool:
        return self.epsg == 4326

    @property
    def is_mercator(self) -> bool:
        return self.epsg == 3857

    @property
    def utm_zone(self) -> Tuple[int, bool] | None:
        """(zone, is_north) if this is a WGS84 UTM CRS else None."""
        if 32601 <= self.epsg <= 32660:
            return self.epsg - 32600, True
        if 32701 <= self.epsg <= 32760:
            return self.epsg - 32700, False
        return None

    @classmethod
    def utm_for(cls, lon: float, lat: float) -> "CRS":
        zone = int((lon + 180.0) // 6.0) + 1
        zone = min(max(zone, 1), 60)
        return cls((32600 if lat >= 0 else 32700) + zone)


# --- Web Mercator ------------------------------------------------------

def lonlat_to_mercator(lon: np.ndarray, lat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.clip(np.asarray(lat, dtype=np.float64), -85.051128779806589, 85.051128779806589)
    x = MERCATOR_R * np.radians(lon)
    y = MERCATOR_R * np.log(np.tan(np.pi / 4.0 + np.radians(lat) / 2.0))
    return x, y


def mercator_to_lonlat(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lon = np.degrees(x / MERCATOR_R)
    lat = np.degrees(2.0 * np.arctan(np.exp(y / MERCATOR_R)) - np.pi / 2.0)
    return lon, lat


# --- UTM (Krüger/Karney series) ----------------------------------------

def lonlat_to_utm(
    lon: np.ndarray, lat: np.ndarray, zone: int, north: bool
) -> Tuple[np.ndarray, np.ndarray]:
    lon = np.radians(np.asarray(lon, dtype=np.float64))
    lat = np.radians(np.asarray(lat, dtype=np.float64))
    lon0 = math.radians(zone * 6.0 - 183.0)

    two_sqrt_n = 2.0 * math.sqrt(_N) / (1.0 + _N)
    sin_lat = np.sin(lat)
    t = np.sinh(np.arctanh(sin_lat) - two_sqrt_n * np.arctanh(two_sqrt_n * sin_lat))
    dlon = lon - lon0
    xi_p = np.arctan2(t, np.cos(dlon))
    eta_p = np.arctanh(np.sin(dlon) / np.sqrt(1.0 + t * t))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j, alpha in enumerate(_ALPHA, start=1):
        xi += alpha * np.sin(2.0 * j * xi_p) * np.cosh(2.0 * j * eta_p)
        eta += alpha * np.cos(2.0 * j * xi_p) * np.sinh(2.0 * j * eta_p)

    easting = _UTM_FE + _UTM_K0 * _A_BAR * eta
    northing = (0.0 if north else _UTM_FN_SOUTH) + _UTM_K0 * _A_BAR * xi
    return easting, northing


def utm_to_lonlat(
    easting: np.ndarray, northing: np.ndarray, zone: int, north: bool
) -> Tuple[np.ndarray, np.ndarray]:
    easting = np.asarray(easting, dtype=np.float64)
    northing = np.asarray(northing, dtype=np.float64)
    lon0 = math.radians(zone * 6.0 - 183.0)

    xi = (northing - (0.0 if north else _UTM_FN_SOUTH)) / (_UTM_K0 * _A_BAR)
    eta = (easting - _UTM_FE) / (_UTM_K0 * _A_BAR)

    xi_p = xi.copy()
    eta_p = eta.copy()
    for j, beta in enumerate(_BETA, start=1):
        xi_p -= beta * np.sin(2.0 * j * xi) * np.cosh(2.0 * j * eta)
        eta_p -= beta * np.cos(2.0 * j * xi) * np.sinh(2.0 * j * eta)

    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    lat = chi.copy()
    for j, delta in enumerate(_DELTA, start=1):
        lat += delta * np.sin(2.0 * j * chi)
    lon = lon0 + np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.degrees(lon), np.degrees(lat)


# --- generic hub-and-spoke transform -----------------------------------

def _to_lonlat(crs: CRS, x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if crs.is_geographic:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    if crs.is_mercator:
        return mercator_to_lonlat(x, y)
    utm = crs.utm_zone
    if utm is not None:
        return utm_to_lonlat(x, y, utm[0], utm[1])
    raise ValueError(f"unsupported CRS {crs}")


def _from_lonlat(crs: CRS, lon: np.ndarray, lat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if crs.is_geographic:
        return lon, lat
    if crs.is_mercator:
        return lonlat_to_mercator(lon, lat)
    utm = crs.utm_zone
    if utm is not None:
        return lonlat_to_utm(lon, lat, utm[0], utm[1])
    raise ValueError(f"unsupported CRS {crs}")


def transform_points(
    src: "CRS | str | int", dst: "CRS | str | int", x: np.ndarray, y: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Transform coordinate arrays from *src* to *dst* CRS."""
    src, dst = CRS.from_string(src), CRS.from_string(dst)
    if src == dst:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    lon, lat = _to_lonlat(src, x, y)
    return _from_lonlat(dst, lon, lat)


def transform_bounds(
    src: "CRS | str | int", dst: "CRS | str | int",
    west: float, south: float, east: float, north: float,
    densify: int = 21,
) -> Tuple[float, float, float, float]:
    """Transform a bounding box by densifying its edges (matches the
    envelope GDAL reports as ``wgs84Extent``, ``server/app/tiling.py:68-75``)."""
    t = np.linspace(0.0, 1.0, densify)
    xs = np.concatenate([
        west + (east - west) * t, np.full(densify, east),
        east + (west - east) * t, np.full(densify, west),
    ])
    ys = np.concatenate([
        np.full(densify, south), south + (north - south) * t,
        np.full(densify, north), north + (south - north) * t,
    ])
    tx, ty = transform_points(src, dst, xs, ys)
    return float(tx.min()), float(ty.min()), float(tx.max()), float(ty.max())
