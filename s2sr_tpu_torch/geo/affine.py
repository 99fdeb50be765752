"""2-D affine geotransforms.

Replaces the ``affine``/rasterio ``Affine`` dependency (absent in this
image). Same coefficient convention as rasterio, used all over the
reference (e.g. the x4 rescale ``server/app/wow_sr.py:128-135``):

    x = a * col + b * row + c
    y = d * col + e * row + f

``c, f`` is the coordinate of the *outer corner* of the top-left pixel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Tuple


@dataclass(frozen=True)
class Affine:
    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    # --- constructors -------------------------------------------------
    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    @classmethod
    def translation(cls, tx: float, ty: float) -> "Affine":
        return cls(1.0, 0.0, tx, 0.0, 1.0, ty)

    @classmethod
    def scale(cls, sx: float, sy: float | None = None) -> "Affine":
        sy = sx if sy is None else sy
        return cls(sx, 0.0, 0.0, 0.0, sy, 0.0)

    @classmethod
    def from_origin(cls, west: float, north: float, xsize: float, ysize: float) -> "Affine":
        """North-up transform from the top-left corner and pixel sizes.

        ``ysize`` is positive; the row coefficient becomes ``-ysize``.
        """
        return cls(xsize, 0.0, west, 0.0, -ysize, north)

    @classmethod
    def from_bounds(
        cls, west: float, south: float, east: float, north: float,
        width: int, height: int,
    ) -> "Affine":
        return cls.from_origin(west, north, (east - west) / width, (north - south) / height)

    @classmethod
    def from_gdal(cls, c: float, a: float, b: float, f: float, d: float, e: float) -> "Affine":
        return cls(a, b, c, d, e, f)

    # --- algebra ------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Affine):
            return Affine(
                self.a * other.a + self.b * other.d,
                self.a * other.b + self.b * other.e,
                self.a * other.c + self.b * other.f + self.c,
                self.d * other.a + self.e * other.d,
                self.d * other.b + self.e * other.e,
                self.d * other.c + self.e * other.f + self.f,
            )
        col, row = other
        return (
            self.a * col + self.b * row + self.c,
            self.d * col + self.e * row + self.f,
        )

    def __invert__(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        # NB: tiny determinants are legitimate (a geographic 10 m pixel
        # gives det ~1e-9), so no absolute tolerance — test exact zero,
        # then catch numeric overflow of the division explicitly
        if det == 0.0:
            raise ValueError("affine transform is not invertible")
        ia, ib = self.e / det, -self.b / det
        id_, ie = -self.d / det, self.a / det
        if not all(math.isfinite(v) for v in (ia, ib, id_, ie)):
            raise ValueError("affine transform is numerically singular")
        return Affine(
            ia, ib, -(ia * self.c + ib * self.f),
            id_, ie, -(id_ * self.c + ie * self.f),
        )

    def __iter__(self) -> Iterator[float]:
        yield from (self.a, self.b, self.c, self.d, self.e, self.f)

    # --- helpers ------------------------------------------------------
    def to_gdal(self) -> Tuple[float, float, float, float, float, float]:
        return (self.c, self.a, self.b, self.f, self.d, self.e)

    def rescaled(self, factor: float) -> "Affine":
        """Pixel-size shrink for an SR upscale: the exact transform the
        reference writes after x4 SR (``server/app/wow_sr.py:128-135``).
        All four linear coefficients divide (== self * Affine.scale(1/f))
        so rotated/sheared grids rescale correctly too."""
        return Affine(self.a / factor, self.b / factor, self.c,
                      self.d / factor, self.e / factor, self.f)

    def bounds(self, width: int, height: int) -> Tuple[float, float, float, float]:
        """(west, south, east, north) of a north-up raster of this transform."""
        xs, ys = zip(*[self * (c, r) for c in (0, width) for r in (0, height)])
        return (min(xs), min(ys), max(xs), max(ys))

    @property
    def is_north_up(self) -> bool:
        return self.b == 0.0 and self.d == 0.0 and self.e < 0.0
