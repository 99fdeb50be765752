from .affine import Affine
from .crs import CRS, transform_bounds, transform_points
from .geotiff import GeoTiff, read_geotiff, write_geotiff

__all__ = [
    "Affine",
    "CRS",
    "transform_bounds",
    "transform_points",
    "GeoTiff",
    "read_geotiff",
    "write_geotiff",
]
