"""Field-boundary vectors: segmentation on the device, polygons in numpy."""

from .extraction import ExtractionConfig, extract_field_polygons
from .extraction_v2 import ExtractionConfigV2, extract_field_polygons_v2
from .geometry import Polygon, mask_to_polygons, rasterize_polygon

__all__ = [
    "ExtractionConfig",
    "extract_field_polygons",
    "ExtractionConfigV2",
    "extract_field_polygons_v2",
    "Polygon",
    "mask_to_polygons",
    "rasterize_polygon",
]
