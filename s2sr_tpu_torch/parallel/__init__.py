from .mesh import build_mesh, parse_mesh_shape
from .tiling import TilePlan, extract_windows, sr_whole_image, tiled_apply

__all__ = [
    "build_mesh",
    "parse_mesh_shape",
    "TilePlan",
    "extract_windows",
    "sr_whole_image",
    "tiled_apply",
]
