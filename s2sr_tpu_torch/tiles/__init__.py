from .mercator import (
    TILE_SIZE,
    mercator_to_tile,
    resolution,
    tile_bounds,
    tiles_for_bounds,
)
from .png import decode_png, encode_png
from .tiling import (
    RasterInfo,
    create_tileset_metadata,
    generate_xyz_tiles,
    get_raster_info,
    process_raster_to_tiles,
    reproject_to_web_mercator,
)

__all__ = [
    "TILE_SIZE",
    "mercator_to_tile",
    "resolution",
    "tile_bounds",
    "tiles_for_bounds",
    "decode_png",
    "encode_png",
    "RasterInfo",
    "create_tileset_metadata",
    "generate_xyz_tiles",
    "get_raster_info",
    "process_raster_to_tiles",
    "reproject_to_web_mercator",
]
