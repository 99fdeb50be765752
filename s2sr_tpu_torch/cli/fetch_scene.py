"""CLI: standalone scene fetcher (the port of ``s2sr_tpu.cli.fetch_scene``).

STAC search (public Earth-Search or UP42 with order reuse), per-asset
windowed COG reads, the AOI clip on ``--device``, and an optional
polygon **cutline** clip (``gdalwarp -cutline -crop_to_cutline
-dstalpha``): pixels outside the AOI polygon become transparent through
an alpha band.

Usage:
  python -m s2sr_tpu_torch.cli.fetch_scene --aoi aoi.geojson -o out/ \\
      [--up42] [--cutline] [--max-days 30] [--max-cloud 20] [--device cpu]
"""

import argparse
from pathlib import Path

import numpy as np


def apply_cutline(raster, aoi_geometry):
    """Mask pixels outside the AOI polygon; adds an alpha band."""
    from ..geo import GeoTiff
    from ..geo.crs import CRS, transform_points
    from ..vectors.geometry import rasterize_polygon

    # normalise to a list of polygons (each a list of rings) so a
    # MultiPolygon AOI keeps EVERY part — gdalwarp -cutline clips to the
    # full multipolygon, not its first member
    if aoi_geometry.get("type") == "MultiPolygon":
        polygons = list(aoi_geometry["coordinates"])
    else:
        polygons = [aoi_geometry["coordinates"]]
    # AOI is lon/lat; project into the raster CRS if needed
    if raster.crs is not None and not raster.crs.is_geographic:
        projected_polys = []
        for poly in polygons:
            projected = []
            for ring in poly:
                arr = np.asarray(ring, np.float64)
                x, y = transform_points(CRS(4326), raster.crs,
                                        arr[:, 0], arr[:, 1])
                projected.append(np.stack([x, y], axis=-1).tolist())
            projected_polys.append(projected)
        polygons = projected_polys
    mask = np.zeros(raster.data.shape[:2], bool)
    for poly in polygons:
        mask |= rasterize_polygon(poly, raster.data.shape[:2],
                                  ~raster.transform)
    alpha = (mask * 255).astype(raster.data.dtype)
    data = np.concatenate([
        np.where(mask[:, :, None], raster.data, 0),
        alpha[:, :, None],
    ], axis=-1)
    return GeoTiff(data, transform=raster.transform, crs=raster.crs)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Standalone scene fetcher")
    parser.add_argument("--aoi", required=False, default=None)
    parser.add_argument("-o", "--output", default="data/source")
    parser.add_argument("--max-days", type=int, default=30)
    parser.add_argument("--max-cloud", type=float, default=20.0)
    parser.add_argument("--up42", action="store_true",
                        help="order through UP42 (credentials required)")
    parser.add_argument("--cutline", action="store_true",
                        help="clip to the AOI polygon with alpha")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the AOI clip (default cuda)")
    args = parser.parse_args(argv)

    from ..config import get_settings
    from ..fetch.client import PublicSentinel2Client, UP42Client
    from ..fetch.smart_fetch import load_aoi_geometry
    from ..geo import read_geotiff, write_geotiff

    settings = get_settings()
    aoi = load_aoi_geometry(args.aoi or settings.aoi_path)
    out_dir = Path(args.output)

    if args.up42:
        client = UP42Client(settings)
        path, metadata = client.fetch_best_scene(aoi, out_dir)
    else:
        client = PublicSentinel2Client(settings, device=args.device)
        try:
            path, metadata = client.fetch_best_scene(aoi, out_dir)
        except Exception as exc:
            # the client raises rather than substituting fake data; the
            # CLI owns its own last rung (offline runs land here)
            from ..fetch.smart_fetch import _synthesize_scene

            print(f"fetch failed ({exc}); synthesizing fixture scene")
            path, metadata = _synthesize_scene(out_dir, aoi)

    if args.cutline:
        raster = read_geotiff(path)
        clipped = apply_cutline(raster, aoi)
        cut_path = path.with_name(path.stem + "_cutline.tif")
        write_geotiff(clipped, cut_path)
        print(f"cutline clip -> {cut_path}")

    print(f"fetched: {path}")
    print(f"  scene: {metadata.get('scene_id')}  "
          f"cloud: {metadata.get('cloud_cover_pct')}%")


if __name__ == "__main__":
    main()
