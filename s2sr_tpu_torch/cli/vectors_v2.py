"""CLI: v2 vector extraction (gradient watershed, zones, roads).

    python -m s2sr_tpu_torch.cli.vectors_v2 RASTER [--aoi A] [-o OUT]
        [--no-zones] [--no-roads] [--device cpu]
"""
import argparse
from pathlib import Path

from ..config import get_settings
from ..vectors.extraction_v2 import ExtractionConfigV2, extract_field_polygons_v2


def main() -> None:
    parser = argparse.ArgumentParser(description="V2 field extraction")
    parser.add_argument("raster")
    parser.add_argument("--aoi", default=None)
    parser.add_argument("-o", "--output", default="data/vectors")
    parser.add_argument("--no-zones", action="store_true")
    parser.add_argument("--no-roads", action="store_true")
    parser.add_argument("--min-area-ha", type=float, default=0.5)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the segmentation (cuda or cpu)")
    args = parser.parse_args()
    config = ExtractionConfigV2(
        generate_zones=not args.no_zones,
        use_osm_roads=not args.no_roads,
        min_area_ha=args.min_area_ha,
    )
    result = extract_field_polygons_v2(
        args.aoi or get_settings().aoi_path, Path(args.raster),
        Path(args.output), config, device=args.device)
    print(f"V2 extraction: {result['feature_count']} fields, "
          f"{result['zone_count']} zones -> {result['output_path']}")


if __name__ == "__main__":
    main()
