"""CLI: field-vector generation.

    python -m s2sr_tpu_torch.cli.generate_vectors [--raster R] [--aoi A]
        [-o OUT] [--device cpu]
"""
import argparse
import time

from ..pipelines.generate_vectors import generate_vectors
from ..vectors.extraction import ExtractionConfig


def main() -> None:
    parser = argparse.ArgumentParser(description="Generate field vectors")
    parser.add_argument("--aoi", default=None)
    parser.add_argument("--raster", default=None)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--ndvi-threshold", type=float, default=0.3)
    parser.add_argument("--min-area-ha", type=float, default=0.1)
    parser.add_argument("--max-area-ha", type=float, default=500.0)
    parser.add_argument("--simplify", type=float, default=5.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the segmentation (cuda or cpu)")
    args = parser.parse_args()
    t0 = time.perf_counter()
    result = generate_vectors(
        aoi_path=args.aoi, raster_path=args.raster, out_dir=args.output,
        config=ExtractionConfig(
            ndvi_threshold=args.ndvi_threshold,
            min_area_ha=args.min_area_ha, max_area_ha=args.max_area_ha,
            simplify_tolerance_m=args.simplify,
        ), device=args.device)
    print(f"Extracted {result['feature_count']} fields "
          f"({result['source_method']}) in {time.perf_counter()-t0:.1f}s "
          f"-> {result['output_path']}")


if __name__ == "__main__":
    main()
