"""CLI: the unified SR front with the PyTorch port (the port of
``s2sr_tpu.cli.sr_cli``).

Usage: python -m s2sr_tpu_torch.cli.sr_cli INPUT [-o DIR]
       [--mode farm|realesrgan|edsr] [--scale S] [--tile]
       [--min-zoom Z] [--max-zoom Z] [--device cuda|cpu]

``edsr`` runs the classic EDSR (weights from ``Settings.weights_dir``:
``edsr_x{S}.npz`` or ``.pb``, else a seeded random init); ``realesrgan``
the WOW pipeline; ``farm`` the farm pipeline. ``--tile`` cuts the SR
GeoTIFF into XYZ tiles afterwards.
"""
import argparse
from pathlib import Path

from ..config import get_settings


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Unified SR CLI")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", default="./sr_output")
    parser.add_argument("--mode", default="realesrgan",
                        choices=["farm", "realesrgan", "edsr"])
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--tile", action="store_true",
                        help="Generate XYZ tiles from the SR output")
    parser.add_argument("--min-zoom", type=int, default=None)
    parser.add_argument("--max-zoom", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on the CPU)")
    args = parser.parse_args(argv)

    out_dir = Path(args.output)
    if args.mode == "farm":
        from ..pipelines.farm_sr import process_farm_sr

        result = process_farm_sr(Path(args.input), out_dir, scale=args.scale,
                                 device=args.device)
    elif args.mode == "realesrgan":
        from ..pipelines.wow_sr import process_wow_sr

        result = process_wow_sr(Path(args.input), out_dir, device=args.device)
    else:
        from ..pipelines.super_resolution import process_sentinel2_sr

        result = process_sentinel2_sr(Path(args.input), out_dir,
                                      scale=args.scale, model="edsr",
                                      device=args.device)
    print(f"SR complete: {result['outputs']}")

    if args.tile and result["outputs"].get("sr_tif"):
        from ..tiles import process_raster_to_tiles

        settings = get_settings()
        meta = process_raster_to_tiles(
            Path(result["outputs"]["sr_tif"]), out_dir / "tiles",
            min_zoom=args.min_zoom or settings.tile_min_zoom,
            max_zoom=args.max_zoom or min(settings.tile_max_zoom + 2, 20),
            device=args.device,
        )
        print(f"Tiles: z{meta['minzoom']}-{meta['maxzoom']} -> "
              f"{out_dir / 'tiles'}")


if __name__ == "__main__":
    main()
