"""CLI: raster → XYZ tile pyramid (the port of ``s2sr_tpu.cli.tile``).

Usage: python -m s2sr_tpu_torch.cli.tile INPUT [-o DIR] [--min-zoom Z]
       [--max-zoom Z] [--device cuda|cpu]
"""
import argparse
from pathlib import Path

from ..tiles import process_raster_to_tiles


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Generate XYZ tiles")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", default="./tiles")
    parser.add_argument("--min-zoom", type=int, default=10)
    parser.add_argument("--max-zoom", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the warps (default cuda)")
    args = parser.parse_args(argv)
    meta = process_raster_to_tiles(Path(args.input), Path(args.output),
                                   min_zoom=args.min_zoom,
                                   max_zoom=args.max_zoom, device=args.device)
    print(f"Tileset: {meta}")


if __name__ == "__main__":
    main()
