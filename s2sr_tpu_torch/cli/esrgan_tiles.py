"""CLI: high-zoom ESRGAN tiles (the port of ``s2sr_tpu.cli.esrgan_tiles``).

Usage: python -m s2sr_tpu_torch.cli.esrgan_tiles INPUT [-o DIR]
       [--min-zoom Z] [--max-zoom Z] [--no-enhance] [--skip-sr]
       [--sr-output TIF] [--weights-dir DIR] [--device cuda|cpu]
"""
import argparse
from pathlib import Path

from ..pipelines.esrgan_tiles import run_esrgan_and_tiles


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="ESRGAN z18-20 tiles")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", default="./esrgan_tiles_output")
    parser.add_argument("--min-zoom", type=int, default=18)
    parser.add_argument("--max-zoom", type=int, default=20)
    parser.add_argument("--no-enhance", action="store_true")
    parser.add_argument("--skip-sr", action="store_true")
    parser.add_argument("--sr-output", default=None)
    parser.add_argument("--weights-dir", default="models")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on the CPU)")
    args = parser.parse_args(argv)
    result = run_esrgan_and_tiles(
        Path(args.input), Path(args.output),
        min_zoom=args.min_zoom, max_zoom=args.max_zoom,
        enhance_crops=not args.no_enhance,
        skip_sr=args.skip_sr, sr_output=args.sr_output,
        weights_dir=args.weights_dir, device=args.device,
    )
    print(f"{result['tile_count']} tiles -> {result['tiles_dir']}")


if __name__ == "__main__":
    main()
