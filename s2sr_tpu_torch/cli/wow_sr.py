"""CLI: WOW super-resolution with the PyTorch port.

Usage: python -m s2sr_tpu_torch.cli.wow_sr INPUT [-o DIR] [--no-enhance]
       [--model NAME] [--weights-dir DIR] [--device cuda|cpu]
"""
import argparse
from pathlib import Path

from ..pipelines.wow_sr import process_wow_sr


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="WOW Super-Resolution")
    parser.add_argument("input", help="Input GeoTIFF file")
    parser.add_argument("-o", "--output", default="./wow_sr_output")
    parser.add_argument("--no-enhance", action="store_true",
                        help="Skip crop enhancement")
    parser.add_argument("--model", default="realesrgan_x4",
                        choices=["realesrgan_x4", "realesrgan_anime"])
    parser.add_argument("--weights-dir", default="models")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on the CPU)")
    args = parser.parse_args(argv)
    result = process_wow_sr(
        input_tif=Path(args.input), output_dir=Path(args.output),
        enhance_crops=not args.no_enhance, model=args.model,
        weights_dir=args.weights_dir, device=args.device,
    )
    print(f"Results: {result['outputs']}")


if __name__ == "__main__":
    main()
