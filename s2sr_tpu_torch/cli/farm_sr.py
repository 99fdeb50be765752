"""CLI: farm super-resolution with the PyTorch port.

Usage: python -m s2sr_tpu_torch.cli.farm_sr INPUT [-o DIR] [-s SCALE]
       [--weights-dir DIR] [--device cuda|cpu]
"""
import argparse
from pathlib import Path

from ..pipelines.farm_sr import process_farm_sr


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Farm Super-Resolution")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", default="./farm_sr_output")
    parser.add_argument("-s", "--scale", type=int, default=4)
    parser.add_argument("--weights-dir", default="models")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on the CPU)")
    args = parser.parse_args(argv)
    result = process_farm_sr(Path(args.input), Path(args.output),
                             scale=args.scale, weights_dir=args.weights_dir,
                             device=args.device)
    print(f"Results: {result['outputs']}")


if __name__ == "__main__":
    main()
