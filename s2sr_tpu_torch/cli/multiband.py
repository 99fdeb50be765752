"""CLI: multiband B04/B08/SCL fetch and stack (the port of
``s2sr_tpu.cli.multiband``).

Usage: python -m s2sr_tpu_torch.cli.multiband [--aoi AOI] [-o DIR]
       [--max-days N] [--max-cloud P] [--size PX] [--device cuda|cpu]
"""
import argparse
from pathlib import Path

from ..config import get_settings
from ..fetch.multiband import FetchConfig, fetch_and_stack_multiband
from ..fetch.smart_fetch import load_aoi_geometry


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Fetch multiband stack")
    parser.add_argument("--aoi", default=None)
    parser.add_argument("-o", "--output", default="data/source")
    parser.add_argument("--max-days", type=int, default=30)
    parser.add_argument("--max-cloud", type=float, default=30.0)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the band warps (default cuda)")
    args = parser.parse_args(argv)
    aoi = load_aoi_geometry(args.aoi or get_settings().aoi_path)
    path, meta = fetch_and_stack_multiband(
        aoi, Path(args.output),
        FetchConfig(max_age_days=args.max_days, max_cloud_pct=args.max_cloud,
                    out_size=args.size), device=args.device)
    print(f"Stacked multiband: {path}\n  {meta}")


if __name__ == "__main__":
    main()
