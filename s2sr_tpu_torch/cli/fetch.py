"""CLI: smart fetch of the best Sentinel-2 scene (the port of
``s2sr_tpu.cli.fetch``).

Usage: python -m s2sr_tpu_torch.cli.fetch [--max-days N] [--max-cloud P]
       [--force] [--device cuda|cpu]
"""
import argparse

from ..fetch.smart_fetch import ensure_best_image


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Smart-fetch best Sentinel-2 scene")
    parser.add_argument("--max-days", type=int, default=30)
    parser.add_argument("--max-cloud", type=float, default=30.0)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the AOI clip (default cuda)")
    args = parser.parse_args(argv)
    path, metadata = ensure_best_image(
        max_age_days=args.max_days, max_cloud_cover=args.max_cloud,
        force_fetch=args.force, device=args.device,
    )
    print(f"Best image: {path}")
    print(f"  Scene ID: {metadata.get('scene_id', 'N/A')}")
    print(f"  Date: {metadata.get('acquisition_date', 'N/A')}")
    print(f"  Cloud: {metadata.get('cloud_cover_pct', 'N/A')}%")


if __name__ == "__main__":
    main()
