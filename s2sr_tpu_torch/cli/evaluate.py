"""CLI: compare two rasters or tile trees (PSNR, SSIM, max diff) as JSON
(the port of ``s2sr_tpu.cli.evaluate``).

Usage:
  python -m s2sr_tpu_torch.cli.evaluate a.tif b.tif
  python -m s2sr_tpu_torch.cli.evaluate tiles_a/ tiles_b/   (tile trees)
"""

import argparse
import json
from pathlib import Path

import numpy as np

from ..tiles.png import decode_png
from ..utils.metrics import psnr, ssim


def _json_safe(v):
    """PSNR of identical inputs is inf, which strict JSON cannot carry:
    null instead (``identical`` / ``max_abs_diff`` say so)."""
    if v is None or not np.isfinite(v):
        return None
    return round(float(v), 2)


def load(path: Path) -> np.ndarray:
    if path.suffix == ".png":
        return decode_png(path.read_bytes())
    from ..geo import read_geotiff

    return read_geotiff(path).data


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Raster/tile-tree parity eval")
    parser.add_argument("a")
    parser.add_argument("b")
    args = parser.parse_args(argv)
    a, b = Path(args.a), Path(args.b)
    if a.is_dir():
        scores = []
        for tile_a in sorted(a.glob("*/*/*.png")):
            tile_b = b / tile_a.relative_to(a)
            if not tile_b.exists():
                print(json.dumps({"tile": str(tile_a.relative_to(a)),
                                  "missing_in_b": True}))
                continue
            scores.append(psnr(load(tile_a), load(tile_b)))
        finite = [s for s in scores if np.isfinite(s)]
        print(json.dumps({
            "tiles": len(scores),
            "identical_tiles": len(scores) - len(finite),
            "psnr_mean": _json_safe(np.mean(finite) if finite else np.inf)
            if scores else None,
            "psnr_min": _json_safe(np.min(scores)) if scores else None,
        }))
    else:
        ia, ib = load(a), load(b)
        if ia.shape != ib.shape:
            raise SystemExit(f"shape mismatch: {ia.shape} vs {ib.shape}")
        max_diff = int(np.abs(ia.astype(int) - ib.astype(int)).max())
        s = ssim(ia, ib)
        print(json.dumps({
            "psnr": _json_safe(psnr(ia, ib)),
            "ssim": round(float(s), 4) if np.isfinite(s) else None,
            "max_abs_diff": max_diff,
            "identical": max_diff == 0,
        }))


if __name__ == "__main__":
    main()
