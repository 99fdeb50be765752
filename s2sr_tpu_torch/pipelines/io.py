"""Raster/image input normalisation and SR output writing.

GeoTIFF → first 3 bands (or a gray band replicated), min-max scaled to
uint8 when >8-bit; PNG input through the package's own decoder. Output
is a GeoTIFF with the rescaled transform when georeferenced, else a
PNG, plus the unconditional PNG twin — written without PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..geo import Affine, CRS, GeoTiff, read_geotiff, write_geotiff
from ..tiles.png import decode_png, encode_png


def load_rgb(path: Path | str) -> Tuple[np.ndarray, Optional[Affine], Optional[CRS]]:
    """→ (uint8 (H, W, 3) RGB, transform?, crs?). GeoTIFF or 8-bit PNG."""
    path = Path(path)
    if path.suffix.lower() not in (".tif", ".tiff"):
        img = decode_png(path.read_bytes())
        if img.shape[2] < 3:
            img = np.repeat(img[:, :, :1], 3, axis=2)
        return np.ascontiguousarray(img[:, :, :3]), None, None
    r = read_geotiff(path)
    if r.count >= 3:
        img = r.data[:, :, :3]
    else:
        img = np.repeat(r.data[:, :, :1], 3, axis=2)
    if img.dtype != np.uint8:
        if img.max() > 255:
            # byte-exact reference formula: no epsilon
            lo, hi = img.min(), img.max()
            if hi == lo:  # constant >255 raster: the reference divides 0/0
                img = np.zeros(img.shape, np.uint8)
            else:
                img = ((img.astype(np.float64) - lo) / (hi - lo)
                       * 255).astype(np.uint8)
        else:
            img = img.astype(np.uint8)
    return img, r.transform, r.crs


def _write_png(rgb: np.ndarray, path: Path) -> None:
    path.write_bytes(encode_png(rgb))


def save_sr_output(
    rgb: np.ndarray,
    output_path: Path,
    transform: Optional[Affine],
    crs: Optional[CRS],
    scale: int,
    also_png: bool = True,
) -> Path:
    """GeoTIFF (rescaled Affine) when georeferenced, else PNG; plus the
    unconditional PNG twin."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if transform is not None:
        out_tif = output_path.with_suffix(".tif")
        write_geotiff(
            GeoTiff(rgb, transform=transform.rescaled(scale), crs=crs),
            out_tif,
        )
        final = out_tif
    else:
        final = output_path.with_suffix(".png")
        _write_png(rgb, final)
    if also_png:
        png = output_path.with_suffix(".png")
        if not png.exists() or final.suffix != ".png":
            _write_png(rgb, png)
    return final
