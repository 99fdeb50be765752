"""Raster/image input normalisation and SR output writing.

GeoTIFF (by its ``.tif`` / ``.tiff`` suffix) → first 3 bands (or a gray
band replicated), min-max scaled to uint8 when >8-bit. Any other upload
is decoded by its content, as PIL does for the JAX package: PNG, JPEG,
GIF, BMP, WebP and TIFF by the package's own decoders (``tiles/``), to
the bytes PIL's ``convert("RGB")`` gives. Output is a GeoTIFF with the
rescaled transform when georeferenced, else a PNG, plus the
unconditional PNG twin — written without PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..geo import Affine, CRS, GeoTiff, read_geotiff, write_geotiff
from ..tiles.bmp import decode_bmp
from ..tiles.gif import decode_gif
from ..tiles.jpeg import decode_jpeg
from ..tiles.png import decode_png, encode_png
from ..tiles.tiff import decode_tiff
from ..tiles.webp import decode_webp


def _decoder(data: bytes):
    """The decoder of ``data``'s format, by its magic bytes, or None."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif
    if data[:2] == b"BM":
        return decode_bmp
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return decode_tiff
    return None


def decode_upload(data: bytes, name: str = "upload") -> np.ndarray:
    """An uploaded image's bytes → uint8 (H, W, 3) RGB, picked by content
    (gray replicated, alpha dropped): what PIL's ``convert("RGB")``
    gives, or ``ValueError`` where PIL raises."""
    decode = _decoder(data)
    if decode is None:
        raise ValueError(f"cannot identify image file {name!r}")
    img = decode(data)
    if img.shape[2] < 3:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def load_rgb(path: Path | str) -> Tuple[np.ndarray, Optional[Affine], Optional[CRS]]:
    """→ (uint8 (H, W, 3) RGB, transform?, crs?). GeoTIFF by suffix, any
    other file by :func:`decode_upload`."""
    path = Path(path)
    if path.suffix.lower() not in (".tif", ".tiff"):
        return decode_upload(path.read_bytes(), str(path)), None, None
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
