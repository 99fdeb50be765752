"""Raster reprojection on the device (the port of ``s2sr_tpu/geo/warp.py``).

Warping is an inverse-mapping gather on the source tensor's device. The
exact projection math runs on the host (float64) on a coarse **control
grid** and is bilinearly densified on the device, GDAL's approximation
strategy (a 17×17 grid per 256-px tile keeps the error ~100× below its
0.125 px default threshold for Mercator/UTM geometry).

Every expression keeps the JAX function's order, one torch op per
``jnp`` op, with float32 arithmetic and int64 gather indices; a division
by a constant divides by a 0-dim tensor (``ops/color.py::div``), since
CUDA turns a division by a Python scalar into a reciprocal multiply.

Pixels sampled outside the source get alpha 0 (→ transparent in tiles,
nodata in rasters).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.color import div
from .affine import Affine
from .crs import CRS, transform_bounds, transform_points
from .geotiff import GeoTiff


def control_grid(
    dst_transform: Affine,
    dst_crs: CRS,
    src_transform: Affine,
    src_crs: CRS,
    dst_h: int,
    dst_w: int,
    grid: int = 17,
) -> np.ndarray:
    """(grid, grid, 2) source pixel coords (col, row) for control points
    spanning the destination window edges (positions 0..dst_w in
    continuous pixel space)."""
    us = np.linspace(0.0, dst_w, grid)
    vs = np.linspace(0.0, dst_h, grid)
    uu, vv = np.meshgrid(us, vs)
    dx, dy = dst_transform * (uu.ravel(), vv.ravel())
    sx, sy = transform_points(dst_crs, src_crs, dx, dy)
    inv = ~src_transform
    col, row = inv * (sx, sy)
    out = np.stack([np.asarray(col), np.asarray(row)], axis=-1)
    return out.reshape(grid, grid, 2).astype(np.float32)


def _densify_ctrl(ctrl: torch.Tensor, out_h: int, out_w: int,
                  h: int, w: int):
    """Bilinearly densify a (B, G, G, 2) control grid to per-pixel
    source coords → (col, row, valid), each (B, out_h, out_w). Shared
    by the bilinear, nearest and lanczos warps."""
    g = ctrl.shape[1]
    dev = ctrl.device
    py = div(torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5,
             out_h) * (g - 1)
    px = div(torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5,
             out_w) * (g - 1)
    y0 = torch.floor(py).to(torch.int64).clamp(0, g - 2)
    x0 = torch.floor(px).to(torch.int64).clamp(0, g - 2)
    fy = (py - y0)[None, :, None, None]          # (1, out_h, 1, 1)
    fx = (px - x0)[None, None, :, None]          # (1, 1, out_w, 1)

    c00 = ctrl[:, y0][:, :, x0]                  # (B, out_h, out_w, 2)
    c01 = ctrl[:, y0][:, :, x0 + 1]
    c10 = ctrl[:, y0 + 1][:, :, x0]
    c11 = ctrl[:, y0 + 1][:, :, x0 + 1]
    coords = (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
              + c10 * fy * (1 - fx) + c11 * fy * fx)
    col, row = coords[..., 0] - 0.5, coords[..., 1] - 0.5  # centre-aligned
    valid = (col > -1.0) & (col < w) & (row > -1.0) & (row < h)
    return col, row, valid


def warp_bilinear_batch(
    src: torch.Tensor,       # (H, W, C) float32
    ctrl: torch.Tensor,      # (B, G, G, 2) source (col, row) at controls
    out_h: int,
    out_w: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp a batch of destination windows. Returns (rgb, alpha):
    (B, out_h, out_w, C) float32 and (B, out_h, out_w) float32 in {0,1}."""
    h, w, _ = src.shape
    col, row, valid = _densify_ctrl(ctrl, out_h, out_w, h, w)

    ci = torch.floor(col).clamp(0, w - 1)
    ri = torch.floor(row).clamp(0, h - 1)
    fc = (col - ci).clamp(0.0, 1.0)[..., None]
    fr = (row - ri).clamp(0.0, 1.0)[..., None]
    ci = ci.to(torch.int64)
    ri = ri.to(torch.int64)
    ci1 = torch.clamp(ci + 1, max=w - 1)
    ri1 = torch.clamp(ri + 1, max=h - 1)

    p00 = src[ri, ci]                             # advanced-indexing gather
    p01 = src[ri, ci1]
    p10 = src[ri1, ci]
    p11 = src[ri1, ci1]
    rgb = (p00 * (1 - fr) * (1 - fc) + p01 * (1 - fr) * fc
           + p10 * fr * (1 - fc) + p11 * fr * fc)
    return rgb, valid.to(torch.float32)


def warp_nearest_batch(
    src: torch.Tensor,       # (H, W, C) float32
    ctrl: torch.Tensor,      # (B, G, G, 2) source (col, row) at controls
    out_h: int,
    out_w: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour variant of :func:`warp_bilinear_batch` for
    categorical rasters (class codes must not be interpolated)."""
    h, w, _ = src.shape
    col, row, valid = _densify_ctrl(ctrl, out_h, out_w, h, w)
    ci = torch.round(col).clamp(0, w - 1).to(torch.int64)
    ri = torch.round(row).clamp(0, h - 1).to(torch.int64)
    return src[ri, ci], valid.to(torch.float32)


def warp_lanczos_batch(
    src: torch.Tensor,       # (H, W, C) float32
    ctrl: torch.Tensor,      # (B, G, G, 2) source (col, row) at controls
    out_h: int,
    out_w: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos-3 (6×6 tap) variant of :func:`warp_bilinear_batch`:
    separable windowed-sinc weights, edge-replicated taps, alpha from
    source coverage like the bilinear path."""
    h, w, c = src.shape
    col, row, valid = _densify_ctrl(ctrl, out_h, out_w, h, w)

    def lanczos3(x):
        ax = torch.abs(x)
        pix = np.pi * x
        val = torch.where(
            ax < 1e-6, 1.0,
            3.0 * torch.sin(pix) * torch.sin(div(pix, 3.0))
            / torch.clamp(pix * pix, min=1e-12))
        return torch.where(ax < 3.0, val, 0.0)

    ci = torch.floor(col).to(torch.int64)
    ri = torch.floor(row).to(torch.int64)
    acc = torch.zeros(col.shape + (c,), dtype=torch.float32, device=src.device)
    wsum = torch.zeros(col.shape + (1,), dtype=torch.float32, device=src.device)
    for dy in range(-2, 4):
        ty = ri + dy
        wy = lanczos3(row - ty.to(torch.float32))[..., None]
        tyc = ty.clamp(0, h - 1)
        for dx in range(-2, 4):
            tx = ci + dx
            wx = lanczos3(col - tx.to(torch.float32))[..., None]
            txc = tx.clamp(0, w - 1)
            weight = wy * wx
            acc = acc + weight * src[tyc, txc]
            wsum = wsum + weight
    out = acc / torch.clamp(wsum, min=1e-12)
    return out, valid.to(torch.float32)


def _mercator_bounds(raster: GeoTiff) -> Tuple[float, float, float, float]:
    w, s, e, n = raster.bounds
    assert raster.crs is not None
    return transform_bounds(raster.crs, CRS(3857), w, s, e, n)


def default_mercator_resolution(raster: GeoTiff) -> float:
    """Destination pixel size (m) preserving the source pixel count along x,
    the same heuristic gdalwarp uses by default."""
    mw, ms, me, mn = _mercator_bounds(raster)
    return (me - mw) / raster.width


def warp_to_mercator(
    raster: GeoTiff,
    resolution: Optional[float] = None,
    block_rows: int = 1024,
    grid_step: int = 64,
    method: str = "bilinear",
    device: str | torch.device = "cuda",
) -> GeoTiff:
    """Reproject a raster to EPSG:3857 on ``device``. Adds an alpha band
    when warping introduces empty corners or the source carries nodata
    (gdalwarp honours source nodata the same way)."""
    assert raster.crs is not None, "raster must be georeferenced"
    if raster.crs.epsg == 3857:
        return raster
    mw, ms, me, mn = _mercator_bounds(raster)
    if resolution is None:
        resolution = (me - mw) / raster.width
    out_w = max(int(round((me - mw) / resolution)), 1)
    out_h = max(int(round((mn - ms) / resolution)), 1)
    dst_transform = Affine.from_origin(mw, mn, resolution, resolution)

    src_np = raster.data.astype(np.float32)
    if raster.nodata is not None:
        # weighted warp: nodata taps get weight 0, so they neither smear
        # into valid pixels nor count as coverage; a pixel is nodata only
        # when ALL bands equal the value (gdalwarp's UNIFIED_SRC_NODATA)
        mask = ~(raster.data == raster.nodata).all(axis=-1, keepdims=True)
        src_np = np.concatenate(
            [src_np * mask, mask.astype(np.float32)], axis=-1)
    src = torch.from_numpy(np.ascontiguousarray(src_np)).to(device)
    warp_fn = (warp_nearest_batch if method in ("near", "nearest")
               else warp_bilinear_batch)
    rows_out = []
    alpha_out = []
    for y0 in range(0, out_h, block_rows):
        bh = min(block_rows, out_h - y0)
        block_transform = dst_transform * Affine.translation(0, y0)
        g = max(2, min(33, bh // grid_step + 2))
        gw = max(2, min(33, out_w // grid_step + 2))
        gg = max(g, gw)
        ctrl = control_grid(block_transform, CRS(3857), raster.transform,
                            raster.crs, bh, out_w, grid=gg)
        rgb, alpha = warp_fn(src, torch.from_numpy(ctrl)[None].to(device),
                             bh, out_w)
        rows_out.append(rgb[0].cpu().numpy())
        alpha_out.append(alpha[0].cpu().numpy())
    data = np.concatenate(rows_out, axis=0)
    alpha = np.concatenate(alpha_out, axis=0)
    if raster.nodata is not None:
        cov = data[..., -1]
        data = data[..., :-1] / np.maximum(cov[..., None], 1e-6)
        alpha = alpha * (cov > 0.5)

    # quantise to the SOURCE dtype's range — uint16 reflectance and
    # float rasters must survive the round trip, not be clamped to 255
    dt = raster.data.dtype
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        out = np.clip(np.round(data), info.min, info.max).astype(dt)
        alpha_full = info.max
    else:
        out = data.astype(dt)
        alpha_full = 1.0
    if (alpha < 0.5).any():
        out = np.concatenate(
            [out, (alpha[..., None] * alpha_full).astype(dt)], axis=-1)
    return GeoTiff(out, transform=dst_transform, crs=CRS(3857),
                   nodata=raster.nodata)
