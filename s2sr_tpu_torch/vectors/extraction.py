"""Field-boundary vector extraction v1 (NDVI/HSV → watershed → GeoJSON).

The port of ``s2sr_tpu/vectors/extraction.py``: the same
:class:`ExtractionConfig`, NDVI band heuristics, HSV green+brown
fallback masks (through the port's ``ops/color.py::rgb_to_hsv_u8``),
segmentation chain (gaussian σ2 → ellipse close/open ×2 → fill holes →
distance transform → 0.3·max markers → watershed), area filter,
confidence scoring and GeoJSON schema with md5 feature ids.

Mask and segmentation run on ``device`` (:mod:`.ops`; ``cuda`` unless
the caller passes ``"cpu"``); polygonisation runs on the host in numpy
(:mod:`.geometry`). The working raster is padded to 256-multiples as the
JAX package pads it, so every device stage (the jump-flooding distance
transform above all, whose rolls wrap around the frame) sees the same
frame and the polygons on the true rectangle are the JAX package's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geo import Affine, GeoTiff, read_geotiff
from ..models.engine import resolve_device
from ..ops.color import rgb_to_hsv_u8
from ..utils import ensure_directory, read_json, setup_logging, write_json
from . import ops
from .geometry import Polygon, iter_label_masks, mask_to_polygons, rasterize_polygon

logger = setup_logging("s2sr_tpu_torch.vector_extraction")


@dataclass
class ExtractionConfig:
    gaussian_sigma: float = 2.0
    ndvi_threshold: float = 0.3
    hsv_green_hue_range: Tuple[int, int] = (35, 85)
    hsv_saturation_min: int = 30
    hsv_value_min: int = 30
    morph_kernel_size: int = 5
    morph_iterations: int = 2
    min_area_ha: float = 0.1
    max_area_ha: float = 500.0
    simplify_tolerance_m: float = 5.0
    # v1 only WARNS above the threshold (reference ``:722-728``);
    # downsample_factor is declared-but-unused there too (the config
    # schema is the contract) — only v2 actually downsamples
    max_pixels_for_full_res: int = 50_000_000
    downsample_factor: int = 2


def load_aoi_geojson(aoi_path: Path | str) -> dict:
    data = read_json(aoi_path)
    if data.get("type") == "FeatureCollection":
        features = data.get("features", [])
        if not features:
            raise ValueError("No features found in AOI GeoJSON")
        return features[0]["geometry"]
    if data.get("type") == "Feature":
        return data["geometry"]
    return data


def crop_raster_to_aoi(raster: GeoTiff, aoi_geom: dict) -> GeoTiff:
    """rasterio.mask(crop=True) equivalent: bbox window + polygon mask.

    MultiPolygon AOIs keep EVERY member polygon (rasterio masks the
    full geometry) — the bbox spans all parts and the mask is their
    union."""
    if aoi_geom.get("type") == "MultiPolygon":
        polygons = list(aoi_geom.get("coordinates", []))
    else:
        polygons = [aoi_geom.get("coordinates", [])]
    exteriors = np.concatenate(
        [np.asarray(poly[0], np.float64) for poly in polygons], axis=0)
    inv = ~raster.transform
    col, row = inv * (exteriors[:, 0], exteriors[:, 1])
    c0 = max(int(np.floor(np.asarray(col).min())), 0)
    c1 = min(int(np.ceil(np.asarray(col).max())), raster.width)
    r0 = max(int(np.floor(np.asarray(row).min())), 0)
    r1 = min(int(np.ceil(np.asarray(row).max())), raster.height)
    if c1 <= c0 or r1 <= r0:
        raise ValueError("AOI does not intersect raster")
    window = raster.data[r0:r1, c0:c1]
    new_transform = raster.transform * Affine.translation(c0, r0)
    mask = np.zeros(window.shape[:2], bool)
    for poly in polygons:
        mask |= rasterize_polygon(poly, window.shape[:2], ~new_transform)
    out = np.where(mask[:, :, None], window, 0).astype(window.dtype)
    return GeoTiff(out, transform=new_transform, crs=raster.crs)


def compute_ndvi(raster: GeoTiff) -> Optional[np.ndarray]:
    """NDVI if enough bands (reference band heuristics ``:169-219``)."""
    count = raster.count
    if count < 4:
        return None
    if count >= 8:
        red = raster.band(4).astype(np.float32)
        nir = raster.band(8).astype(np.float32)
    elif count >= 5:
        red = raster.band(3).astype(np.float32)
        nir = raster.band(4).astype(np.float32)
    else:
        return None
    denominator = nir + red
    safe = np.where(denominator > 0, denominator, 1.0)
    return np.where(denominator > 0, (nir - red) / safe, 0).astype(np.float32)


def _green_mask_device(rgb: torch.Tensor, hue_range, sat_min, val_min):
    hsv = rgb_to_hsv_u8(rgb)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    hue_min, hue_max = hue_range
    green = ((h >= hue_min) & (h <= hue_max)
             & (s >= sat_min) & (v >= val_min))
    brown = ((h >= 10) & (h <= 35) & (s >= 20) & (s <= 200)
             & (v >= 40) & (v <= 200))
    return (green | brown).to(torch.float32)


def compute_green_mask_hsv(raster: GeoTiff, config: ExtractionConfig,
                           device="cuda") -> np.ndarray:
    if raster.count < 3:
        # the HSV fallback needs 3 channels; replicate gray like the
        # pipelines' read path (pipelines/io.load_rgb)
        rgb = np.repeat(raster.data[:, :, :1], 3, axis=2)
    else:
        rgb = raster.data[:, :, :3]
    if rgb.max() > 255:
        rgb = (rgb / rgb.max() * 255).astype(np.uint8)
    else:
        rgb = rgb.astype(np.uint8)
    dev = resolve_device(device)
    return _green_mask_device(
        torch.from_numpy(np.ascontiguousarray(rgb)).to(dev),
        tuple(config.hsv_green_hue_range), config.hsv_saturation_min,
        config.hsv_value_min).cpu().numpy()


def compute_vegetation_mask(
    raster: GeoTiff, config: ExtractionConfig, device="cuda"
) -> Tuple[np.ndarray, str]:
    ndvi = compute_ndvi(raster)
    if ndvi is not None:
        logger.info("Using NDVI-based mask (threshold=%s)", config.ndvi_threshold)
        return (ndvi > config.ndvi_threshold).astype(np.float32), "ndvi"
    logger.info("Using HSV color-based mask (RGB fallback)")
    return compute_green_mask_hsv(raster, config, device), "rgb_fallback"


def _stage_binary(mask: torch.Tensor, th: int, tw: int, sigma: float):
    """Reflect the true rectangle into the bucket padding (so the
    gaussian sees scipy's 'reflect' content across the crop border,
    not padded zeros), smooth, threshold, and confine to the valid
    rectangle."""
    h, w = mask.shape
    dev = mask.device
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    valid = (rows[:, None] < th) & (cols[None, :] < tw)
    ridx = torch.where(rows < th, rows, torch.clamp(2 * th - 1 - rows, 0, th - 1))
    cidx = torch.where(cols < tw, cols, torch.clamp(2 * tw - 1 - cols, 0, tw - 1))
    reflected = mask.to(torch.float32)[ridx[:, None], cidx[None, :]]
    smoothed = ops.gaussian_filter(reflected, sigma)
    binary = ((smoothed > 0.5) & valid).to(torch.uint8)
    return binary, valid


def _stage_fill(opened: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    # scipy fills holes of the crop: padded zeros connect the frame
    # border to the crop border, so the complement flood is equivalent.
    zero = torch.zeros_like(opened)
    return torch.where(valid, ops.fill_holes(torch.where(valid, opened, zero)),
                       zero)


def _stage_markers(filled: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    # cv2.distanceTransform measures to the nearest zero INSIDE the
    # crop: the bucket padding contributes no seeds (set to 1) and no
    # maxima (dist forced 0 outside valid).
    dist = ops.distance_transform(
        torch.where(valid, filled, torch.ones_like(filled)))
    dist = torch.where(valid, dist, torch.zeros_like(dist))
    local_max = (dist > 0.3 * torch.max(dist)).to(torch.uint8)
    return ops.connected_components(local_max)


def _stage_watershed(cc: torch.Tensor, filled: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The reference's background-marker watershed: ``markers+1`` seeds
    label 1 on every filled non-core pixel, cores get 2..N+1, and the
    flood fills only the *outside* region; label 1 wins it (and is
    zeroed), so the surviving fields are the distance-transform cores,
    not the filled mask."""
    markers = torch.where(cc > 0, cc + 1,
                          (filled > 0).to(cc.dtype))
    labels = ops.watershed_uniform(markers, valid.to(torch.uint8))
    return torch.where(labels == 1, 0, labels)


def segment_fields(vegetation_mask: np.ndarray,
                   config: ExtractionConfig,
                   timings: Optional[dict] = None,
                   valid_hw: Optional[Tuple[int, int]] = None,
                   device="cuda") -> np.ndarray:
    """Device segmentation chain.

    ``valid_hw``: true (unpadded) crop shape when the input is
    shape-bucketed; every stage applies the reference's border
    semantics relative to that rectangle (reflect for gaussian, cv2
    constant borders for morphology, no padded EDT seeds).

    With ``timings`` each device stage is synchronised and its wall
    clock recorded (``seg_morphology``, ``seg_markers``,
    ``seg_watershed``)."""
    import time as _time

    dev = resolve_device(device)

    def _mark(name, val):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = _time.perf_counter()
            timings[name] = round(now - _mark.t0, 3)
            _mark.t0 = now
        return val

    _mark.t0 = _time.perf_counter()
    th, tw = valid_hw if valid_hw is not None else vegetation_mask.shape[:2]
    mask_dev = torch.from_numpy(np.ascontiguousarray(vegetation_mask)).to(dev)
    binary, valid = _stage_binary(mask_dev, int(th), int(tw),
                                  float(config.gaussian_sigma))
    closed = ops.binary_close(binary, config.morph_kernel_size,
                              config.morph_iterations, valid)
    opened = ops.binary_open(closed, config.morph_kernel_size,
                             config.morph_iterations, valid)
    filled = _mark("seg_morphology", _stage_fill(opened, valid))

    cc = _mark("seg_markers", _stage_markers(filled, valid))
    labels = _mark("seg_watershed", _stage_watershed(cc, filled, valid))
    host = labels.cpu().numpy()
    num = len(np.unique(host)) - 1
    logger.info("Segmented %d potential field regions", num)
    return ops.renumber_labels(host)


def labels_to_polygons(
    labels: np.ndarray, transform: Affine, config: ExtractionConfig
) -> List[dict]:
    features: List[dict] = []
    for label_val, sub, (oy, ox) in iter_label_masks(labels):
        polys = [p for p in mask_to_polygons(sub) if not p.is_empty]
        if not polys:
            continue
        # The reference traces each label with connectivity=8 (one shape
        # per label, ``:424-429``), then buffer(0) splits diagonal
        # pinches and cleanup keeps the largest part (``:504-506``) —
        # net effect: the largest 4-connected piece per label.
        poly = max(polys, key=lambda p: p.area)
        world = poly.transform(lambda x, y: transform * (x + ox, y + oy))
        features.append({"geometry": world, "label": int(label_val)})
    logger.info("Extracted %d raw polygons", len(features))
    return features


def cleanup_polygons(
    features: List[dict], config: ExtractionConfig
) -> List[dict]:
    """Simplify + area filter with the reference's approximations
    (deg→m ≈ 1e-5, area deg²·87000·111000 — ``:489-514``; the constants
    are deliberately resolution-independent, like the reference's)."""
    cleaned: List[dict] = []
    min_area_m2 = config.min_area_ha * 10000
    max_area_m2 = config.max_area_ha * 10000
    simplify_tolerance = config.simplify_tolerance_m * 0.00001
    for feat in features:
        poly: Polygon = feat["geometry"]
        if poly is None or poly.is_empty:
            continue
        poly = poly.simplify(simplify_tolerance)
        area_m2_approx = poly.area * (87000 * 111000)
        if not (min_area_m2 <= area_m2_approx <= max_area_m2):
            continue
        cleaned.append({
            "geometry": poly,
            "label": feat["label"],
            "area_ha": round(area_m2_approx / 10000, 2),
        })
    logger.info("After cleanup: %d polygons (filtered %d)",
                len(cleaned), len(features) - len(cleaned))
    return cleaned


def compute_confidence(feature: dict, source: str, total_features: int) -> float:
    """Identical scoring to ``:535-591``."""
    poly: Polygon = feature["geometry"]
    area_ha = feature.get("area_ha", 1.0)
    base_conf = 0.7 if source == "ndvi" else 0.5
    if 1.0 <= area_ha <= 50.0:
        area_factor = 1.0
    elif 0.5 <= area_ha < 1.0 or 50.0 < area_ha <= 100.0:
        area_factor = 0.8
    else:
        area_factor = 0.6
    perimeter = poly.length
    area = poly.area
    if perimeter > 0:
        compactness = min(4 * np.pi * area / (perimeter**2), 1.0)
    else:
        compactness = 0.5
    shape_factor = 0.7 + 0.3 * compactness
    confidence = base_conf * area_factor * shape_factor
    return round(min(max(confidence, 0.1), 1.0), 2)


def create_geojson_output(features: List[dict], source: str,
                          output_path: Path) -> dict:
    timestamp = datetime.now(timezone.utc).replace(tzinfo=None).isoformat() + "Z"
    geojson_features = []
    for i, feat in enumerate(features):
        poly: Polygon = feat["geometry"]
        confidence = compute_confidence(feat, source, len(features))
        feature_id = hashlib.md5(poly.wkt[:100].encode()).hexdigest()[:12]
        geojson_features.append({
            "type": "Feature",
            "id": feature_id,
            "properties": {
                "id": feature_id,
                "field_index": i + 1,
                "area_ha": feat["area_ha"],
                "source": source,
                "confidence": confidence,
                "created_at": timestamp,
            },
            "geometry": poly.to_geojson(),
        })
    geojson = {
        "type": "FeatureCollection",
        "properties": {
            "generated_at": timestamp,
            "source_method": source,
            "feature_count": len(geojson_features),
            "version": "1.0",
        },
        "features": geojson_features,
    }
    ensure_directory(Path(output_path).parent)
    write_json(geojson, output_path)
    logger.info("GeoJSON saved: %s", output_path)
    return geojson


def bucket_shape(th: int, tw: int) -> Tuple[int, int]:
    """The 256-multiple frame of a (th, tw) crop, at least 8 rows and
    columns of padding where it pads at all (the gaussian's reflected
    window, radius 8 at σ2)."""
    hb = max(256, -(-th // 256) * 256)
    wb = max(256, -(-tw // 256) * 256)
    return (hb + 256 if 0 < hb - th < 8 else hb,
            wb + 256 if 0 < wb - tw < 8 else wb)


def extract_field_polygons(
    aoi_geojson: Path | str,
    raster_paths: List[Path],
    out_dir: Path | str,
    config: Optional[ExtractionConfig] = None,
    device="cuda",
) -> dict:
    """Main entry: AOI crop → mask → segment → polygons → cleanup →
    fields.geojson + extraction_metadata.json. Mask and segmentation run
    on ``device``."""
    device = resolve_device(device)
    out_dir = Path(out_dir)
    if config is None:
        config = ExtractionConfig()
    aoi_geom = load_aoi_geojson(aoi_geojson)

    raster_path = None
    for path in raster_paths:
        path = Path(path)
        if path.exists():
            raster_path = path
            break
    if raster_path is None:
        raise FileNotFoundError(f"No valid raster files found in: {raster_paths}")
    logger.info("Using raster: %s", raster_path)

    raster = read_geotiff(raster_path)
    pixel_size_m = abs(raster.transform.a) * 111000
    logger.info("Approx pixel size: %.1fm", pixel_size_m)
    total_pixels = raster.height * raster.width
    if total_pixels > config.max_pixels_for_full_res:
        # reference parity: v1 only WARNS on big rasters (``:722-728``)
        # — only v2 downsamples (extraction_v2 does, at its own 8 MPix
        # threshold)
        logger.warning(
            "Large raster (%s pixels). Consider downsampling for "
            "faster processing.", f"{total_pixels:,}")

    try:
        working = crop_raster_to_aoi(raster, aoi_geom)
    except Exception as exc:
        logger.warning("Crop failed, using original raster: %s", exc)
        working = raster

    import time as _time

    # Shape-bucket the working raster to 256-multiples (zero padding),
    # as the JAX package does for its per-shape executables: the
    # jump-flooding distance transform rolls around the whole frame, so
    # the same frame gives the JAX package's distances. segment_fields
    # applies the reference's border semantics relative to the true
    # (th, tw) rectangle; pad 1..7 would leave the gaussian's reflected
    # window short (radius 8 at σ2), so such buckets are bumped up.
    th, tw = working.data.shape[:2]
    hb, wb = bucket_shape(th, tw)
    if (hb, wb) != (th, tw):
        padded = np.zeros((hb, wb) + working.data.shape[2:],
                          working.data.dtype)
        padded[:th, :tw] = working.data
        working = GeoTiff(padded, transform=working.transform,
                          crs=working.crs)

    timings: dict = {}
    t0 = _time.perf_counter()
    vegetation_mask, source_method = compute_vegetation_mask(working, config,
                                                             device)
    timings["mask"] = round(_time.perf_counter() - t0, 3)
    t0 = _time.perf_counter()
    # timings=None: no per-stage sync points; only the end-to-end
    # segment time is recorded.
    labels = segment_fields(vegetation_mask, config, valid_hw=(th, tw),
                            device=device)
    labels = labels[:th, :tw]
    timings["segment_total"] = round(_time.perf_counter() - t0, 3)
    t0 = _time.perf_counter()
    raw_features = labels_to_polygons(labels, working.transform, config)
    timings["polygonise"] = round(_time.perf_counter() - t0, 3)
    t0 = _time.perf_counter()
    cleaned = cleanup_polygons(raw_features, config)
    timings["cleanup"] = round(_time.perf_counter() - t0, 3)
    logger.info("stage timings: %s", timings)

    output_path = out_dir / "fields.geojson"
    geojson = create_geojson_output(cleaned, source_method, output_path)

    metadata = {
        "status": "completed",
        "input_raster": str(raster_path),
        "aoi_geojson": str(aoi_geojson),
        "output_geojson": str(output_path),
        "feature_count": len(cleaned),
        "source_method": source_method,
        "stage_timings_s": timings,
        "config": {
            "ndvi_threshold": config.ndvi_threshold,
            "min_area_ha": config.min_area_ha,
            "max_area_ha": config.max_area_ha,
            "simplify_tolerance_m": config.simplify_tolerance_m,
        },
        "created_at": datetime.now(timezone.utc).replace(tzinfo=None).isoformat() + "Z",
    }
    write_json(metadata, out_dir / "extraction_metadata.json")
    logger.info("EXTRACTION COMPLETE: %d field polygons", len(cleaned))
    return {
        "status": "completed",
        "output_path": str(output_path),
        "feature_count": len(cleaned),
        "source_method": source_method,
        "stage_timings_s": timings,
        "geojson": geojson,
    }
