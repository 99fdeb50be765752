"""Smart fetch: best-scene selection between local cache and remote catalog
(the port of ``s2sr_tpu/fetch/smart_fetch.py``), with the same decision
rules:

- local scan: ``*.tif`` + sidecar metadata (three sidecar name
  patterns), filter by age/cloud, sort cloud asc then date desc;
- remote: an Earth-Search STAC POST to ``STAC_URL`` (skipped offline);
- fetch only when remote is >5 % better cloud, or >3 days newer at
  equal-or-better cloud, or forced; same-scene short-circuit;
- graceful degradation ladder: remote failure → local → synthetic
  fixture scene, so the pipeline always completes offline.

The fetched scene is clipped to the AOI on ``device`` (the card unless
the caller asks for the CPU; ``fetch/client.py``).
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..config import Settings, get_settings
from ..utils import ensure_directory, read_json, setup_logging, write_json
from .client import PublicSentinel2Client, http_json, stac_payload
from .synthetic import DEFAULT_BOUNDS, synthetic_scene

logger = setup_logging("s2sr_tpu_torch.smart_fetch")

STAC_URL = "https://earth-search.aws.element84.com/v1/search"


def get_local_images(source_dir: Path) -> list[dict]:
    images = []
    source_dir = Path(source_dir)
    if not source_dir.exists():
        return images
    for tif_file in sorted(source_dir.glob("*.tif")):
        meta_patterns = [
            tif_file.with_suffix(".json"),
            tif_file.parent / f"{tif_file.stem.rsplit('_', 1)[0]}_meta.json",
            tif_file.parent / f"{tif_file.stem}_meta.json",
        ]
        metadata = None
        for meta_path in meta_patterns:
            if meta_path.exists():
                try:
                    metadata = read_json(meta_path)
                    break
                except Exception:
                    continue
        # UTC-naive like every other date in the ranking (sidecar
        # acquisition dates and the utcnow-based age cutoff) — naive
        # LOCAL time would shift sidecar-less files by the host tz
        acq_date = datetime.fromtimestamp(
            tif_file.stat().st_mtime, tz=timezone.utc).replace(tzinfo=None)
        cloud = 100.0
        scene_id = tif_file.stem
        if metadata:
            raw = str(metadata.get("acquisition_date", ""))
            if raw:
                try:
                    acq_date = datetime.fromisoformat(raw.replace("Z", "+00:00"))
                except ValueError:
                    pass
            cloud = float(metadata.get("cloud_cover_pct", 100))
            scene_id = metadata.get("scene_id", scene_id)
        images.append({
            "path": tif_file,
            "scene_id": scene_id,
            "acquisition_date": acq_date,
            "cloud_cover": cloud,
            "metadata": metadata,
        })
    return images


def select_best_local_image(
    source_dir: Path, max_age_days: int = 30, max_cloud_cover: float = 30.0
) -> Optional[dict]:
    images = get_local_images(source_dir)
    cutoff = datetime.now(timezone.utc).replace(tzinfo=None) - timedelta(days=max_age_days)
    valid = []
    for img in images:
        acq = img["acquisition_date"]
        if acq.tzinfo is not None:
            acq = acq.replace(tzinfo=None)
        if acq >= cutoff and img["cloud_cover"] <= max_cloud_cover:
            valid.append(img)
    # synthetic fixtures never compete with real imagery: their sidecar
    # (cloud 0.0, date=now) would permanently outrank every real scene
    # and suppress all future fetch rules
    valid = [img for img in valid
             if (img["metadata"] or {}).get("source") != "synthetic_fallback"]
    if not valid:
        return None
    valid.sort(key=lambda x: (x["cloud_cover"],
                              -x["acquisition_date"].timestamp()))
    best = valid[0]
    logger.info("Best local image: %s (cloud %.1f%%)",
                best["scene_id"], best["cloud_cover"])
    return best


def check_remote_catalog(
    aoi_geometry: dict, max_age_days: int = 30, max_cloud_cover: float = 30.0,
    settings: Optional[Settings] = None,
) -> Optional[dict]:
    settings = settings or get_settings()
    if settings.offline:
        logger.info("offline mode: skipping remote catalog")
        return None
    payload = stac_payload(aoi_geometry, max_age_days, max_cloud_cover, 10)
    try:
        features = http_json(STAC_URL, 30, json_body=payload).get(
            "features", [])
    except Exception as exc:
        logger.warning("Remote catalog search failed: %s", exc)
        return None
    if not features:
        return None
    best = features[0]
    props = best.get("properties", {})
    raw = str(props.get("datetime") or "")  # STAC allows null datetime
    try:
        acq = datetime.fromisoformat(raw.replace("Z", "+00:00"))
    except ValueError:
        acq = datetime.now(timezone.utc).replace(tzinfo=None)
    return {
        "scene_id": best.get("id", "unknown"),
        "acquisition_date": acq,
        "cloud_cover": props.get("eo:cloud_cover", 100),
        "feature": best,
    }


def _synthesize_scene(source_dir: Path, aoi_geometry: Optional[dict]) -> Tuple[Path, dict]:
    """Deterministic fallback fixture scene + sidecar metadata.

    The sidecar carries ``source: synthetic_fallback`` so scene
    selection skips it (it must never outrank or block real imagery).
    An existing fixture is reused rather than re-synthesized each run."""
    source_dir = Path(source_dir)
    existing = sorted(source_dir.glob("synthetic_*.tif"))
    for path in reversed(existing):
        meta_path = path.with_suffix(".json")
        if meta_path.exists():
            try:
                metadata = read_json(meta_path)
            except Exception:
                continue
            if metadata.get("source") == "synthetic_fallback":
                logger.warning(
                    "No imagery source available — reusing fixture %s", path)
                return path, metadata
    bounds = DEFAULT_BOUNDS
    if aoi_geometry and aoi_geometry.get("coordinates"):
        coords = aoi_geometry["coordinates"]
        while isinstance(coords[0][0], (list, tuple)):
            coords = coords[0]
        lons = [c[0] for c in coords]
        lats = [c[1] for c in coords]
        bounds = (min(lons), min(lats), max(lons), max(lats))
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = Path(source_dir) / f"synthetic_{ts}.tif"
    synthetic_scene(path=path, size=(512, 512), bounds=bounds)
    metadata = {
        "scene_id": f"synthetic_{ts}",
        "acquisition_date": datetime.now(timezone.utc).replace(tzinfo=None).isoformat() + "Z",
        "cloud_cover_pct": 0.0,
        "file_path": str(path),
        "source": "synthetic_fallback",
    }
    write_json(metadata, path.with_suffix(".json"))
    logger.warning("No imagery source available — synthesized fixture scene %s", path)
    return path, metadata


def smart_fetch(
    aoi_geometry: dict,
    source_dir: Path,
    max_age_days: int = 30,
    max_cloud_cover: float = 30.0,
    force_fetch: bool = False,
    settings: Optional[Settings] = None,
    device: str | torch.device = "cuda",
) -> Tuple[Path, dict]:
    """(scene path, metadata): a fetched scene, the best local one, or
    the synthetic fixture. ``settings`` (default :func:`get_settings`)
    gives ``offline``; a fetched scene is clipped on ``device``."""
    settings = settings or get_settings()
    ensure_directory(source_dir)
    best_local = select_best_local_image(source_dir, max_age_days, max_cloud_cover)
    best_remote = check_remote_catalog(aoi_geometry, max_age_days,
                                       max_cloud_cover, settings)

    should_fetch = False
    reason = ""
    if force_fetch:
        should_fetch, reason = True, "force_fetch=True"
    elif best_local is None:
        should_fetch, reason = True, "No suitable local image"
    elif best_remote is not None:
        lc, rc = best_local["cloud_cover"], best_remote["cloud_cover"]
        ld = best_local["acquisition_date"].replace(tzinfo=None)
        rd = best_remote["acquisition_date"].replace(tzinfo=None)
        if rc < lc - 5:
            should_fetch, reason = True, f"Remote better cloud ({rc}% vs {lc}%)"
        elif rd > ld + timedelta(days=3) and rc <= lc:
            should_fetch, reason = True, f"Remote newer ({rd.date()} vs {ld.date()})"
        elif best_local["scene_id"] == best_remote["scene_id"]:
            reason = "Same scene already local"

    if should_fetch and best_remote is not None:
        logger.info("Fetching from remote: %s", reason)
        client = PublicSentinel2Client(settings, device=device)
        try:
            return client.fetch_best_scene(aoi_geometry, Path(source_dir),
                                           scene=best_remote,
                                           max_age_days=max_age_days,
                                           max_cloud=max_cloud_cover)
        except Exception as exc:
            logger.warning("Remote fetch failed (%s); falling back", exc)

    if best_local is not None:
        logger.info("Using local image: %s (%s)", best_local["path"].name,
                    reason or "Local is optimal")
        return best_local["path"], best_local["metadata"] or {
            "scene_id": best_local["scene_id"],
            "acquisition_date": best_local["acquisition_date"].isoformat(),
            "cloud_cover_pct": best_local["cloud_cover"],
            "file_path": str(best_local["path"]),
            "source": "local",
        }

    return _synthesize_scene(Path(source_dir), aoi_geometry)


def load_aoi_geometry(aoi_path: Path | str) -> dict:
    aoi_data = read_json(aoi_path)
    if aoi_data.get("type") == "FeatureCollection":
        features = aoi_data.get("features") or []
        if not features:
            raise ValueError("No features found in AOI GeoJSON")
        return features[0]["geometry"]
    if aoi_data.get("type") == "Feature":
        return aoi_data["geometry"]
    return aoi_data


def ensure_best_image(
    source_dir: Optional[Path] = None,
    max_age_days: int = 30,
    max_cloud_cover: float = 30.0,
    force_fetch: bool = False,
    settings: Optional[Settings] = None,
    device: str | torch.device = "cuda",
) -> Tuple[Path, dict]:
    """(scene path, metadata) for the pipeline: :func:`smart_fetch` over
    the settings' AOI. ``settings`` (default :func:`get_settings`) gives
    the AOI, ``data_dir`` and ``offline``; a fetched scene is clipped on
    ``device``."""
    settings = settings or get_settings()
    if source_dir is None:
        source_dir = Path(settings.data_dir) / "source"
    aoi_path = Path(settings.aoi_path)
    if aoi_path.exists():
        aoi_geometry = load_aoi_geometry(aoi_path)
    else:
        logger.warning("AOI file not found: %s — using default AOI", aoi_path)
        w, s, e, n = DEFAULT_BOUNDS
        aoi_geometry = {
            "type": "Polygon",
            "coordinates": [[[w, s], [e, s], [e, n], [w, n], [w, s]]],
        }
    return smart_fetch(
        aoi_geometry=aoi_geometry,
        source_dir=Path(source_dir),
        max_age_days=max_age_days,
        max_cloud_cover=max_cloud_cover,
        force_fetch=force_fetch,
        settings=settings,
        device=device,
    )
