"""Data-acquisition clients: public Earth-Search COGs and UP42 ordering
(the port of ``s2sr_tpu/fetch/client.py``).

- :class:`PublicSentinel2Client` — STAC search against Earth-Search,
  the ``visual`` COG asset read by HTTP range requests over the AOI's
  window (``geo/cog.py``), or the RGB bands merged, then clipped to a
  1024² AOI window by the bilinear warp on ``device`` (the card unless
  the caller asks for the CPU).
- :class:`UP42Client` — OAuth2 username/password flow, catalog search,
  order reuse or creation, polling and asset download, each call retried
  with exponential backoff.

HTTP goes through ``urllib`` (the card's machine has no ``requests``):
``urlopen`` raises ``HTTPError`` on a 4xx or 5xx reply where the JAX
package calls ``raise_for_status``. Every network path honours
``Settings.offline``.
"""

from __future__ import annotations

import json
import tempfile
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Settings, get_settings
from ..geo import Affine, CRS, GeoTiff, read_geotiff, write_geotiff
from ..geo.warp import control_grid, warp_bilinear_batch
from ..utils import ensure_directory, retry_with_backoff, setup_logging, write_json

logger = setup_logging("s2sr_tpu_torch.fetch")

EARTH_SEARCH = "https://earth-search.aws.element84.com/v1/search"


def http_request(url: str, timeout: float, json_body=None, form=None,
                 params: Optional[dict] = None,
                 headers: Optional[dict] = None):
    """An open ``urllib`` response: a POST of ``json_body`` (as
    ``requests``' ``json=``) or of ``form`` (``data=``), else a GET with
    ``params`` in the query. Raises ``HTTPError`` on a 4xx or 5xx reply."""
    headers = dict(headers or {})
    body = None
    if json_body is not None:
        body = json.dumps(json_body).encode()
        headers.setdefault("Content-Type", "application/json")
    elif form is not None:
        body = urllib.parse.urlencode(form).encode()
        headers.setdefault("Content-Type",
                           "application/x-www-form-urlencoded")
    if params:
        url += ("&" if "?" in url else "?") + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST" if body is not None else "GET")
    return urllib.request.urlopen(req, timeout=timeout)


def http_json(url: str, timeout: float, **kw):
    """The JSON body of :func:`http_request`'s reply."""
    with http_request(url, timeout, **kw) as r:
        return json.loads(r.read())


@dataclass
class Scene:
    """A catalog scene."""

    scene_id: str
    acquisition_date: datetime
    cloud_cover: float
    assets: dict = field(default_factory=dict)
    properties: dict = field(default_factory=dict)

    @classmethod
    def from_stac_feature(cls, feature: dict) -> "Scene":
        props = feature.get("properties", {})
        # STAC allows "datetime": null for composite items — never call
        # .replace on a None
        raw = str(props.get("datetime") or "")
        try:
            acq = datetime.fromisoformat(raw.replace("Z", "+00:00"))
        except ValueError:
            acq = datetime.now(timezone.utc).replace(tzinfo=None)
        return cls(
            scene_id=feature.get("id", "unknown"),
            acquisition_date=acq,
            cloud_cover=float(props.get("eo:cloud_cover", 100.0)),
            assets=feature.get("assets", {}),
            properties=props,
        )


def _aoi_bounds(aoi_geometry: dict) -> Tuple[float, float, float, float]:
    coords = aoi_geometry["coordinates"]
    while isinstance(coords[0][0], (list, tuple)):
        coords = coords[0]
    lons = [c[0] for c in coords]
    lats = [c[1] for c in coords]
    return (min(lons), min(lats), max(lons), max(lats))


def stac_payload(aoi_geometry: dict, max_age_days: int, max_cloud: float,
                 limit: int, collections=("sentinel-2-l2a",)) -> dict:
    """Earth-Search's search body: the AOI, the last ``max_age_days``
    days, cloud cover at most ``max_cloud``, least cloudy first."""
    end = datetime.now(timezone.utc).replace(tzinfo=None)
    start = end - timedelta(days=max_age_days)
    return {
        "collections": list(collections),
        "intersects": aoi_geometry,
        "datetime": (f"{start:%Y-%m-%d}T00:00:00Z/"
                     f"{end:%Y-%m-%d}T23:59:59Z"),
        "query": {"eo:cloud_cover": {"lte": max_cloud}},
        "limit": limit,
        "sortby": [{"field": "properties.eo:cloud_cover",
                    "direction": "asc"}],
    }


class PublicSentinel2Client:
    """Free AWS Earth-Search acquisition path."""

    def __init__(self, settings: Optional[Settings] = None,
                 device: str | torch.device = "cuda"):
        self.settings = settings or get_settings()
        self.device = torch.device(device)

    def search(self, aoi_geometry: dict, max_age_days: int = 30,
               max_cloud: float = 30.0, limit: int = 10) -> List[Scene]:
        if self.settings.offline:
            return []
        payload = stac_payload(aoi_geometry, max_age_days, max_cloud, limit)
        reply = http_json(EARTH_SEARCH, 30, json_body=payload)
        return [Scene.from_stac_feature(f)
                for f in reply.get("features", [])]

    def _download_asset(self, url: str,
                        aoi_geometry: Optional[dict] = None) -> GeoTiff:
        """Fetch an asset. For COGs with a known AOI only the
        intersecting chunks are range-requested (:class:`CogReader`);
        otherwise the whole file is downloaded."""
        if aoi_geometry is not None:
            try:
                return self._stream_window(url, aoi_geometry)
            except Exception as exc:
                logger.warning("windowed COG read failed (%s); "
                               "falling back to full download", exc)
        with http_request(url, 300) as r, \
                tempfile.NamedTemporaryFile(suffix=".tif") as tmp:
            while chunk := r.read(1 << 20):
                tmp.write(chunk)
            tmp.flush()
            return read_geotiff(tmp.name)

    def _stream_window(self, url: str, aoi_geometry: dict,
                       margin: int = 64) -> GeoTiff:
        from ..geo.cog import CogReader
        from ..geo.crs import transform_bounds

        reader = CogReader(url)
        try:
            w, s, e, n = _aoi_bounds(aoi_geometry)
            if reader.crs is not None and not reader.crs.is_geographic:
                w, s, e, n = transform_bounds(CRS(4326), reader.crs,
                                              w, s, e, n)
            inv = ~reader.transform
            cols, rows = zip(*[inv * (x, y) for x, y in
                               ((w, s), (e, s), (e, n), (w, n))])
            c0 = int(np.floor(min(cols))) - margin
            r0 = int(np.floor(min(rows))) - margin
            c1 = int(np.ceil(max(cols))) + margin
            r1 = int(np.ceil(max(rows))) + margin
            out = reader.window_geotiff(r0, c0, r1 - r0, c1 - c0)
        finally:
            reader.close()
        logger.info("streamed COG window %dx%d from %s (%d range requests)",
                    r1 - r0, c1 - c0, url.rsplit("/", 1)[-1],
                    getattr(reader._f, "requests_made", -1))
        return out

    def _clip_to_aoi(self, raster: GeoTiff, aoi_geometry: dict,
                     out_size: int = 1024) -> GeoTiff:
        """AOI window at out_size² in EPSG:4326 (a ``gdalwarp -ts 1024
        1024`` clip): the bilinear warp, rounding and uint8 on
        ``self.device``, one copy back."""
        w, s, e, n = _aoi_bounds(aoi_geometry)
        dst_transform = Affine.from_bounds(w, s, e, n, out_size, out_size)
        ctrl = control_grid(dst_transform, CRS(4326), raster.transform,
                            raster.crs or CRS(4326), out_size, out_size)
        dev = self.device
        src = torch.from_numpy(raster.data[:, :, :3].astype(np.float32)).to(dev)
        rgb, _ = warp_bilinear_batch(src, torch.from_numpy(ctrl)[None].to(dev),
                                     out_size, out_size)
        data = torch.round(rgb[0]).clamp(0, 255).to(torch.uint8).cpu().numpy()
        return GeoTiff(data, transform=dst_transform, crs=CRS(4326))

    def fetch_best_scene(
        self, aoi_geometry: dict, output_dir: Path,
        scene: Optional[dict] = None,
        max_age_days: int = 30, max_cloud: float = 30.0,
    ) -> Tuple[Path, dict]:
        """Fetch the chosen (or best-searched) scene: the visual asset,
        else the RGB bands merged. Raises on failure: the caller
        (smart_fetch) owns the remote → local → synthetic ladder; the
        client never substitutes data for a scene it committed to."""
        ensure_directory(output_dir)
        if scene is not None and scene.get("feature"):
            # smart_fetch already searched and chose — reuse its feature
            # (re-searching with different parameters could exclude the
            # very scene the fetch decision was made on)
            best = Scene.from_stac_feature(scene["feature"])
        else:
            scenes = self.search(aoi_geometry, max_age_days=max_age_days,
                                 max_cloud=max_cloud)
            if scene is not None and scenes:
                scenes = ([s for s in scenes
                           if s.scene_id == scene["scene_id"]] or scenes)
            if not scenes:
                raise ValueError(
                    f"No Sentinel-2 scenes found within {max_age_days} days "
                    f"with cloud cover <= {max_cloud}%")
            best = scenes[0]

        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out_path = Path(output_dir) / f"{ts}_sentinel2.tif"
        raster: Optional[GeoTiff] = None
        try:
            visual = best.assets.get("visual", {}).get("href")
            if visual:
                raster = self._download_asset(visual, aoi_geometry)
        except Exception as exc:
            logger.warning("visual asset failed: %s — trying RGB bands", exc)
        if raster is None:
            bands = []
            for key in ("red", "green", "blue"):
                href = best.assets.get(key, {}).get("href")
                if not href:
                    raise KeyError(f"scene {best.scene_id} missing band {key}")
                bands.append(self._download_asset(href, aoi_geometry))
            stack = np.concatenate([b.data[:, :, :1] for b in bands], axis=-1)
            # L2A TCI rendering: reflectance DN / 3000 full-scale (the
            # fixed stretch the 'visual' asset itself uses) — a per-scene
            # max would let one specular pixel black out the composite
            rgb = np.clip(stack.astype(np.float32) * (255.0 / 3000.0),
                          0, 255).astype(np.uint8)
            raster = GeoTiff(rgb, transform=bands[0].transform,
                             crs=bands[0].crs)

        clipped = self._clip_to_aoi(raster, aoi_geometry)
        write_geotiff(clipped, out_path)
        metadata = {
            "scene_id": best.scene_id,
            "acquisition_date": best.acquisition_date.isoformat(),
            "cloud_cover_pct": best.cloud_cover,
            "file_path": str(out_path),
            "source": "aws_earth_search",
        }
        write_json(metadata, out_path.with_suffix(".json"))
        return out_path, metadata


class UP42Client:
    """Commercial UP42 ordering path; the endpoints are the settings'
    ``up42_auth_url``, ``up42_api_base`` and ``up42_catalog_url``."""

    def __init__(self, settings: Optional[Settings] = None):
        self.settings = settings or get_settings()
        self._token: Optional[str] = None
        self._token_expiry = 0.0

    def _require_online(self) -> None:
        if self.settings.offline:
            raise RuntimeError("UP42Client disabled: Settings.offline=True")
        if not (self.settings.up42_username and self.settings.up42_password):
            raise RuntimeError("UP42 credentials not configured")

    @retry_with_backoff(max_retries=3)
    def authenticate(self) -> str:
        self._require_online()
        if self._token and time.time() < self._token_expiry - 60:
            return self._token
        payload = http_json(self.settings.up42_auth_url, 30, form={
            "grant_type": "password",
            "username": self.settings.up42_username,
            "password": self.settings.up42_password,
            "client_id": "up42-api",
        })
        self._token = payload["access_token"]
        self._token_expiry = time.time() + payload.get("expires_in", 300)
        return self._token

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.authenticate()}"}

    @retry_with_backoff(max_retries=3)
    def search_catalog(self, aoi_geometry: dict, max_age_days: int = 30,
                       max_cloud: float = 30.0) -> List[Scene]:
        end = datetime.now(timezone.utc).replace(tzinfo=None)
        start = end - timedelta(days=max_age_days)
        payload = {
            "datetime": (f"{start:%Y-%m-%d}T00:00:00Z/"
                         f"{end:%Y-%m-%d}T23:59:59Z"),
            "intersects": aoi_geometry,
            "query": {
                "cloudCoverage": {"lte": max_cloud},
                "dataProduct": {"in": ["sentinel-2-level-2a"]},
            },
            "limit": 10,
        }
        reply = http_json(self.settings.up42_catalog_url, 60,
                          json_body=payload, headers=self._headers())
        return [Scene.from_stac_feature(f)
                for f in reply.get("features", [])]

    @retry_with_backoff(max_retries=3)
    def find_existing_order(self, scene_id: str) -> Optional[str]:
        """Reuse a fulfilled order for the same scene before paying for a
        new one."""
        reply = http_json(f"{self.settings.up42_api_base}/orders", 30,
                          params={"status": "FULFILLED", "size": 50},
                          headers=self._headers())
        for order in reply.get("content", []):
            params = order.get("params", {}) or {}
            if params.get("id") == scene_id:
                return order.get("id")
        return None

    @retry_with_backoff(max_retries=3)
    def create_order(self, scene: Scene, aoi_geometry: dict) -> str:
        reply = http_json(
            f"{self.settings.up42_api_base}/orders", 60,
            json_body={
                "dataProduct": scene.properties.get("up42:dataProduct",
                                                    "sentinel-2-level-2a"),
                "params": {"id": scene.scene_id, "aoi": aoi_geometry},
            },
            headers=self._headers(),
        )
        return reply["id"]

    def wait_for_order(self, order_id: str, timeout_s: float = 1800,
                       poll_s: float = 30) -> dict:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            order = http_json(
                f"{self.settings.up42_api_base}/orders/{order_id}", 30,
                headers=self._headers())
            status = order.get("status", "")
            if status in ("FULFILLED", "COMPLETED"):
                return order
            if status in ("FAILED", "FAILED_PERMANENTLY"):
                raise RuntimeError(f"UP42 order {order_id} failed: {status}")
            time.sleep(poll_s)
        raise TimeoutError(f"UP42 order {order_id} not fulfilled in {timeout_s}s")

    @retry_with_backoff(max_retries=3)
    def download_asset(self, asset_url: str, output_path: Path) -> Path:
        output_path = Path(output_path)
        with http_request(asset_url, 600, headers=self._headers()) as r:
            ensure_directory(output_path.parent)
            with open(output_path, "wb") as f:
                while chunk := r.read(1 << 20):
                    f.write(chunk)
        return output_path

    def fetch_best_scene(self, aoi_geometry: dict,
                         output_dir: Path) -> Tuple[Path, dict]:
        self._require_online()
        scenes = self.search_catalog(aoi_geometry)
        if not scenes:
            raise RuntimeError("UP42 catalog returned no scenes")
        best = min(scenes, key=lambda s: s.cloud_cover)
        order_id = self.find_existing_order(best.scene_id)
        if order_id:
            logger.info("reusing fulfilled UP42 order %s for scene %s",
                        order_id, best.scene_id)
        else:
            order_id = self.create_order(best, aoi_geometry)
        order = self.wait_for_order(order_id)
        assets = order.get("assets", [])
        if not assets:
            raise RuntimeError(f"order {order_id} has no assets")
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = Path(output_dir) / f"{ts}_up42.tif"
        self.download_asset(assets[0].get("url", ""), out)
        metadata = {
            "scene_id": best.scene_id,
            "acquisition_date": best.acquisition_date.isoformat(),
            "cloud_cover_pct": best.cloud_cover,
            "file_path": str(out),
            "source": "up42",
            "order_id": order_id,
        }
        write_json(metadata, out.with_suffix(".json"))
        return out, metadata
