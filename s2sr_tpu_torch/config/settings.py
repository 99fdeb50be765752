"""Environment-driven application settings.

A plain dataclass (the card's machine has no pydantic) with every field
of the JAX package's ``Settings``, under the same names and defaults.
Values come from (lowest → highest precedence) defaults → ``.env`` →
process environment → explicit overrides, with case-insensitive names;
strings from ``.env`` and the environment are coerced to the field's
type with pydantic's lax rules (:mod:`..utils.validation`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Optional

from ..utils.validation import coerce


@dataclass
class Settings:
    # UP42 credentials (optional; offline mode works without them)
    up42_username: str = ""
    up42_password: str = ""
    up42_project_id: str = ""

    # Imagery search parameters
    days_lookback: int = 30
    max_cloud_pct: float = 10.0

    # Tiling parameters
    tile_min_zoom: int = 10
    tile_max_zoom: int = 16

    # Client configuration
    mapbox_access_token: str = ""

    # Paths
    aoi_path: str = "config/aoi.geojson"
    data_dir: str = "data"

    # Server
    server_host: str = "0.0.0.0"
    server_port: int = 8080

    # UP42 API configuration
    up42_auth_url: str = (
        "https://auth.up42.com/realms/public/protocol/openid-connect/token"
    )
    up42_api_base: str = "https://api.up42.com/v2"
    up42_catalog_url: str = "https://api.up42.com/catalog/stac/search"

    # Job orchestration
    max_concurrent_enhance: int = 1
    max_upload_mb: int = 50

    # SR execution knobs
    sr_tile_size: int = 256      # halo-tiling grid pitch
    sr_tile_pad: int = 4         # halo width
    sr_batch_size: int = 16      # windows per device chunk
    sr_dtype: str = "bfloat16"   # compute dtype for the SR model
    # exact-path engage ceiling in pixels (0 = tile²·4)
    sr_exact_area: int = 0
    # per-checkpoint halo-exactness probe at engine build
    sr_pad_probe: bool = True
    mesh_shape: str = ""         # e.g. "dp=4": serve over that mesh
    offline: bool = True         # no network fetches
    weights_dir: str = "models"  # converted-weight cache directory

    @property
    def data_path(self) -> Path:
        return Path(self.data_dir)

    @property
    def max_upload_bytes(self) -> int:
        return self.max_upload_mb * 1024 * 1024


def _parse_env_file(path: Path) -> dict[str, str]:
    out: dict[str, str] = {}
    if not path.exists():
        return out
    for line in path.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        out[key.strip().lower()] = value.strip().strip("'\"")
    return out


def load_settings(env_file: Optional[Path | str] = ".env", **overrides) -> Settings:
    fields = {f.name: f for f in dataclasses.fields(Settings)}
    values: dict[str, object] = {}
    if env_file is not None:
        values.update(_parse_env_file(Path(env_file)))
    env_lower = {k.lower(): v for k, v in os.environ.items()}
    values.update({k: env_lower[k] for k in fields if k in env_lower})
    values = {k: v for k, v in values.items() if k in fields}
    values.update(overrides)
    return Settings(**{k: coerce(fields[k].type, v) for k, v in values.items()})


@lru_cache()
def get_settings() -> Settings:
    return load_settings()
