"""Environment-driven settings for the port's SR path.

A plain dataclass (the card's machine has no pydantic) with the fields
this package reads, under the same names and defaults as the JAX
package's ``Settings``. Values come from (lowest → highest precedence)
defaults → ``.env`` → process environment → explicit overrides, with
case-insensitive names.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Optional


@dataclass
class Settings:
    sr_tile_size: int = 256      # halo-tiling grid pitch
    sr_tile_pad: int = 4         # halo width
    sr_batch_size: int = 16      # windows per device chunk
    sr_dtype: str = "bfloat16"   # compute dtype for the SR model
    # exact-path engage ceiling in pixels (0 = tile²·4)
    sr_exact_area: int = 0
    # per-checkpoint halo-exactness probe at engine build
    sr_pad_probe: bool = True


def _coerce(field: dataclasses.Field, value):
    if not isinstance(value, str):
        return value
    if field.type in (bool, "bool"):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if field.type in (int, "int"):
        return int(value)
    return value


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
    return Settings(**{k: _coerce(fields[k], v) for k, v in values.items()})


@lru_cache()
def get_settings() -> Settings:
    return load_settings()
