"""Filesystem + JSON helpers.

The port's copy of ``s2sr_tpu/utils/files.py``:
ensure_directory, read_json/write_json, generate_timestamp,
find_latest_file, find_latest_metadata.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Any, Iterable, Optional


def ensure_directory(path: Path | str) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    return path


def read_json(path: Path | str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def write_json(data: Any, path: Path | str, indent: int = 2) -> Path:
    path = Path(path)
    ensure_directory(path.parent)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=indent)
    return path


def generate_timestamp() -> str:
    """Timestamp in the sidecar-metadata format used throughout (YYYYmmdd_HHMMSS)."""
    return datetime.now().strftime("%Y%m%d_%H%M%S")


def find_latest_file(
    directory: Path | str,
    patterns: Iterable[str] = ("*.tif", "*.tiff"),
) -> Optional[Path]:
    """Newest file (by mtime) in *directory* matching any glob pattern."""
    directory = Path(directory)
    if not directory.exists():
        return None
    candidates: list[Path] = []
    for pattern in patterns:
        candidates.extend(directory.glob(pattern))
    if not candidates:
        return None
    return max(candidates, key=lambda p: p.stat().st_mtime)


def find_latest_metadata(directory: Path | str) -> Optional[dict]:
    """Newest ``*metadata*.json`` sidecar in *directory*, parsed."""
    latest = find_latest_file(directory, patterns=("*metadata*.json",))
    if latest is None:
        return None
    try:
        return read_json(latest)
    except (json.JSONDecodeError, OSError):
        return None
