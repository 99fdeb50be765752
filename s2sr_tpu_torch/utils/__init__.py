from .logging import setup_logging
from .files import (
    ensure_directory,
    find_latest_file,
    find_latest_metadata,
    generate_timestamp,
    read_json,
    write_json,
)
from .timing import StageTimer, stage_timer

__all__ = [
    "setup_logging",
    "ensure_directory",
    "find_latest_file",
    "find_latest_metadata",
    "generate_timestamp",
    "read_json",
    "write_json",
    "StageTimer",
    "stage_timer",
]
