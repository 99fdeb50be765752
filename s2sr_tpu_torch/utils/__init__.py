from .logging import setup_logging
from .timing import StageTimer, stage_timer

__all__ = ["setup_logging", "StageTimer", "stage_timer"]
