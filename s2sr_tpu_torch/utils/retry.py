"""Retry with exponential backoff (the port's copy of
``s2sr_tpu/utils/retry.py``), used around the UP42 client's
auth/search/order/download calls.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Tuple, Type

logger = logging.getLogger("s2sr_tpu_torch.retry")


def retry_with_backoff(
    max_retries: int = 3,
    base_delay: float = 1.0,
    max_delay: float = 60.0,
    backoff_factor: float = 2.0,
    exceptions: Tuple[Type[BaseException], ...] = (Exception,),
) -> Callable:
    """Decorator retrying a callable with exponential backoff.

    Delay for attempt *k* (0-based) is ``min(base_delay * factor**k, max_delay)``.
    The final failure re-raises the last exception.
    """

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            last_exc: BaseException | None = None
            for attempt in range(max_retries + 1):
                try:
                    return fn(*args, **kwargs)
                except exceptions as exc:  # noqa: PERF203
                    last_exc = exc
                    if attempt == max_retries:
                        break
                    delay = min(base_delay * backoff_factor**attempt, max_delay)
                    logger.warning(
                        "%s failed (attempt %d/%d): %s — retrying in %.1fs",
                        fn.__name__, attempt + 1, max_retries + 1, exc, delay,
                    )
                    time.sleep(delay)
            assert last_exc is not None
            raise last_exc

        return wrapper

    return decorator
