"""Generic retry with exponential backoff: the port's copy of
vision_compression_project_tpu/utils/retry.py.

Same failure semantics as the reference (backend/app/pipeline/utils.py:56-88):
N attempts, per-attempt backoff schedule, final exception re-raised.  Used at
batch granularity here (failed pages are re-queued, not fatal).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence, TypeVar

T = TypeVar("T")

logger = logging.getLogger(__name__)


def retry(
    fn: Callable[[], T],
    attempts: int = 3,
    backoff: Sequence[float] = (1.0, 2.0, 4.0),
    retryable: Optional[tuple] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping ``backoff[i]`` between tries.

    ``retryable`` optionally restricts which exception types are retried;
    anything else propagates immediately.
    """
    last_exc: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 - generic by design
            if retryable is not None and not isinstance(exc, retryable):
                raise
            last_exc = exc
            if attempt + 1 < attempts:
                delay = backoff[min(attempt, len(backoff) - 1)]
                logger.warning(
                    "retry: attempt %d/%d failed (%s); sleeping %.1fs",
                    attempt + 1,
                    attempts,
                    exc,
                    delay,
                )
                sleep(delay)
    assert last_exc is not None
    raise last_exc
