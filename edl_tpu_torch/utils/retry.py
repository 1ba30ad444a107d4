"""Retry-until-timeout decorator (a copy of the JAX package's
``utils/retry.py``, without its retry counter metric, which waits for the
port's metrics module).

Retryable framework errors are swallowed and retried until ``timeout``
seconds elapse, then the last error propagates.  Non-retryable errors
propagate immediately.  ``backoff`` > 1 widens the interval
exponentially, with full jitter, so a job's processes probing a
recovering store fan out instead of stampeding it.
"""

from __future__ import annotations

import functools
import logging
import random
import time

from edl_tpu_torch.utils.exceptions import EdlRetryableError

logger = logging.getLogger(__name__)


def retry_until_timeout(func=None, *, interval: float = 1.0,
                        backoff: float = 1.0, max_interval: float = 30.0,
                        jitter: bool = True):
    """Decorate ``func(..., timeout=N)`` to retry EdlRetryableError.

    The wrapped function must accept a ``timeout`` keyword (seconds).
    ``interval`` is the first retry delay; each subsequent delay is
    multiplied by ``backoff`` and capped at ``max_interval``.  With
    ``jitter`` each sleep is drawn uniformly from (0, delay].
    """

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, timeout: float = 60.0, **kwargs):
            deadline = time.monotonic() + timeout
            delay = interval
            while True:
                try:
                    return f(*args, **kwargs)
                except EdlRetryableError as e:
                    if time.monotonic() >= deadline:
                        raise
                    logger.debug("retrying %s after %s: %s", f.__name__, type(e).__name__, e)
                    sleep = random.uniform(0, delay) if jitter else delay
                    time.sleep(min(sleep, max(0.0, deadline - time.monotonic())))
                    delay = min(delay * backoff, max_interval)

        return wrapper

    return decorate(func) if func is not None else decorate
