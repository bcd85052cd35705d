"""Per-query deadlines.

Copy of pilosa_tpu/utils/qctx.py: the deadline rides a contextvar (the
fan-out pool runs each submit in a copied context, so it follows the
query there) and crosses node boundaries as the X-Pilosa-Deadline header,
the remaining seconds, which the remote node re-applies as its own
deadline. check() runs between node batches and calls, never inside one.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

DEADLINE_HEADER = "X-Pilosa-Deadline"

# absolute time.monotonic() deadline of the current query, or None
deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "pilosa_torch_query_deadline", default=None)


class QueryTimeoutError(Exception):
    """The query exceeded its deadline."""


def remaining() -> Optional[float]:
    """Seconds left before the deadline, or None without one."""
    dl = deadline.get()
    return None if dl is None else dl - time.monotonic()


def check() -> None:
    """Raise QueryTimeoutError once the deadline has passed."""
    rem = remaining()
    if rem is not None and rem <= 0:
        raise QueryTimeoutError("query deadline exceeded")
