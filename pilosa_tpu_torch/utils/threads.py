"""Context-carrying thread primitives.

Copy of pilosa_tpu/utils/threads.py. A request's attribution rides
contextvars: its trace id (utils/tracing.py), query profile
(utils/profile.py), usage account (utils/accounting.py), deadline
(utils/qctx.py) and QoS priority (qos.py). A raw `threading.Thread` or
`threading.Timer` starts its target in an empty context, so a background
hop (the broadcast fan-out, the return heal, the fence worker, the
scrubber's ticks, the telemetry sampler, the federation's fetches) would
drop the attribution of the request that caused it. Every helper here
copies the caller's context with `contextvars.copy_context()` and runs
the target inside it.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Callable, Optional


def ctx_thread(target: Callable, args: tuple = (),
               kwargs: Optional[dict] = None, *,
               name: Optional[str] = None,
               daemon: bool = True) -> threading.Thread:
    """A not-yet-started Thread whose target runs in a copy of the
    caller's context (trace/principal/deadline/priority survive)."""
    ctx = contextvars.copy_context()
    kw = kwargs or {}
    return threading.Thread(
        target=lambda: ctx.run(target, *args, **kw), name=name,
        daemon=daemon)


def spawn(target: Callable, *args, name: Optional[str] = None,
          daemon: bool = True, **kwargs) -> threading.Thread:
    """ctx_thread + start — the fire-and-forget form."""
    t = ctx_thread(target, args=args, kwargs=kwargs, name=name,
                   daemon=daemon)
    t.start()
    return t


def ctx_timer(interval: float, fn: Callable, args: tuple = (),
              kwargs: Optional[dict] = None) -> threading.Timer:
    """A daemon threading.Timer whose callback runs in a copy of the
    scheduling context. Self-rescheduling tick chains copy the TICK
    thread's context at each reschedule, which is what they had anyway."""
    ctx = contextvars.copy_context()
    kw = kwargs or {}
    t = threading.Timer(interval, lambda: ctx.run(fn, *args, **kw))
    t.daemon = True
    return t


def submit_ctx(pool, fn: Callable, *args, **kwargs):
    """pool.submit with the caller's context copied into the task —
    equivalent to pool.submit(contextvars.copy_context().run, fn, ...)."""
    return pool.submit(contextvars.copy_context().run, fn, *args, **kwargs)
