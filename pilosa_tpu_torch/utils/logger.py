"""Logger: plain or JSON lines, a verbose gate, and the bridge into the
event journal.

Copy of pilosa_tpu/utils/logger.py (the reference's logger/logger.go):
`Logger` writes "<ts> <LEVEL> <msg>" lines, or with fmt="json" one JSON
object a line with the request's trace id as a `trace` field; debugf
writes only when verbose. With a journal attached (`logger.journal`, set
by the Server) every warnf and errorf line is also a log.warn or
log.error event (its msg cut at 512 characters), in the journal's log
lane, which a storm of them cannot take past its own bound.
`file_logger` appends to a file (the top-level log-path key).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO

FORMATS = ("plain", "json")


class Logger:
    def __init__(self, verbose: bool = False, out: Optional[TextIO] = None,
                 fmt: str = "plain"):
        if fmt not in FORMATS:
            raise ValueError(f"invalid log format {fmt!r} "
                             f"(expected {' | '.join(FORMATS)})")
        self.verbose = verbose
        self.fmt = fmt
        self.out = out or sys.stderr
        self.journal = None  # an EventJournal: warn/error lines as events

    def _trace_id(self) -> Optional[str]:
        try:
            from pilosa_tpu_torch.utils import tracing
            return tracing.current_trace_id.get()
        except Exception:  # noqa: BLE001 — logging must never raise
            return None

    def _emit(self, level: str, fmt: str, *args) -> None:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        msg = fmt % args if args else fmt
        if self.fmt == "json":
            rec = {"ts": ts, "level": level, "msg": msg}
            trace = self._trace_id()
            if trace:
                rec["trace"] = trace
            line = json.dumps(rec, ensure_ascii=False)
        else:
            line = f"{ts} {level} {msg}"
        self.out.write(line + "\n")
        self.out.flush()
        if self.journal is not None and level in ("WARN", "ERROR"):
            try:
                self.journal.emit(
                    "log.warn" if level == "WARN" else "log.error",
                    msg=msg[:512])
            except Exception:  # noqa: BLE001 — logging must never raise
                pass

    def printf(self, fmt: str, *args) -> None:
        self._emit("INFO", fmt, *args)

    def warnf(self, fmt: str, *args) -> None:
        self._emit("WARN", fmt, *args)

    def errorf(self, fmt: str, *args) -> None:
        self._emit("ERROR", fmt, *args)

    def debugf(self, fmt: str, *args) -> None:
        if self.verbose:
            self._emit("DEBUG", fmt, *args)


class NopLogger:
    def printf(self, fmt, *args): pass
    def warnf(self, fmt, *args): pass
    def errorf(self, fmt, *args): pass
    def debugf(self, fmt, *args): pass


def file_logger(path: str, verbose: bool = False,
                fmt: str = "plain") -> Logger:
    """A Logger appending to `path` (the log-path key)."""
    return Logger(verbose=verbose, out=open(path, "a"), fmt=fmt)
