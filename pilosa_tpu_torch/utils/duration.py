"""Go-style duration strings for config values and ?timeout=.

Copy of pilosa_tpu/utils/duration.py (the reference's toml/toml.go wraps
time.Duration so TOML can say `interval = "10m"`): decimal numbers with
unit suffixes ns/us/ms/s/m/h, concatenable ("1h30m", "2.5s"). Bare
numbers pass through as seconds.
"""

from __future__ import annotations

import re

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_PART = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")


def parse_duration(value) -> float:
    """Duration → seconds. Accepts int/float (seconds) or a Go duration
    string like "1h30m" / "250ms"."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    s = str(value).strip()
    if not s:
        return 0.0
    try:
        return float(s)  # bare number
    except ValueError:
        pass
    pos, total = 0, 0.0
    for m in _PART.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {value!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ValueError(f"invalid duration: {value!r}")
    return total
