"""Time quantum: the views a timestamped write lands in, and the minimal
cover of a time range.

Copy of pilosa_tpu/models/timequantum.py (pure Python; reference
time.go:36-215). A time field with quantum "YMD" writes each bit into the
standard view and one view per unit (standard_2019, standard_201903,
standard_20190301), and a Range over [start, end) reads the fewest views
that exactly cover it: the largest unit on the aligned interior, smaller
units at the ragged edges.
"""

from __future__ import annotations

from datetime import datetime, timedelta

VALID_UNITS = "YMDH"

# view-name timestamp layouts per unit (viewByTimeUnit, time.go:176-215)
_FORMATS = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def validate_quantum(q: str) -> None:
    """A quantum is an ordered subset of "YMDH" (TimeQuantum.Valid)."""
    if q and (not all(c in VALID_UNITS for c in q)
              or [c for c in VALID_UNITS if c in q] != list(q)):
        raise ValueError(f"invalid time quantum: {q!r}")


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    return f"{name}_{t.strftime(_FORMATS[unit])}"


def views_by_time(name: str, t: datetime, quantum: str) -> list[str]:
    """Every view a write at `t` lands in: one per quantum unit."""
    return [view_by_time_unit(name, t, u) for u in quantum]


def _floor(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(month=1, day=1, hour=0, minute=0, second=0,
                         microsecond=0)
    if unit == "M":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "D":
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def _next(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(year=t.year + 1)
    if unit == "M":
        return t.replace(year=t.year + (t.month == 12), month=t.month % 12 + 1)
    if unit == "D":
        return t + timedelta(days=1)
    return t + timedelta(hours=1)


def views_by_time_range(name: str, start: datetime, end: datetime,
                        quantum: str) -> list[str]:
    """The minimal set of views exactly covering [start, end): the largest
    unit over the aligned interior, the smaller units recursively at the
    ragged edges (viewsByTimeRange, time.go:86-130). Empty for an empty
    or reversed range."""
    validate_quantum(quantum)
    if not quantum or start >= end:
        return []

    def cover(lo: datetime, hi: datetime, units: str) -> list[str]:
        if lo >= hi or not units:
            return []
        u, rest = units[0], units[1:]
        first = _floor(lo, u)
        if first < lo:
            first = _next(first, u)
        last = _floor(hi, u)
        if first >= last:
            # no whole u-aligned span inside: the smaller units cover it
            return cover(lo, hi, rest)
        out = cover(lo, first, rest)
        t = first
        while t < last:
            out.append(view_by_time_unit(name, t, u))
            t = _next(t, u)
        out.extend(cover(last, hi, rest))
        return out

    return cover(start, end, quantum)
