"""Stats: the StatsClient interface, its in-memory and statsd forms, and
the Prometheus text renderer behind GET /metrics.

Copy of pilosa_tpu/utils/stats.py (the reference's stats/stats.go:31-67
surface: Count/Gauge/Histogram/Set/Timing with tags). The exposition text
is byte-identical to the JAX package's renderer for the same snapshot
(tests/test_torch_obs.py holds the two against each other).
"""

from __future__ import annotations

import math
import threading
from typing import Optional


def _pow2_bucket(value: float) -> str:
    """Log2 histogram bucket label: the smallest power-of-two upper bound
    for `value` (unit = whatever the caller reports in; fan-out latencies
    report milliseconds). Negative/zero values collapse into "le0"."""
    if value <= 0:
        return "le0"
    return f"le{2.0 ** math.ceil(math.log2(value)):g}"


class StatsClient:
    """In-memory stats (the Expvar impl, stats/stats.go:24)."""

    def __init__(self, prefix: str = "", tags: Optional[list[str]] = None,
                 _store=None):
        self._prefix = prefix
        self.tags = sorted(tags or [])
        self._store = _store if _store is not None else {
            "lock": threading.Lock(), "counts": {}, "gauges": {},
            "timings": {}, "sets": {}}

    def _key(self, name: str) -> str:
        tag_part = ("," + ",".join(self.tags)) if self.tags else ""
        return f"{self._prefix}{name}{tag_part}"

    def with_tags(self, *tags: str) -> "StatsClient":
        return StatsClient(self._prefix, self.tags + list(tags), self._store)

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        with self._store["lock"]:
            k = self._key(name)
            self._store["counts"][k] = self._store["counts"].get(k, 0) + value

    def count_with_custom_tags(self, name: str, value: int, rate: float,
                               tags: list[str]) -> None:
        self.with_tags(*tags).count(name, value, rate)

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        with self._store["lock"]:
            self._store["gauges"][self._key(name)] = value

    def histogram(self, name: str, value: float, rate: float = 1.0) -> None:
        self.timing(name, value, rate)

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        with self._store["lock"]:
            self._store["sets"].setdefault(self._key(name), set()).add(value)

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        with self._store["lock"]:
            t = self._store["timings"].setdefault(
                self._key(name), {"count": 0, "sum": 0.0, "min": None,
                                  "max": None, "buckets": {}})
            t["count"] += 1
            t["sum"] += value
            t["min"] = value if t["min"] is None else min(t["min"], value)
            t["max"] = value if t["max"] is None else max(t["max"], value)
            # log2 bucket distribution: count/sum/min/max can't answer
            # "where is the tail" (the per-node fan-out latency histograms
            # hedge_delay is tuned against, docs/operations.md)
            b = _pow2_bucket(value)
            t["buckets"][b] = t["buckets"].get(b, 0) + 1

    def snapshot(self) -> dict:
        """JSON-able dump for /debug/vars."""
        with self._store["lock"]:
            return {
                "counts": dict(self._store["counts"]),
                "gauges": dict(self._store["gauges"]),
                # deep-ish copy: the nested bucket dicts keep mutating
                # under concurrent traffic after the snapshot is taken
                "timings": {k: {**v, "buckets": dict(v["buckets"])}
                            for k, v in self._store["timings"].items()},
                "sets": {k: sorted(v) for k, v in self._store["sets"].items()},
            }


class NopStatsClient:
    """stats.NopStatsClient."""

    def with_tags(self, *tags):
        return self

    def count(self, *a, **k): pass
    def count_with_custom_tags(self, *a, **k): pass
    def gauge(self, *a, **k): pass
    def histogram(self, *a, **k): pass
    def set(self, *a, **k): pass
    def timing(self, *a, **k): pass

    def snapshot(self):
        return {}


class StatsDClient:
    """UDP statsd emitter, DataDog dialect with |#tag suffixes
    (statsd/statsd.go:41-130). Sends are fire-and-forget datagrams to a
    local agent; network errors are swallowed like the reference's."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "pilosa.",
                 tags: Optional[list[str]] = None, _sock=None):
        import socket
        self.host, self.port, self.prefix = host, port, prefix
        self.tags = sorted(tags or [])
        self._sock = _sock or socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def with_tags(self, *tags: str) -> "StatsDClient":
        return StatsDClient(self.host, self.port, self.prefix,
                            self.tags + list(tags), self._sock)

    def _send(self, name: str, value, kind: str, rate: float,
              tags: Optional[list[str]] = None) -> None:
        if rate < 1.0:
            # client-side sampling: drop (1-rate) of events; the aggregator
            # scales received values back up by 1/rate via the @ suffix
            import random
            if random.random() > rate:
                return
        msg = f"{self.prefix}{name}:{value}|{kind}"
        if rate < 1.0:
            msg += f"|@{rate}"
        all_tags = self.tags + (tags or [])
        if all_tags:
            msg += "|#" + ",".join(all_tags)
        try:
            self._sock.sendto(msg.encode(), (self.host, self.port))
        except OSError:
            pass

    def count(self, name, value=1, rate=1.0):
        self._send(name, value, "c", rate)

    def count_with_custom_tags(self, name, value, rate, tags):
        self._send(name, value, "c", rate, tags)

    def gauge(self, name, value, rate=1.0):
        self._send(name, value, "g", rate)

    def histogram(self, name, value, rate=1.0):
        self._send(name, value, "h", rate)

    def set(self, name, value, rate=1.0):
        self._send(name, value, "s", rate)

    def timing(self, name, value, rate=1.0):
        self._send(name, value, "ms", rate)

    def snapshot(self):
        return {}

    def close(self):
        self._sock.close()


_NAME_SANITIZE = None  # compiled lazily (module import stays cheap)


def _prom_name(raw: str) -> str:
    """Legal Prometheus metric-name fragment: [a-zA-Z_:][a-zA-Z0-9_:]*.
    Illegal runs collapse to "_"; a leading digit gets a "_" prefix."""
    global _NAME_SANITIZE
    if _NAME_SANITIZE is None:
        import re
        _NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]+")
    out = _NAME_SANITIZE.sub("_", raw)
    if not out:
        return "_"
    if out[0].isdigit():
        out = "_" + out
    return out


def _prom_escape(val: str) -> str:
    """Label-value escaping per the text exposition format."""
    return val.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _split_key(key: str) -> tuple[str, str]:
    """Stats key -> (family name, label string).

    StatsClient keys are "<name>[,tag,...]" with "/"-namespaced names
    ("query/Count", "fanoutLatency/<node-id>"). The first "/" segment
    becomes the family; the remainder rides a `key` label, and each tag
    becomes `tag="t"` (or `k="v"` for colon-form tags) — so per-node /
    per-call cardinality lives in labels, not in metric-name explosion."""
    base, _, tag_part = key.partition(",")
    labels = []
    bare: list[str] = []
    if "/" in base:
        family, _, rest = base.partition("/")
        labels.append(f'key="{_prom_escape(rest)}"')
    else:
        family = base
    for tag in [t for t in tag_part.split(",") if t]:
        k, sep, v = tag.partition(":")
        if sep:
            labels.append(f'{_prom_name(k)}="{_prom_escape(v)}"')
        else:
            bare.append(tag)
    if bare:
        # ONE `tag` label holding all bare tags: repeating a label name
        # ({tag="a",tag="b"}) is illegal in the exposition format
        labels.append(f'tag="{_prom_escape(",".join(bare))}"')
    return _prom_name(family), ("{" + ",".join(labels) + "}") if labels else ""


def _bucket_bound(label: str) -> float:
    """Inverse of _pow2_bucket: "le512" -> 512.0, "le0.25" -> 0.25,
    "le0" -> 0.0 (the non-positive catch-all)."""
    return float(label[2:])


def prometheus_exposition(snapshot: dict, prefix: str = "pilosa_") -> str:
    """Render a StatsClient snapshot() as Prometheus text exposition
    (version 0.0.4): counts -> counters (`_total`), gauges -> gauges,
    sets -> `_cardinality` gauges, and the log2 `timings` buckets ->
    proper cumulative histograms (`_bucket{le=...}` + `_sum` + `_count`).
    Families group across keys so every `# TYPE` line appears once.
    Conformance (legal names, non-decreasing cumulative buckets,
    `_count` == the `+Inf` bucket) is pinned by the tier-1 test in
    tests/test_metrics_conformance.py."""
    out: list[str] = []
    seen_types: set[str] = set()

    def emit(family: str, kind: str, samples: list[tuple[str, str, float]]):
        # samples: (suffix, labels, value)
        if family not in seen_types:
            out.append(f"# TYPE {family} {kind}")
            seen_types.add(family)
        for suffix, labels, value in samples:
            if value == int(value):
                out.append(f"{family}{suffix}{labels} {int(value)}")
            else:
                out.append(f"{family}{suffix}{labels} {value}")

    by_family: dict = {}
    for key, value in sorted(snapshot.get("counts", {}).items()):
        fam, labels = _split_key(key)
        by_family.setdefault(prefix + fam + "_total", []).append(
            ("", labels, float(value)))
    for fam, samples in by_family.items():
        emit(fam, "counter", samples)

    by_family = {}
    for key, value in sorted(snapshot.get("gauges", {}).items()):
        fam, labels = _split_key(key)
        by_family.setdefault(prefix + fam, []).append(
            ("", labels, float(value)))
    for fam, samples in by_family.items():
        emit(fam, "gauge", samples)

    by_family = {}
    for key, members in sorted(snapshot.get("sets", {}).items()):
        fam, labels = _split_key(key)
        by_family.setdefault(prefix + fam + "_cardinality", []).append(
            ("", labels, float(len(members))))
    for fam, samples in by_family.items():
        emit(fam, "gauge", samples)

    hist_family: dict = {}
    for key, t in sorted(snapshot.get("timings", {}).items()):
        fam, labels = _split_key(key)
        hist_family.setdefault(prefix + fam, []).append((labels, t))
    for fam, series in hist_family.items():
        samples = []
        for labels, t in series:
            base_labels = labels[1:-1] if labels else ""  # strip {}
            cum = 0
            for blabel in sorted(t.get("buckets", {}), key=_bucket_bound):
                cum += t["buckets"][blabel]
                le = f'le="{_bucket_bound(blabel):g}"'
                lb = "{" + (base_labels + "," if base_labels else "") + le + "}"
                samples.append(("_bucket", lb, float(cum)))
            inf = "{" + (base_labels + "," if base_labels else "") \
                + 'le="+Inf"}'
            samples.append(("_bucket", inf, float(t["count"])))
            samples.append(("_sum", labels, float(t["sum"])))
            samples.append(("_count", labels, float(t["count"])))
        emit(fam, "histogram", samples)

    return "\n".join(out) + ("\n" if out else "")


def new_stats_client(service: str = "expvar", host: str = "127.0.0.1:8125"):
    """metric.service selection (server/server.go:361-374):
    expvar (default, in-memory /debug/vars), statsd (UDP agent), nop."""
    if service == "statsd":
        h, _, p = host.partition(":")
        return StatsDClient(h or "127.0.0.1", int(p or 8125))
    if service == "expvar":
        return StatsClient()
    return NopStatsClient()
