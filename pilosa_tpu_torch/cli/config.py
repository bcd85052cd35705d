"""Server configuration: defaults <- TOML file <- PILOSA_TPU_* environment.

Port of pilosa_tpu/cli/config.py (:312-541): the port reads the
JAX package's TOML format and its environment overrides (PILOSA_TPU_ and
the key path with dots and dashes as underscores, as
PILOSA_TPU_CLUSTER_REPLICAS). The keys it serves:

    data-dir, bind, max-writes-per-request, log-path (the node's log
               lines are appended there instead of stderr; the JAX server
               reads the key and keeps stderr), log-format ("plain" or
               "json"), verbose (debug lines)
    [tls]      certificate, key (the listener speaks HTTPS; a pair that
               does not load stops the start), skip-verify (the internal
               client trusts any certificate)
    [cluster]  disabled, coordinator, replicas, hosts, membership-interval,
               query-timeout, long-query-time, fanout-pool-size,
               fanout-coalesce-window, fanout-coalesce-max-batch,
               hedge-delay, ici-serving, liveness-threshold,
               probe-timeout, hint-max-bytes, hint-max-age,
               drain-timeout, query-history-size, profile (off | auto |
               on; PILOSA_TPU_PROFILE=0 wins over it)
    [qos]      mode, default-priority, default-deadline, queries-per-s,
               device-ms-per-s, bytes-per-s, burst, max-principals, and
               [qos.principals."<principal>"] tables of the quota keys
               and priority (validated by qos.QosPlane, with the JAX
               messages)
    [slo]      read-, count-, topn- and groupby-latency-ms,
               latency-target, availability-target, burn-yellow,
               burn-red, window-short, window-long
    [ingest]   batch-window, max-batch
    [gossip]   port (-1, the default: HTTP probing; 0: an ephemeral
               port), seeds, period, probe-timeout, push-pull-interval,
               secret (AES-GCM on every datagram)
    [anti-entropy] interval, jitter, pace, max-blocks
    [query]    plan, plan-cache-bytes, sparse-threshold, run-threshold
    [storage]  eviction, wal-fsync
    [metric]   poll-interval (the runtime monitor's gauges),
               telemetry-interval, telemetry-ring, usage-max-principals,
               usage-ring, events-ring, events-spool (the event journal's
               ring and durable spool, utils/events.py), service
               ("expvar", "statsd" or any other value: none), host
               (the StatsD agent, utils/stats.py new_stats_client),
               trace-export (off | file | http), trace-export-path (the
               spool; <data-dir>/trace-spool.jsonl by default),
               trace-export-endpoint, trace-export-format (jaeger |
               otlp) and trace-export-sample (utils/tracing.py
               TraceExporter; bad values are refused by the server with
               the JAX texts)
    [diagnostics] url, interval (the phone-home document; off unless
               both are set)
    [tracing]  sampler-type (off | const | probabilistic),
               sampler-param, agent-host-port (the SpanExporter's
               endpoint, "host:port" or a URL)
    [mesh]     platform ("cpu" runs the node on the CPU; "", the default,
               on the card), devices ("auto", "none" or 1: one device)

The other keys the JAX package knows ([mesh] host-devices and replicas,
which belong to several devices) must keep their defaults: set away
from them, in the file or the environment, they fail the start with
NotPortedError naming the key.
A key neither package knows fails too. Durations may be written as Go
durations ("250ms", "1h30m") where the default is a number of seconds.
An environment name the table does not hold (the port's
PILOSA_TPU_TORCH_* switches, the JAX package's PILOSA_TPU_QOS=0) is left
to whoever reads it. Nothing here needs a TOML package beyond the
standard library's tomllib. to_toml() prints the configuration as the
JAX package's Config.to_toml does, line for line (the `config` and
`generate-config` subcommands).
"""

from __future__ import annotations

import copy
import os
import tomllib

from pilosa_tpu_torch.models.field import NotPortedError
from pilosa_tpu_torch.utils.duration import parse_duration

# section -> key -> default, every key of the JAX package's Config ("" is
# the top level); keys are written with underscores
DEFAULTS: dict[str, dict] = {
    "": {"data_dir": "~/.pilosa-tpu", "bind": "localhost:10101",
         "max_writes_per_request": 5000, "log_path": "",
         "log_format": "plain", "verbose": False},
    "tls": {"certificate": "", "key": "", "skip_verify": False},
    "cluster": {"disabled": True, "coordinator": False, "replicas": 1,
                "hosts": [], "long_query_time": 0.0, "query_timeout": 0.0,
                "liveness_threshold": 3, "probe_timeout": 2.0,
                "membership_interval": 5.0, "fanout_pool_size": 32,
                "fanout_coalesce_window": 0.002,
                "fanout_coalesce_max_batch": 64, "hedge_delay": 0.0,
                "ici_serving": "auto", "profile": "auto",
                "query_history_size": 100,
                "hint_max_bytes": 64 * 1024 * 1024, "hint_max_age": 3600.0,
                "drain_timeout": 30.0},
    "query": {"plan": "on", "plan_cache_bytes": 256 * 1024 * 1024,
              "sparse_threshold": 4096, "run_threshold": 2048},
    "qos": {"mode": "off", "default_priority": "interactive",
            "default_deadline": 0.0, "queries_per_s": 0.0,
            "device_ms_per_s": 0.0, "bytes_per_s": 0.0, "burst": 2.0,
            "max_principals": 256, "principals": {}},
    "slo": {"read_latency_ms": 0.0, "count_latency_ms": 0.0,
            "topn_latency_ms": 0.0, "groupby_latency_ms": 0.0,
            "latency_target": 0.99, "availability_target": 0.999,
            "burn_yellow": 6.0, "burn_red": 14.4, "window_short": 300.0,
            "window_long": 3600.0},
    "storage": {"wal_fsync": "off", "eviction": "lru"},
    "ingest": {"batch_window": 0.0, "max_batch": 4096},
    "anti_entropy": {"interval": 0.0, "jitter": 0.25, "pace": 0.0,
                     "max_blocks": 0},
    "metric": {"service": "expvar", "host": "127.0.0.1:8125",
               "poll_interval": 0.0, "telemetry_interval": 5.0,
               "telemetry_ring": 720, "usage_max_principals": 256,
               "usage_ring": 360, "trace_export": "off",
               "trace_export_path": "", "trace_export_endpoint": "",
               "trace_export_format": "jaeger", "trace_export_sample": 1.0,
               "events_ring": 2048, "events_spool": 0},
    "diagnostics": {"url": "", "interval": 0.0},
    "tracing": {"sampler_type": "off", "sampler_param": 0.0,
                "agent_host_port": ""},
    "mesh": {"devices": "auto", "platform": "", "host_devices": 0,
             "replicas": 1},
    "gossip": {"port": -1, "seeds": [], "period": 1.0, "probe_timeout": 0.5,
               "push_pull_interval": 10.0, "secret": ""},
}

# the keys the port serves
PORTED = {
    "": {"data_dir", "bind", "max_writes_per_request", "log_path",
         "log_format", "verbose"},
    "tls": {"certificate", "key", "skip_verify"},
    "diagnostics": {"url", "interval"},
    "cluster": {"disabled", "coordinator", "replicas", "hosts",
                "long_query_time", "query_timeout", "membership_interval",
                "fanout_pool_size", "fanout_coalesce_window",
                "fanout_coalesce_max_batch", "hedge_delay", "ici_serving",
                "liveness_threshold", "probe_timeout", "hint_max_bytes",
                "hint_max_age", "drain_timeout", "query_history_size",
                "profile"},
    "qos": set(DEFAULTS["qos"]),
    "slo": set(DEFAULTS["slo"]),
    "ingest": {"batch_window", "max_batch"},
    "anti_entropy": {"interval", "jitter", "pace", "max_blocks"},
    "query": {"plan", "plan_cache_bytes", "sparse_threshold",
              "run_threshold"},
    "storage": {"eviction", "wal_fsync"},
    "metric": {"poll_interval", "telemetry_interval", "telemetry_ring",
               "usage_max_principals", "usage_ring", "events_ring",
               "events_spool", "service", "host", "trace_export",
               "trace_export_path", "trace_export_endpoint",
               "trace_export_format", "trace_export_sample"},
    "tracing": {"sampler_type", "sampler_param", "agent_host_port"},
    "mesh": {"devices", "platform"},
    "gossip": {"port", "seeds", "period", "probe_timeout",
               "push_pull_interval", "secret"},
}


def _dashed(section: str, key: str) -> str:
    name = key.replace("_", "-")
    return f"[{section.replace('_', '-')}] {name}" if section else name


class Config:
    """The merged configuration: `values[section][key]`."""

    def __init__(self):
        self.values = copy.deepcopy(DEFAULTS)

    def get(self, section: str, key: str):
        return self.values[section][key]

    def to_toml(self) -> str:
        return to_toml(self)

    @property
    def host(self) -> str:
        return self.values[""]["bind"].rsplit(":", 1)[0] or "localhost"

    @property
    def port(self) -> int:
        tail = self.values[""]["bind"].rsplit(":", 1)
        return int(tail[1]) if len(tail) == 2 and tail[1] else 10101

    @property
    def device(self) -> str:
        """The node's device: "cpu" only where [mesh] platform asks."""
        return "cpu" if self.values["mesh"]["platform"] == "cpu" else "cuda"

    # -- merge layers -------------------------------------------------------

    def _set(self, section: str, key: str, value, where: str) -> None:
        defaults = DEFAULTS.get(section)
        if defaults is None or key not in defaults:
            raise ValueError(f"unknown config key {_dashed(section, key)} "
                             f"({where})")
        if isinstance(defaults[key], float) and isinstance(value, str):
            value = parse_duration(value)
        self.values[section][key] = value

    def apply_toml(self, path: str) -> None:
        with open(path, "rb") as f:
            data = tomllib.load(f)
        for key, value in data.items():
            attr = key.replace("-", "_")
            if attr in DEFAULTS and isinstance(value, dict):
                for k, v in value.items():
                    self._set(attr, k.replace("-", "_"), v, path)
            else:
                self._set("", attr, value, path)

    def apply_env(self, environ=None) -> None:
        environ = os.environ if environ is None else environ
        prefix = "PILOSA_TPU_"
        for name, raw in environ.items():
            if not name.startswith(prefix):
                continue
            parts = name[len(prefix):].lower().split("_")
            for section in DEFAULTS:
                head = section.split("_") if section else []
                if parts[:len(head)] != head or len(parts) <= len(head):
                    continue
                key = "_".join(parts[len(head):])
                if key in DEFAULTS[section]:
                    self.values[section][key] = _coerce(
                        raw, DEFAULTS[section][key])
                    break

    def validate(self) -> None:
        """Fail on every key this port does not serve that is set away
        from its default, and on malformed served values."""
        for section, defaults in DEFAULTS.items():
            served = PORTED.get(section, set())
            for key, default in defaults.items():
                if key in served:
                    continue
                if self.values[section][key] != default:
                    raise NotPortedError(
                        f"config key {_dashed(section, key)} = "
                        f"{self.values[section][key]!r} is not ported yet "
                        f"(its default is {default!r})")
        mesh = self.values["mesh"]
        if mesh["platform"] not in ("", "cpu"):
            raise ValueError(f"invalid [mesh] platform {mesh['platform']!r}"
                             " (expected \"\" for the card or \"cpu\")")
        if str(mesh["devices"]) not in ("auto", "none", "1"):
            raise NotPortedError(
                f"config key [mesh] devices = {mesh['devices']!r} is not "
                "ported yet (a node drives one device)")


# the JAX package's to_toml, section by section and key by key
TOML_ORDER: list[tuple[str, tuple[str, ...]]] = [
    ("", ("data_dir", "bind", "max_writes_per_request", "log_path",
          "log_format", "verbose")),
    ("tls", ("certificate", "key", "skip_verify")),
    ("cluster", ("disabled", "coordinator", "replicas", "hosts",
                 "long_query_time", "query_timeout", "liveness_threshold",
                 "probe_timeout", "membership_interval", "fanout_pool_size",
                 "fanout_coalesce_window", "fanout_coalesce_max_batch",
                 "hedge_delay", "ici_serving", "profile",
                 "query_history_size", "hint_max_bytes", "hint_max_age",
                 "drain_timeout")),
    ("query", ("plan", "plan_cache_bytes", "sparse_threshold",
               "run_threshold")),
    ("qos", ("mode", "default_priority", "default_deadline",
             "queries_per_s", "device_ms_per_s", "bytes_per_s", "burst",
             "max_principals")),
    ("slo", ("read_latency_ms", "count_latency_ms", "topn_latency_ms",
             "groupby_latency_ms", "latency_target", "availability_target",
             "burn_yellow", "burn_red", "window_short", "window_long")),
    ("storage", ("wal_fsync", "eviction")),
    ("ingest", ("batch_window", "max_batch")),
    ("anti_entropy", ("interval", "jitter", "pace", "max_blocks")),
    ("metric", ("service", "host", "poll_interval", "telemetry_interval",
                "telemetry_ring", "usage_max_principals", "usage_ring",
                "trace_export", "trace_export_path", "trace_export_endpoint",
                "trace_export_format", "trace_export_sample", "events_ring",
                "events_spool")),
    ("diagnostics", ("url", "interval")),
    ("tracing", ("sampler_type", "sampler_param", "agent_host_port")),
    ("gossip", ("port", "seeds", "period", "probe_timeout",
                "push_pull_interval", "secret")),
    ("mesh", ("devices", "platform", "host_devices", "replicas")),
]


def _toml_value(default, value) -> str:
    """A value as the JAX to_toml writes it: by the key's default type."""
    if isinstance(default, bool):
        return str(value).lower()
    if isinstance(default, str):
        return f'"{value}"'
    if isinstance(default, list):
        return f"[{', '.join(repr(h) for h in value)}]"
    return str(value)


def to_toml(cfg: "Config") -> str:
    """The configuration as TOML, line for line the JAX Config.to_toml
    (pilosa_tpu/cli/config.py:397-527)."""
    lines: list[str] = []
    for section, keys in TOML_ORDER:
        if section:
            lines += ["", f"[{section.replace('_', '-')}]"]
        vals = cfg.values[section]
        for key in keys:
            lines.append(f"{key.replace('_', '-')} = "
                         + _toml_value(DEFAULTS[section][key], vals[key]))
        if section == "qos":
            for pname, over in vals["principals"].items():
                lines += ["", f'[qos.principals."{pname}"]']
                lines += [f"{str(k).replace('_', '-')} = "
                          + (f'"{v}"' if isinstance(v, str) else str(v))
                          for k, v in over.items()]
    return "\n".join(lines) + "\n"


def _coerce(raw: str, current):
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return parse_duration(raw)
    if isinstance(current, list):
        return [s for s in raw.split(",") if s]
    if isinstance(current, dict):
        raise ValueError(f"a table cannot be set from the environment: "
                         f"{raw!r}")
    return raw


def load_config(config_path=None, environ=None) -> Config:
    cfg = Config()
    if config_path:
        cfg.apply_toml(config_path)
    cfg.apply_env(environ)
    cfg.validate()
    return cfg
