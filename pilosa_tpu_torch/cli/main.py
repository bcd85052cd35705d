"""`python -m pilosa_tpu_torch.cli server --config <toml> [--data-dir DIR]
[--bind HOST:PORT] [--join] [--log-format plain|json] [--verbose]`: run
one node of the port. `python -m pilosa_tpu_torch.cli timeline [--host
URI] [--limit N] [--type T] [--node ID] [--json]`: the merged cluster
timeline.

Trimmed port of pilosa_tpu/cli/main.py (cmd_server, :127-276): the
configuration is the JAX package's TOML and PILOSA_TPU_* environment
(cli/config.py), --data-dir and --bind win over both. The node runs on
the card unless [mesh] platform = "cpu"; on the card the kernel library
is built (or loaded) before the node listens, so a build failure stops
the start and no query pays for it. --join adds the node to a running
cluster whose nodes [cluster] hosts names (a resize job moves its shards
to it); [gossip] makes SWIM gossip the failure detector. --log-format
and --verbose win over the file's log-format and verbose. SIGTERM or
SIGINT drains the node (Server.drain: shed, tell the peers, wait out
in-flight work, persist), then closes it and exits 0; a second signal
cuts the drain short (:249-265).

`timeline` (cmd_timeline, render_timeline: :97-110, :451-516) fetches GET
/cluster/events from --host and prints one line an event in merged HLC
order (a logical tie-break as "+N" after the time, a health transition
called out with its from and to scores), or with --json the document.

The JAX CLI's other subcommands (import, export, inspect, check, config,
generate-config, advise, profile-capture) are not ported yet.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import signal
import sys
import threading
import urllib.request

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.cli.config import load_config
from pilosa_tpu_torch.net.uri import URI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pilosa-tpu-torch",
                                description="the PyTorch/CUDA bitmap index")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("server", help="run a node")
    sp.add_argument("--config", help="TOML config file")
    sp.add_argument("--data-dir", help="data directory")
    sp.add_argument("--bind", help="host:port to listen on")
    sp.add_argument("--join", action="store_true",
                    help="join a running cluster through the [cluster] "
                         "hosts (the coordinator runs a resize job)")
    sp.add_argument("--log-format", choices=["plain", "json"],
                    help="log line format; json carries the trace id as a "
                         "field")
    sp.add_argument("--verbose", action="store_true",
                    help="write debug lines too")
    tl = sub.add_parser("timeline", help="fetch the merged cluster event "
                                         "timeline (GET /cluster/events) "
                                         "and print it")
    tl.add_argument("--host", default="http://localhost:10101")
    tl.add_argument("--limit", type=int, default=0,
                    help="the newest N events only (0: all retained)")
    tl.add_argument("--type", dest="etype",
                    help="only events of this registered type")
    tl.add_argument("--node", help="only events recorded by this node id")
    tl.add_argument("--json", action="store_true", dest="as_json",
                    help="print the merged document instead")
    return p


def _gossip_config(g: dict):
    """The SWIM clock of the [gossip] section."""
    from pilosa_tpu_torch.parallel.gossip import GossipConfig
    return GossipConfig(period=g["period"], probe_timeout=g["probe_timeout"],
                        push_pull_interval=g["push_pull_interval"])


def server_kwargs(cfg) -> dict:
    """Server's keyword arguments from a loaded config (all but the data
    dir and --join)."""
    c, q = cfg.values["cluster"], cfg.values["query"]
    ae, g = cfg.values["anti_entropy"], cfg.values["gossip"]
    m, ing = cfg.values["metric"], cfg.values["ingest"]
    return dict(
        host=cfg.host, port=cfg.port, device=cfg.device,
        cluster_hosts=(None if c["disabled"] else
                       [URI.parse(h).normalize() for h in c["hosts"]]),
        replica_n=c["replicas"],
        membership_interval=c["membership_interval"],
        query_timeout=c["query_timeout"],
        long_query_time=c["long_query_time"],
        fanout_pool_size=c["fanout_pool_size"],
        fanout_coalesce_window=c["fanout_coalesce_window"],
        fanout_coalesce_max_batch=c["fanout_coalesce_max_batch"],
        hedge_delay=c["hedge_delay"],
        ici_serving=c["ici_serving"],
        liveness_threshold=c["liveness_threshold"],
        probe_timeout=c["probe_timeout"],
        hint_max_bytes=c["hint_max_bytes"],
        hint_max_age=c["hint_max_age"],
        drain_timeout=c["drain_timeout"],
        query_history_size=c["query_history_size"],
        gossip_port=g["port"] if g["port"] >= 0 else None,
        gossip_seeds=g["seeds"], gossip_config=_gossip_config(g),
        gossip_secret=g["secret"],
        anti_entropy_interval=ae["interval"],
        anti_entropy_jitter=ae["jitter"],
        anti_entropy_pace=ae["pace"],
        anti_entropy_max_blocks=ae["max_blocks"],
        plan=q["plan"], plan_cache_bytes=q["plan_cache_bytes"],
        sparse_threshold=q["sparse_threshold"],
        run_threshold=q["run_threshold"],
        eviction=cfg.get("storage", "eviction"),
        wal_fsync=cfg.get("storage", "wal_fsync"),
        max_writes_per_request=cfg.get("", "max_writes_per_request"),
        ingest_batch_window=ing["batch_window"],
        ingest_max_batch=ing["max_batch"],
        telemetry_interval=m["telemetry_interval"],
        telemetry_ring=m["telemetry_ring"],
        usage_max_principals=m["usage_max_principals"],
        usage_ring=m["usage_ring"],
        events_ring=m["events_ring"], events_spool=m["events_spool"],
        metric_service=m["service"], metric_host=m["host"],
        profile_mode=c["profile"],
        log_path=cfg.get("", "log_path"),
        log_format=cfg.get("", "log_format"),
        verbose=cfg.get("", "verbose"),
        # Server's qos_<key> and slo_<key> are the sections' keys
        **{f"qos_{k}": v for k, v in cfg.values["qos"].items()},
        **{f"slo_{k}": v for k, v in cfg.values["slo"].items()})


def cmd_server(args) -> int:
    try:
        cfg = load_config(args.config)
    except (OSError, ValueError) as e:
        raise SystemExit(f"error: loading config: {e}")
    if args.data_dir:
        cfg.values[""]["data_dir"] = args.data_dir
    if args.bind:
        cfg.values[""]["bind"] = args.bind
    if args.log_format:
        cfg.values[""]["log_format"] = args.log_format
    if args.verbose:
        cfg.values[""]["verbose"] = True
    from pilosa_tpu_torch.server import Server

    if cfg.device == "cuda":
        from pilosa_tpu_torch.ops import _build
        _build.load()
    data_dir = os.path.expanduser(cfg.get("", "data_dir"))
    server = Server(data_dir, join=args.join, **server_kwargs(cfg)).open()
    print(f"pilosa-tpu-torch {__version__} serving at {server.uri} "
          f"(data: {data_dir}, node: {server.node_id}, device: "
          f"{server.executor.runner.device})", flush=True)
    stop = threading.Event()
    signals_seen = []

    def on_signal(signum, _frame):
        signals_seen.append(signum)
        if len(signals_seen) > 1:
            server._drain_abort.set()  # the second signal: stop now
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        stop.wait()
        if not server._drain_abort.is_set():
            print("draining (send another signal to skip)...", flush=True)
            server.drain()
    finally:
        server.close()
    return 0


def render_timeline(doc: dict, node: "str | None" = None,
                    etype: "str | None" = None) -> str:
    """A /cluster/events document as lines for a terminal, in merged HLC
    order: the local time of the stamp's physical half (+N: its logical
    half), a short node id, the type and the event's own fields; a
    health.transition is called out with its from and to scores."""
    lines = []
    nodes = {n["id"]: n for n in doc.get("nodes", [])}
    legacy = sorted(i for i, n in nodes.items()
                    if n.get("status") == "legacy")
    events = doc.get("events", [])
    if node:
        events = [e for e in events if e.get("node") == node]
    if etype:
        events = [e for e in events if e.get("type") == etype]
    skip = {"hlc", "ts", "type", "node", "seq"}
    for e in events:
        hlc = e.get("hlc") or [0, 0]
        try:
            when = datetime.datetime.fromtimestamp(
                hlc[0] / 1000.0).strftime("%H:%M:%S.%f")[:-3]
        except (OSError, OverflowError, ValueError):
            when = "??:??:??"
        stamp = f"{when}+{hlc[1]}" if hlc[1] else when
        nid = str(e.get("node", "?"))[:8]
        fields = " ".join(f"{k}={e[k]}" for k in sorted(e)
                          if k not in skip)
        if e.get("type") == "health.transition":
            arrow = (f"{e.get('fromScore', '?')} -> "
                     f"{e.get('toScore', '?')}")
            reasons = "; ".join(e.get("reasons") or [])
            lines.append(f"{stamp}  {nid}  ** HEALTH {arrow}"
                         + (f" ({reasons})" if reasons else ""))
        else:
            lines.append(f"{stamp}  {nid}  {e.get('type')}"
                         + (f"  {fields}" if fields else ""))
    head = [f"cluster timeline: {len(events)} event(s) across "
            f"{len(nodes)} node(s), HLC-merged (causal order; "
            f"+N = logical tiebreak)"]
    if legacy:
        head.append(f"note: legacy peer(s) without /debug/events "
                    f"(no events contributed): {', '.join(legacy)}")
    return "\n".join(head + [""] + lines)


def cmd_timeline(args) -> int:
    """GET /cluster/events from --host, rendered (or as JSON)."""
    url = args.host + "/cluster/events"
    if args.limit:
        url += f"?limit={args.limit}"
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            doc = json.loads(resp.read())
    except (OSError, ValueError) as e:
        raise SystemExit(f"error: fetching {url}: {e}")
    if args.as_json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(render_timeline(doc, node=args.node, etype=args.etype))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"server": cmd_server,
            "timeline": cmd_timeline}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
