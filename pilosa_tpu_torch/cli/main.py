"""The port's command line, `python -m pilosa_tpu_torch.cli <command>`:

    server           run one node: --config <toml> [--data-dir DIR]
                     [--bind HOST:PORT] [--join] [--mesh-devices N]
                     [--log-format plain|json] [--verbose]
    import           bulk-import CSV files (row,col; or col,value with
                     --field-type int) through a node's import route
    export           a field as CSV (row,col lines, shard by shard)
    inspect          a fragment file's statistics, offline (JSON)
    check            fragment files and hint logs, offline: OK or FAILED
                     per file, exit 1 when any failed
    config           the parsed configuration as TOML
    generate-config  the default configuration as TOML
    timeline         the merged cluster timeline (GET /cluster/events)
    advise           the placement advisor's dry run
    profile-capture  a device profile of a live node's traffic
                     (POST /debug/device-profile) and where it spooled

Port of pilosa_tpu/cli/main.py (:58-112, :127-276, :291-546): the same
subcommands, flags and output, the advisor's and the timeline's
renderings included. `server`: the configuration is the JAX package's
TOML and PILOSA_TPU_* environment (cli/config.py); --data-dir and --bind
win over both. The node runs on the card unless [mesh] platform =
"cpu" (or host-devices is set); [mesh] devices, replicas and
host-devices (--mesh-devices overrides devices) build its replica x
shard mesh by the JAX package's rules (build_mesh), one device when
fewer than two are named. On the card the kernel library is built (or
loaded) before the node listens, so a build failure stops the start and no query pays for
it. [tls] certificate and key make the listener speak HTTPS, and
skip-verify lets the internal client trust any certificate; [metric]
poll-interval and [diagnostics] url and interval start the runtime
monitor and the phone-home. --join adds the node to a running cluster
whose nodes [cluster] hosts names (a resize job moves its shards to it);
[gossip] makes SWIM gossip the failure detector. SIGTERM or SIGINT
drains the node (Server.drain), then closes it and exits 0; a second
signal cuts the drain short (:249-265).

`check` validates a hint log (a `.hints` file, or one whose first byte
is the hint frame's magic) by its framing and anything else as a
fragment file (its snapshot trailer, its op-log and every container);
`inspect` parses a fragment file and prints its bits, containers by
kind, op count and extremes. Both print what the JAX commands print for
the same files. `profile-capture` reports "ok" with the capture's
directory; a port node's capture is a torch.profiler chrome trace (the
JAX node's an XLA profile for TensorBoard).
"""

from __future__ import annotations

import argparse
import csv
import datetime
import json
import os
import signal
import sys
import threading
import urllib.error
import urllib.request

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.cli.config import Config, load_config
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
    sp.add_argument("--mesh-devices",
                    help="device mesh: auto (all local devices when >1), "
                         "none, or an integer count")
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
    ap = sub.add_parser(
        "advise", help="fetch the fragment heat map and print the "
                       "placement advisor's dry-run recommendations")
    ap.add_argument("--host", default="http://localhost:10101")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the raw advice document instead of the "
                         "rendered report")

    ip = sub.add_parser("import", help="bulk-import CSV (row,col or "
                                       "col,value)")
    ip.add_argument("--host", default="http://localhost:10101")
    ip.add_argument("--index", required=True)
    ip.add_argument("--field", required=True)
    ip.add_argument("--field-type", default="set", choices=["set", "int"])
    ip.add_argument("--create", action="store_true",
                    help="create the index and field if missing")
    ip.add_argument("--batch-size", type=int, default=100000)
    ip.add_argument("--clear", action="store_true",
                    help="clear the imported bits instead of setting them")
    ip.add_argument("--min", type=int, default=0)
    ip.add_argument("--max", type=int, default=0)
    ip.add_argument("files", nargs="+")

    ep = sub.add_parser("export", help="export a field as CSV")
    ep.add_argument("--host", default="http://localhost:10101")
    ep.add_argument("--index", required=True)
    ep.add_argument("--field", required=True)
    ep.add_argument("-o", "--output", help="output file (default stdout)")

    np_ = sub.add_parser("inspect", help="dump fragment file stats offline")
    np_.add_argument("path")

    cp = sub.add_parser("check", help="integrity-check fragment files and "
                                      "hint logs offline")
    cp.add_argument("paths", nargs="+")

    cfgp = sub.add_parser("config", help="print the parsed config")
    cfgp.add_argument("--config", help="TOML config file")

    sub.add_parser("generate-config", help="print the default TOML config")

    pcap = sub.add_parser(
        "profile-capture", help="capture a device profile on a live node "
                                "(POST /debug/device-profile) and print "
                                "the spool path")
    pcap.add_argument("--host", default="http://localhost:10101")
    pcap.add_argument("--seconds", type=float, default=2.0,
                      help="trace window length (clamped by the node)")
    pcap.add_argument("--json", action="store_true", dest="as_json",
                      help="print the raw capture document")
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
        trace_export=m["trace_export"],
        trace_export_path=m["trace_export_path"],
        trace_export_endpoint=m["trace_export_endpoint"],
        trace_export_format=m["trace_export_format"],
        trace_export_sample=m["trace_export_sample"],
        tracing_sampler_type=cfg.get("tracing", "sampler_type"),
        tracing_sampler_param=cfg.get("tracing", "sampler_param"),
        tracing_endpoint=cfg.get("tracing", "agent_host_port"),
        tls_certificate=cfg.get("tls", "certificate"),
        tls_key=cfg.get("tls", "key"),
        tls_skip_verify=cfg.get("tls", "skip_verify"),
        metric_poll_interval=m["poll_interval"],
        diagnostics_url=cfg.get("diagnostics", "url"),
        diagnostics_interval=cfg.get("diagnostics", "interval"),
        profile_mode=c["profile"],
        log_path=cfg.get("", "log_path"),
        log_format=cfg.get("", "log_format"),
        verbose=cfg.get("", "verbose"),
        # Server's qos_<key> and slo_<key> are the sections' keys
        **{f"qos_{k}": v for k, v in cfg.values["qos"].items()},
        **{f"slo_{k}": v for k, v in cfg.values["slo"].items()})


def build_mesh(cfg):
    """The node's mesh from the [mesh] keys (JAX cli/main.py:155-167): None
    for one device; a bad value stops the start with the JAX text."""
    from pilosa_tpu_torch.parallel.mesh import mesh_from_config

    m = cfg.values["mesh"]
    try:
        return mesh_from_config(devices=str(m["devices"]),
                                platform=m["platform"],
                                host_devices=m["host_devices"],
                                replicas=m["replicas"])
    except ValueError as e:
        raise SystemExit(f"error: building device mesh: {e}")


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
    if args.mesh_devices:
        cfg.values["mesh"]["devices"] = args.mesh_devices
    from pilosa_tpu_torch.server import Server

    mesh = build_mesh(cfg)

    if cfg.device == "cuda":
        from pilosa_tpu_torch.ops import _build
        _build.load()
    data_dir = os.path.expanduser(cfg.get("", "data_dir"))
    server = Server(data_dir, join=args.join, mesh=mesh,
                    **server_kwargs(cfg)).open()
    runner = server.executor.runner
    where = (runner.device if runner.mesh is None
             else f"{runner.device}, mesh {runner.mesh.shape}")
    print(f"pilosa-tpu-torch {__version__} serving at {server.uri} "
          f"(data: {data_dir}, node: {server.node_id}, device: "
          f"{where})", flush=True)
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


def cmd_advise(args) -> int:
    """GET /debug/heat?advice=true&top=0 from --host: the advice,
    rendered (or as JSON)."""
    from pilosa_tpu_torch.analysis.advisor import render_advice

    url = args.host + "/debug/heat?advice=true&top=0"
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            doc = json.loads(resp.read())
    except (OSError, ValueError) as e:
        raise SystemExit(f"error: fetching {url}: {e}")
    if not doc.get("enabled", False) and not doc.get("trackedFragments"):
        print("heat tracking is disabled or has no data yet "
              "(PILOSA_TPU_TORCH_HEAT=0, or no traffic)")
        return 1
    advice = doc.get("advice") or {}
    if args.as_json:
        print(json.dumps(advice, indent=2, sort_keys=True))
    else:
        print(render_advice(advice))
    return 0


def _post(host: str, path: str, payload=None) -> dict:
    body = json.dumps(payload or {}).encode()
    req = urllib.request.Request(host + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = resp.read()
            return json.loads(out) if out else {}
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        raise SystemExit(f"error: {path}: {e.code}: {detail}")


def _post_tolerant(host: str, path: str, payload=None) -> None:
    """POST that takes a 409 (it exists) as done."""
    req = urllib.request.Request(host + path,
                                 data=json.dumps(payload or {}).encode(),
                                 method="POST")
    try:
        urllib.request.urlopen(req, timeout=60).read()
    except urllib.error.HTTPError as e:
        if e.code != 409:
            raise SystemExit(f"error: {path}: {e.code}: "
                             f"{e.read().decode(errors='replace')}")


def cmd_import(args) -> int:
    """CSV rows (row,col; col,value for an int field) posted to the
    field's import route in batches of --batch-size (:298-337)."""
    if args.create:
        _post_tolerant(args.host, f"/index/{args.index}")
        opts = {"options": {"type": args.field_type}}
        if args.field_type == "int":
            opts["options"].update(min=args.min, max=args.max)
        _post_tolerant(args.host, f"/index/{args.index}/field/{args.field}",
                       opts)
    total = 0
    batch_a, batch_b = [], []

    def flush():
        nonlocal total
        if not batch_a:
            return
        if args.field_type == "int":
            payload = {"columnIDs": batch_a, "values": batch_b}
        else:
            payload = {"rowIDs": batch_a, "columnIDs": batch_b}
            if args.clear:
                payload["clear"] = True
        _post(args.host, f"/index/{args.index}/field/{args.field}/import",
              payload)
        total += len(batch_a)
        batch_a.clear()
        batch_b.clear()

    for fname in args.files:
        fh = sys.stdin if fname == "-" else open(fname)
        with fh:
            for rowno, row in enumerate(csv.reader(fh), 1):
                if not row:
                    continue
                if len(row) < 2:
                    raise SystemExit(
                        f"error: {fname}:{rowno}: expected 2+ columns")
                batch_a.append(int(row[0]))
                batch_b.append(int(row[1]))
                if len(batch_a) >= args.batch_size:
                    flush()
    flush()
    print(f"imported {total} records into {args.index}/{args.field}")
    return 0


def cmd_export(args) -> int:
    """Every shard of the field through GET /export, as CSV (:352-366)."""
    with urllib.request.urlopen(args.host + "/internal/shards/max",
                                timeout=60) as resp:
        max_shards = json.loads(resp.read())["standard"]
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for shard in range(max_shards.get(args.index, 0) + 1):
            url = (f"{args.host}/export?index={args.index}"
                   f"&field={args.field}&shard={shard}")
            with urllib.request.urlopen(url, timeout=60) as resp:
                out.write(resp.read().decode())
    finally:
        if args.output:
            out.close()
    return 0


def cmd_inspect(args) -> int:
    """A fragment file's statistics as JSON (:369-388)."""
    from pilosa_tpu_torch.storage.roaring import Bitmap

    with open(args.path, "rb") as f:
        data = f.read()
    b = Bitmap.from_bytes(data)
    kinds: dict = {}
    for c in b.containers.values():
        kinds[c.kind] = kinds.get(c.kind, 0) + 1
    print(json.dumps({
        "path": args.path,
        "bytes": len(data),
        "bits": b.count(),
        "containers": len(b.containers),
        "containerKinds": kinds,
        "opN": b.op_n,
        "min": b.min(),
        "max": b.max(),
    }, indent=2))
    return 0


def cmd_check(args) -> int:
    """OK or FAILED per file; exit 1 when any failed (:391-425)."""
    from pilosa_tpu_torch.storage.hints import HINT_MAGIC, verify_hint_log
    from pilosa_tpu_torch.storage.roaring import Bitmap

    failed = 0
    for path in args.paths:
        try:
            with open(path, "rb") as f:
                lead = f.read(1)
            if path.endswith(".hints") or (lead and lead[0] == HINT_MAGIC):
                rep = verify_hint_log(path)
                if rep["error"]:
                    failed += 1
                    print(f"{path}: FAILED: hint log damaged at byte "
                          f"{rep['validBytes']}/{rep['bytes']} "
                          f"({rep['error']}); {rep['records']} valid "
                          f"record(s) precede the damage")
                else:
                    print(f"{path}: OK ({rep['records']} hint record(s), "
                          f"{rep['droppedMarkers']} drop marker(s))")
                continue
            with open(path, "rb") as f:
                b = Bitmap.from_bytes(f.read())
            b.check()
            print(f"{path}: OK ({b.count()} bits)")
        except (ValueError, OSError) as e:
            failed += 1
            print(f"{path}: FAILED: {e}")
    return 1 if failed else 0


def cmd_config(args) -> int:
    """The configuration --config and the environment give, as TOML."""
    try:
        cfg = load_config(getattr(args, "config", None))
    except (OSError, ValueError) as e:
        raise SystemExit(f"error: loading config: {e}")
    print(cfg.to_toml(), end="")
    return 0


def cmd_generate_config(_args) -> int:
    print(Config().to_toml(), end="")
    return 0


def cmd_profile_capture(args) -> int:
    """POST /debug/device-profile?seconds= to --host (:519-546):
    "disabled" and "busy" are reported with exit 1, not raised."""
    url = f"{args.host}/debug/device-profile?seconds={args.seconds:g}"
    try:
        req = urllib.request.Request(url, data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=args.seconds + 30) as resp:
            doc = json.loads(resp.read())
    except (OSError, ValueError) as e:
        raise SystemExit(f"error: capturing via {url}: {e}")
    if args.as_json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0 if doc.get("status") == "ok" else 1
    status = doc.get("status", "?")
    if status == "ok":
        print(f"captured {doc.get('seconds')}s device profile "
              f"({doc.get('bytes', 0)} bytes) -> {doc.get('dir')}")
        print("open the chrome trace in Perfetto or chrome://tracing: "
              + str(doc.get("trace", doc.get("dir"))))
        return 0
    print(f"capture not taken: {status}"
          + (f" ({doc.get('error')})" if doc.get("error") else ""))
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"server": cmd_server, "import": cmd_import,
            "export": cmd_export, "inspect": cmd_inspect,
            "check": cmd_check, "config": cmd_config,
            "generate-config": cmd_generate_config,
            "timeline": cmd_timeline, "advise": cmd_advise,
            "profile-capture": cmd_profile_capture}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
