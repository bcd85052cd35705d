"""`python -m pilosa_tpu_torch.cli server --config <toml> [--data-dir DIR]
[--bind HOST:PORT] [--join]`: run one node of the port.

Trimmed port of pilosa_tpu/cli/main.py (cmd_server, :127-276): the
configuration is the JAX package's TOML and PILOSA_TPU_* environment
(cli/config.py), --data-dir and --bind win over both. The node runs on
the card unless [mesh] platform = "cpu"; on the card the kernel library
is built (or loaded) before the node listens, so a build failure stops
the start and no query pays for it. --join adds the node to a running
cluster whose nodes [cluster] hosts names (a resize job moves its shards
to it); [gossip] makes SWIM gossip the failure detector. SIGTERM or
SIGINT drains the node (Server.drain: shed, tell the peers, wait out
in-flight work, persist), then closes it and exits 0; a second signal
cuts the drain short (:249-265).

The JAX CLI's other subcommands (import, export, inspect, check, config,
generate-config, advise, timeline, profile-capture) are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"server": cmd_server}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
