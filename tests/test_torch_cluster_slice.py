"""The port's cluster data plane end to end, against the JAX package's.

Three clusters run in-process on the CPU, each of three nodes with the
pinned ids "a", "b" and "c" and replica_n=2 (so both packages place every
shard alike), built as tests/test_distributed_corpus.py builds its
cluster: three JAX nodes, three port nodes, and a mixed one of port nodes
"a" and "c" around the JAX node "b" (a port coordinator with a JAX
remote, a JAX coordinator with port remotes, and the JAX node keying
through the port primary "a"). The same seeded data goes in through node
"a" of each: a ranked set field f (sparse, dense and runny rows over 4
shards), g, a ranked t, an int field v and a keyed field lang, imported
over /import (forwarded by shard to the owners), f's last row over
/import-roaring. Over 100 seeded reads through every node of every
cluster give JSON identical at tolerance 0: Count algebra, Row results,
TopN with and without a Src (the phase-2 recount), BSI Sum/Min/Max and
Range, GroupBy with a limit and a filter, Rows, keyed reads, Options with
shards=, and a ?profile=true Count's fan-out records; writes through one
node (Set into a new shard, Clear, keyed Set through a non-primary) are
visible through every node at once, and every node's `.keys` log equals
the primary's byte for byte. A write with a dead replica is refused by
both packages and acknowledged by neither. The JAX package reopens the
port nodes' data dirs (fragments, `.keys`, `.id`) and answers the same.
Three `python -m pilosa_tpu_torch.cli server` processes on the CPU
converge and answer a distributed Count and a replicated Set, a config
key the port does not serve yet, set away from its default, fails the
start, and the keys it serves start a node.
"""

import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.cli import main as cli_main
from pilosa_tpu_torch.server import Server

from tests.test_torch_obs_slice import _call, _post
from tests.test_torch_typed_slice import _roaring

ROOT = Path(__file__).resolve().parent.parent
N_SHARDS = 4
SW = 1 << 20
IDS = ("a", "b", "c")
LANGS = ["Go", "Rust", "Python", "C", "Java", "Haskell", "OCaml", "Lisp"]


def _data(seed: int = 7) -> list:
    """(path, body) of the schema and imports."""
    rng = np.random.default_rng(seed)
    out = [("/index/d", {"options": {"trackExistence": True}}),
           ("/index/d/field/f", {"options": {"cacheType": "ranked"}}),
           ("/index/d/field/g", {}),
           ("/index/d/field/t", {"options": {"cacheType": "ranked",
                                             "cacheSize": 100}}),
           ("/index/d/field/v", {"options": {"type": "int", "min": 0,
                                             "max": 1000}}),
           ("/index/d/field/lang", {"options": {"keys": True}})]
    universe = rng.choice(N_SHARDS * SW, 40000, replace=False)
    for r in range(6):
        n = 6000 if r == 0 else 3000 // (r + 1) + 40
        cols = np.unique(rng.choice(universe, n))
        out.append(("/index/d/field/f/import",
                    {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()}))
    for r in range(3):
        cols = np.unique(rng.choice(universe, 900))
        out.append(("/index/d/field/g/import",
                    {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()}))
    for r in range(10):
        cols = np.unique(rng.choice(universe, 2000 // (r + 1) + 5))
        out.append(("/index/d/field/t/import",
                    {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()}))
    vcols = rng.choice(universe, 3000, replace=False)
    out.append(("/index/d/field/v/import",
                {"columnIDs": vcols.tolist(),
                 "values": rng.integers(0, 1000, vcols.size).tolist()}))
    lcols = rng.choice(universe, 2500, replace=False)
    share = 1.0 / (np.arange(len(LANGS)) + 1)
    keys = rng.choice(len(LANGS), lcols.size, p=share / share.sum())
    out.append(("/index/d/field/lang/import",
                {"rowKeys": [LANGS[k] for k in keys],
                 "columnIDs": lcols.tolist()}))
    # a run row of f over every shard, through /import-roaring
    for shard in range(N_SHARDS):
        pos = 6 * SW + np.arange(1000 + 7 * shard, 9000 + 7 * shard)
        out.append((f"/index/d/field/f/import-roaring/{shard}",
                    {"views": {"": _roaring(pos)}}))
    return out


def _queries() -> list:
    q = []
    ops = ("Intersect", "Union", "Difference", "Xor")
    for a in range(6):
        for b in range(a + 1, 7):
            q += [f"Count({op}(Row(f={a}), Row(f={b})))"
                  for i, op in enumerate(ops) if i != (a + b) % 4]
    q += [f"Count(Not(Row(f={r})))" for r in range(0, 7, 2)]
    q += ["Count(Intersect(Row(f=0), Row(f=1), Row(g=1)))",
          "Count(Intersect(Row(f=0), Row(g=0), Row(t=1)))",
          "Intersect(Row(f=1), Row(g=1))", "Row(f=5)", "Row(g=2)",
          "Union(Row(f=4), Row(t=9))", "Difference(Row(f=6), Row(f=0))",
          "TopN(f, n=3)", "TopN(f, Row(g=1), n=3)", "TopN(t, n=5)",
          "TopN(t, Row(f=0), n=4)", "TopN(t)", "TopN(f, ids=[1, 3, 5])",
          "Sum(field=v)", "Sum(Row(f=1), field=v)", "Min(field=v)",
          "Max(Row(f=2), field=v)", "Min(Row(g=0), field=v)",
          "Count(Range(v > 500))", "Count(Range(v >< [100, 300]))",
          "Count(Intersect(Range(v < 200), Row(f=0)))",
          "GroupBy(Rows(field=f), Rows(field=g), limit=7)", "GroupBy(Rows(field=g))",
          "GroupBy(Rows(field=f), filter=Row(g=0))",
          "GroupBy(Rows(field=t), Rows(field=g), limit=12)",
          "Rows(field=f)", "Rows(field=t, limit=3)", "Rows(field=g)",
          "Count(Row(lang=\"Go\"))", "Count(Row(lang=\"Zig\"))",
          "TopN(lang, n=3)", "Rows(field=lang)", "GroupBy(Rows(field=lang), Rows(field=g))",
          "Count(Intersect(Row(lang=\"Rust\"), Row(f=0)))",
          "Options(Count(Row(f=1)), shards=[0, 2])",
          "Options(Row(f=2), shards=[1])",
          "Options(TopN(f, n=2), shards=[0, 3])"]
    return q


def _cluster(tmp: Path, kinds: str) -> list:
    """Nodes "a", "b", "c" ('p' a port node, 'j' a JAX node)."""
    nodes = []
    for i, k in enumerate(kinds):
        d = str(tmp / f"n{i}")
        if k == "p":
            # the port node reads its id from the .id file
            os.makedirs(d)
            Path(d, ".id").write_text(IDS[i])
            nodes.append(Server(d, port=0, device="cpu",
                                replica_n=2).open())
        else:
            nodes.append(JaxServer(d, port=0, replica_n=2,
                                   node_id=IDS[i]).open())
    uris = [n.uri for n in nodes]
    for n in nodes:
        n.cluster_hosts = uris
        n.refresh_membership()
    for path, body in _data():
        st, out = _post(uris[0], path, body)
        assert st == 200, (path, out)
    return nodes


def _answers(uri: str, queries: list) -> list:
    out = []
    for pql in queries:
        st, body = _post(uri, "/index/d/query", pql)
        out.append((st, body))
    return out


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    made = {}
    try:
        for name, kinds in (("jax", "jjj"), ("port", "ppp"),
                            ("mixed", "pjp")):
            made[name] = _cluster(tmp_path_factory.mktemp(name), kinds)
        # the create-shard announcements are asynchronous
        deadline = time.monotonic() + 20
        for nodes in made.values():
            for n in nodes:
                while _post(n.uri, "/index/d/query", "Count(Row(f=1))") != \
                        _post(made["jax"][0].uri, "/index/d/query",
                              "Count(Row(f=1))"):
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
        yield made
    finally:
        for nodes in made.values():
            for n in nodes:
                n.close()


def test_reads_equal_through_every_node(clusters):
    queries = _queries()
    assert len(queries) >= 100
    want = _answers(clusters["jax"][0].uri, queries)
    assert all(st == 200 for st, _ in want), \
        [(q, w) for q, w in zip(queries, want) if w[0] != 200]
    nodes = [(name, node) for name in ("jax", "port", "mixed")
             for node in clusters[name]]
    with ThreadPoolExecutor(len(nodes)) as pool:
        got = list(pool.map(lambda nn: _answers(nn[1].uri, queries), nodes))
    for (name, node), answers in zip(nodes, got):
        for pql, g, w in zip(queries, answers, want):
            assert g == w, (name, node.uri, pql)


def test_profile_has_one_fanout_record_per_node(clusters):
    for node in clusters["port"]:
        st, out = _post(node.uri, "/index/d/query?profile=true",
                        "Count(Row(f=0))")
        assert st == 200
        fan = out["profile"]["fanout"]
        seen = {f["node"] for f in fan}
        assert len(seen) == len(fan) >= 2
        assert {f["transport"] for f in fan} <= {"local", "coalesced"}
        assert "coalesced" in {f["transport"] for f in fan}
        assert out["profile"]["route"][0]["route"] == "cross_slice"


def test_writes_visible_through_every_node(clusters):
    col = 6 * SW + 12345  # a shard nothing holds yet
    writes = [(1, f"Set({col}, f=0)"), (2, f"Set({col + 1}, g=1)"),
              (0, f"Clear({col}, f=0)"), (1, f"Set({col + 2}, f=0)"),
              (2, f"Set({col + 3}, lang=\"Zig\")"),
              (1, f"Set({col + 4}, lang=\"Go\") Set({col + 5}, "
                  f"lang=\"Zig\")")]
    reads = ["Count(Row(f=0))", "Count(Row(g=1))", "Row(f=0)",
             "Count(Row(lang=\"Zig\"))", "TopN(lang, n=2)", "Rows(field=lang)"]
    for name in ("jax", "port", "mixed"):
        nodes = clusters[name]
        for i, pql in writes:
            st, out = _post(nodes[i].uri, "/index/d/query", pql)
            assert st == 200, (name, pql, out)
    want = _answers(clusters["jax"][0].uri, reads)
    for name in ("jax", "port", "mixed"):
        for node in clusters[name]:
            assert _answers(node.uri, reads) == want, (name, node.uri)
    primary = clusters["port"][0].translate.log_bytes(0)
    assert primary == clusters["jax"][0].translate.log_bytes(0)
    for node in clusters["port"][1:]:
        assert node.cluster_translate.sync() in (True, False)
        assert node.translate.log_bytes(0) == primary


def test_write_with_a_dead_replica_is_refused(clusters):
    """Last of the module: node "c" of the mixed cluster dies."""
    nodes = clusters["mixed"]
    a, b, c = nodes
    shard = next(s for s in range(40, 400)
                 if {n.id for n in a.cluster.shard_nodes("d", s)} ==
                 {"a", "c"})
    col = shard * SW + 77
    c.http.close()
    st, out = _post(a.uri, "/index/d/query", f"Set({col}, g=2)")
    assert st != 200 and "replica write failed" in out["error"], out
    # the port writes the remote replica first: the live owner never
    # took the refused bit
    st, out = _post(a.uri, f"/index/d/query?remote=true&shards={shard}",
                    "Count(Row(g=2))")
    assert st == 200 and out["results"] == [0]
    # the JAX coordinator refuses it too (having written it to "a" first)
    st, out = _post(b.uri, "/index/d/query", f"Set({col + 1}, g=2)")
    assert st != 200 and "replica write failed" in out["error"], out


def test_jax_reopens_the_port_nodes(clusters, tmp_path):
    queries = _queries()[::16] + ["Count(Row(f=0))", "Rows(field=lang)"]
    ports = clusters["port"]
    want = _answers(ports[0].uri, queries)
    dirs = [n.data_dir for n in ports]
    for n in ports:
        n.close()
    reopened = [JaxServer(d, port=0, replica_n=2).open() for d in dirs]
    try:
        assert [n.node_id for n in reopened] == list(IDS)
        uris = [n.uri for n in reopened]
        for n in reopened:
            n.cluster_hosts = uris
            n.refresh_membership()
        for n in reopened:
            assert _answers(n.uri, queries) == want, n.uri
    finally:
        for n in reopened:
            n.close()
        clusters["port"] = []


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_cli_nodes_converge_and_serve(tmp_path):
    ports = _free_ports(3)
    hosts = ", ".join(f'"http://127.0.0.1:{p}"' for p in ports)
    procs = []
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    try:
        for i, port in enumerate(ports):
            cfg = tmp_path / f"n{i}.toml"
            cfg.write_text(
                f'data-dir = "{tmp_path / f"n{i}"}"\n'
                f'bind = "127.0.0.1:{port}"\n'
                "[cluster]\ndisabled = false\nreplicas = 2\n"
                f"hosts = [{hosts}]\nmembership-interval = 0.2\n"
                '[mesh]\ndevices = "none"\nplatform = "cpu"\n')
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
                 "--config", str(cfg)], cwd=ROOT, env=env,
                stdout=(tmp_path / f"n{i}.log").open("wb"),
                stderr=subprocess.STDOUT))
        uris = [f"http://127.0.0.1:{p}" for p in ports]
        deadline = time.monotonic() + 60
        for u in uris:
            while True:
                try:
                    st, out = _call(u, "GET", "/status")
                    if st == 200 and len(out["nodes"]) == 3:
                        break
                except OSError:
                    pass
                assert time.monotonic() < deadline, \
                    [(tmp_path / f"n{i}.log").read_text() for i in range(3)]
                assert all(p.poll() is None for p in procs)
                time.sleep(0.2)
        assert _post(uris[0], "/index/d", {})[0] == 200
        assert _post(uris[0], "/index/d/field/f", {})[0] == 200
        cols = [s * SW + 11 * s for s in range(6)]
        assert _post(uris[0], "/index/d/field/f/import",
                     {"rowIDs": [1] * 6, "columnIDs": cols})[0] == 200
        assert _post(uris[1], "/index/d/query", f"Set({7 * SW + 3}, f=1)")[
            0] == 200
        for u in uris:
            assert _post(u, "/index/d/query", "Count(Row(f=1))") == \
                (200, {"results": [7]})
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


@pytest.mark.parametrize("toml", [
    "[mesh]\nhost-devices = 2\n",
    "[mesh]\nreplicas = 2\n",
    "[mesh]\ndevices = 2\n",
    "[mesh]\nhost-devices = 8\nreplicas = 2\n",
    "[mesh]\nhost-devices = 8\ndevices = 9\n"])
def test_unported_config_key_fails_the_start(tmp_path, toml):
    """The [mesh] keys devices, replicas and host-devices are served now
    (they failed the start while a node drove one device): they build
    the node's mesh by the JAX package's rules, so a count past the
    devices there are fails the start with the JAX text, host-devices
    starts a node on a CPU mesh, and replicas alone over one device (or
    none) leaves a single-device node, as mesh_from_config gives None for
    fewer than two devices."""
    import torch

    from pilosa_tpu.parallel.mesh import mesh_from_config as jax_mesh
    from pilosa_tpu_torch.cli.config import load_config

    cfg = tmp_path / "n.toml"
    cfg.write_text(f'data-dir = "{tmp_path / "d"}"\n'
                   'bind = "127.0.0.1:0"\n' + toml)
    c = load_config(str(cfg), environ={})  # no NotPortedError
    m = c.values["mesh"]
    if m["devices"] not in ("auto", "none"):
        n = int(m["devices"])
        avail = m["host_devices"] or torch.cuda.device_count()
        if n > avail:
            want = (f"error: building device mesh: [mesh] devices = {n} "
                    f"out of range: {avail} available")
            with pytest.raises(SystemExit) as e:
                cli_main.main(["server", "--config", str(cfg)])
            assert str(e.value) == want
            if m["host_devices"] == 8:  # the JAX side's 8 CPU devices
                with pytest.raises(ValueError) as je:
                    jax_mesh(devices=str(n), host_devices=8)
                assert want.endswith(str(je.value))
            return
    mesh = cli_main.build_mesh(c)
    if not m["host_devices"]:
        assert torch.cuda.device_count() >= 2 or mesh is None
        return
    assert c.device == "cpu"
    assert mesh.shape == ({"replica": 2, "shard": 4} if m["replicas"] == 2
                          else {"shard": m["host_devices"]})
    srv = Server(str(tmp_path / "d"), mesh=mesh,
                 **cli_main.server_kwargs(c)).open()
    try:
        assert srv.executor.runner.mesh is mesh
        assert _post(srv.uri, "/index/i", {})[0] == 200
        assert _post(srv.uri, "/index/i/field/f", {})[0] == 200
        assert _post(srv.uri, "/index/i/query",
                     f"Set(3, f=1) Set({3 << 20}, f=1)")[0] == 200
        assert _post(srv.uri, "/index/i/query", "Count(Row(f=1))") == \
            (200, {"results": [2]})
    finally:
        srv.close()


def test_ported_qos_keys_start_a_node(tmp_path):
    """[qos] (with a principal's table), [slo], [ingest], [storage]
    wal-fsync, max-writes-per-request and the [metric] and [cluster] keys
    served since are accepted, and a node starts with them."""
    from pilosa_tpu_torch.cli.config import load_config

    cfg = tmp_path / "n.toml"
    cfg.write_text(
        f'data-dir = "{tmp_path / "d"}"\nbind = "127.0.0.1:0"\n'
        'max-writes-per-request = 100\n'
        '[cluster]\nquery-history-size = 10\n'
        '[qos]\nmode = "observe"\ndefault-deadline = "2s"\n'
        '[qos.principals."key:etl"]\nqueries-per-s = 5.0\n'
        'priority = "batch"\n'
        '[slo]\ncount-latency-ms = 250.0\nwindow-short = "1m"\n'
        '[ingest]\nbatch-window = "5ms"\nmax-batch = 512\n'
        '[storage]\nwal-fsync = "always"\n'
        '[metric]\ntelemetry-ring = 60\nusage-ring = 30\n'
        'usage-max-principals = 16\n[mesh]\nplatform = "cpu"\n')
    c = load_config(str(cfg), environ={"PILOSA_TPU_QOS_BURST": "3"})
    assert c.get("slo", "window_short") == 60.0
    assert c.get("qos", "burst") == 3.0
    kw = cli_main.server_kwargs(c)
    kw["port"] = 0
    srv = Server(str(tmp_path / "d"), **kw).open()
    try:
        assert srv.qos.mode == "observe" and srv.qos.burst_s == 3.0
        assert srv.qos.overrides == {"key:etl": {"queries_per_s": 5.0,
                                                 "priority": "batch"}}
        assert [o.name for o in srv.slo.objectives] == [
            "availability", "count-latency"]
        assert srv.api.max_writes_per_request == 100
        assert srv.executor.ingest.max_batch == 512
        assert srv.usage.max_principals == 16
    finally:
        srv.close()


def test_ported_event_keys_start_a_node(tmp_path):
    """log-path, log-format, verbose, [metric] events-ring, events-spool,
    service and host, and [cluster] profile are served: a node starts
    with them, its log lines in the file and its events in the spool."""
    from pilosa_tpu_torch.cli.config import load_config
    from pilosa_tpu_torch.utils.stats import StatsDClient

    cfg = tmp_path / "n.toml"
    log = tmp_path / "node.log"
    cfg.write_text(
        f'data-dir = "{tmp_path / "d"}"\nbind = "127.0.0.1:0"\n'
        f'log-path = "{log}"\nlog-format = "json"\nverbose = true\n'
        '[cluster]\nprofile = "on"\n'
        '[metric]\nevents-ring = 64\nevents-spool = 65536\n'
        'service = "statsd"\nhost = "127.0.0.1:9"\n'
        '[mesh]\nplatform = "cpu"\n')
    c = load_config(str(cfg), environ={})
    kw = cli_main.server_kwargs(c)
    kw["port"] = 0
    srv = Server(str(tmp_path / "d"), **kw).open()
    try:
        assert srv.events.ring_size == 64
        assert isinstance(srv.stats, StatsDClient)
        assert srv.api.profile_mode == "on" and srv.logger.verbose
        srv.logger.warnf("a %s line", "warn")
        assert [e["type"] for e in srv.events.events(0)] == [
            "node.start", "log.warn"]
    finally:
        srv.close()
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert {"level": "WARN", "msg": "a warn line"}.items() <= \
        lines[-1].items()
    spool = tmp_path / "d" / "events.spool.jsonl"
    assert [json.loads(x)["type"] for x in spool.read_text().splitlines()] \
        == ["node.start", "log.warn", "node.stop"]


def test_ported_lifecycle_keys_start_a_node(tmp_path):
    """[cluster] drain-timeout and the [gossip] section are served: a node
    starts with them, gossiping with its secret on an ephemeral port."""
    from pilosa_tpu_torch.cli.config import load_config

    cfg = tmp_path / "n.toml"
    cfg.write_text(
        f'data-dir = "{tmp_path / "d"}"\nbind = "127.0.0.1:0"\n'
        '[cluster]\ndrain-timeout = "5s"\n'
        '[gossip]\nport = 0\nseeds = ["127.0.0.1:1"]\nperiod = 0.25\n'
        'probe-timeout = 0.1\npush-pull-interval = "2s"\n'
        'secret = "hush"\n[mesh]\nplatform = "cpu"\n')
    c = load_config(str(cfg), environ={})
    assert c.get("cluster", "drain_timeout") == 5.0
    assert c.get("gossip", "push_pull_interval") == 2.0
    from pilosa_tpu_torch.cli.main import _gossip_config
    from pilosa_tpu_torch.server import Server

    g = c.values["gossip"]
    srv = Server(str(tmp_path / "d"), port=0, device="cpu",
                 drain_timeout=c.get("cluster", "drain_timeout"),
                 gossip_port=g["port"], gossip_seeds=g["seeds"],
                 gossip_config=_gossip_config(g),
                 gossip_secret=g["secret"]).open()
    try:
        assert srv.gossip is not None and srv.gossip.port > 0
        assert srv.gossip.config.period == 0.25
        assert srv.gossip._cipher is not None
        assert srv.drain_status()["timeoutSeconds"] == 5.0
    finally:
        srv.close()
