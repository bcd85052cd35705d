"""The JAX package's chaos suite (tests/test_chaos.py) against the port.

Its six scenarios: the seeded storm of torn WAL appends, failed and
partial RPCs, injected fan-out and dispatch faults and a node death
mid-storm (the long storm is also marked slow, as in the JAX suite); a
corrupt snapshot quarantined at open and rebuilt from its replica; the
scrubber's counters on /debug/vars and /metrics with the failpoints
block; and the SIGKILL of a writer mid-stream with wal-fsync=always, per
bit and through the batched write path. The storms run against a port
trio and a mixed trio (port, JAX, port); both packages' failpoints are
armed with the same seed, so each node draws from its own package's
registry, and the draws are the same in either (test_torch_failpoints).

The contract is the JAX suite's: every answer is right or a clean JSON
error, every acknowledged write reads back on every surviving replica,
and once the faults stop, paced scrub passes converge the co-owned
fragments to identical block checksums. The port's periodic pass merges
a block only when the pass before saw the same divergence, so the
settling loop's passes run until it converges, as the JAX loop does.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu.utils import failpoints as jfp
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.utils import failpoints as fp

pytestmark = pytest.mark.chaos

SW = 1 << 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORM_POINTS = {"storage.wal.append", "net.client.send", "net.client.read",
                "executor.fanout", "http.server.dispatch"}


@pytest.fixture(autouse=True)
def _reset_port_failpoints():
    fp.reset()
    yield
    fp.reset()


def http(method, uri, path, body=None, timeout=20):
    req = urllib.request.Request(uri + path, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def jpost(uri, path, payload=None, raw=None):
    body = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else b"")
    status, out = http("POST", uri, path, body)
    return status, json.loads(out) if out else {}


def wait_until(fn, timeout=60.0, interval=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if fn():
                return True
        except Exception:  # noqa: BLE001 — not ready yet
            pass
        time.sleep(interval)
    return False


@pytest.fixture(params=["ppp", "pjp"])
def trio(request, tmp_path):
    servers = []
    for i, kind in enumerate(request.param):
        d = str(tmp_path / f"n{i}")
        if kind == "p":
            s = Server(d, port=0, device="cpu", replica_n=2).open()
        else:
            s = JaxServer(d, port=0, replica_n=2).open()
        servers.append(s)
    uris = [s.uri for s in servers]
    for s in servers:
        s.cluster_hosts = uris
        s.refresh_membership()
    yield servers
    fp.reset()
    jfp.reset()
    for s in servers:
        s.close()


def _seed_corpus(s0) -> int:
    """Rows 1..3 x 10 columns in each of shards 0..3, written before any
    fault is armed; the expected count of each row."""
    jpost(s0.uri, "/index/i", {})
    jpost(s0.uri, "/index/i/field/f", {})
    for shard in range(4):
        for row in (1, 2, 3):
            pql = "".join(f"Set({shard * SW + row * 100 + k}, f={row})"
                          for k in range(10))
            status, out = jpost(s0.uri, "/index/i/query", raw=pql.encode())
            assert status == 200 and out["results"] == [True] * 10, out
    return 40


def _converged(servers) -> bool:
    """Every co-owned fragment carries the same block checksums."""
    sums = []
    for s in servers:
        m = {}
        for iname, fname, vname, shard, frag in s.holder.walk_fragments():
            if not s.cluster.owns_shard(s.node_id, iname, shard):
                continue
            m[(iname, fname, vname, shard)] = \
                {b: c.hex() for b, c in frag.blocks()}
        sums.append(m)
    shared_any = False
    for i in range(len(sums)):
        for j in range(i + 1, len(sums)):
            shared = set(sums[i]) & set(sums[j])
            shared_any |= bool(shared)
            if any(sums[i][k] != sums[j][k] for k in shared):
                return False
    return shared_any


def _chaos_storm(servers, seed, rate, n_queries, n_writes):
    s0, s1, s2 = servers
    expected = _seed_corpus(s0)
    live = [s0, s1]
    for mod in (fp, jfp):
        mod.arm_chaos(seed, rate=rate, points=STORM_POINTS)
    acked, bad = [], []
    for i in range(max(n_queries, n_writes)):
        src = live[i % 2]
        if i < n_writes:
            col = (i % 4) * SW + 900 + i
            status, out = jpost(src.uri, "/index/i/query",
                                raw=f"Set({col}, f=9)".encode())
            if status == 200 and out.get("results") == [True]:
                acked.append(col)
            elif status == 200:
                bad.append(("write-200-not-true", out))
            elif "error" not in out:
                bad.append(("write-error-shape", status, out))
        if i < n_queries:
            row = 1 + (i % 3)
            status, out = jpost(src.uri, "/index/i/query",
                                raw=f"Count(Row(f={row}))".encode())
            if status == 200:
                if out["results"] != [expected]:
                    bad.append(("wrong-count", row, out["results"]))
            elif "error" not in out:
                bad.append(("error-shape", status, out))
        if i == max(n_queries, n_writes) // 2:
            s2.http.close()  # the node dies mid-storm
    fired = sum(c["fired"] for c in fp.counters().values()) + \
        sum(c["fired"] for c in jfp.counters().values())
    assert not bad, (bad, fp.describe(), jfp.describe())
    assert fired > 0
    fp.reset()
    jfp.reset()
    for s in live:
        s.anti_entropy_pace = 0.0

    def settle():
        for s in live:
            s.scrub_pass()
        return _converged(live)

    assert wait_until(settle), "replicas did not converge"
    for s in live:
        status, out = jpost(s.uri, "/index/i/query", raw=b"Row(f=9)")
        assert status == 200
        cols = set(out["results"][0]["columns"])
        missing = [c for c in acked if c not in cols]
        assert not missing, f"acked writes lost on {s.node_id}: {missing}"
        for row in (1, 2, 3):
            status, out = jpost(s.uri, "/index/i/query",
                                raw=f"Count(Row(f={row}))".encode())
            assert status == 200 and out["results"] == [expected]
    return acked


def test_chaos_storm_3node_seeded(trio):
    _chaos_storm(trio, seed=20250804, rate=0.08, n_queries=40, n_writes=24)


@pytest.mark.slow
def test_chaos_storm_3node_long(trio):
    seed = int(os.environ.get("PILOSA_TPU_CHAOS_SEED", "987654321"))
    _chaos_storm(trio, seed=seed, rate=0.2, n_queries=200, n_writes=120)


def test_corrupt_snapshot_rebuilt_from_replica(trio):
    s0 = trio[0]
    _seed_corpus(s0)
    victim, frag = None, None
    for s in trio:
        if not isinstance(s, Server):
            continue
        v = s.holder.index("i").field("f").view("standard")
        for shard, fr in (v.fragments.items() if v else []):
            owners = {n.id for n in s.cluster.shard_nodes("i", shard)}
            if s.node_id in owners and len(owners) > 1 and fr.bit_count():
                victim, frag = s, fr
                break
        if frag is not None:
            break
    assert frag is not None
    before = frag.bit_count()
    frag.snapshot()
    frag.close()
    size = os.path.getsize(frag.path)
    with open(frag.path, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))
    frag.open()
    assert frag.quarantine_path and os.path.exists(frag.quarantine_path)
    assert frag.needs_rebuild and frag.bit_count() == 0
    assert victim.holder.damaged_fragments()[0]["needsRebuild"]
    assert victim.repair_quarantined() == 1
    assert frag.rebuilt_from and not frag.needs_rebuild
    assert frag.bit_count() == before
    frag.close()
    frag.open()
    assert frag.quarantine_path is None and frag.bit_count() == before
    assert any(p.startswith(os.path.basename(frag.path) + ".corrupt-")
               for p in os.listdir(os.path.dirname(frag.path)))


def test_scrub_pass_counters_and_debug_vars(trio):
    s0 = trio[0]
    _seed_corpus(s0)
    s0.scrub_pass()
    status, out = http("GET", s0.uri, "/debug/vars")
    assert status == 200
    snap = json.loads(out)
    assert snap["counts"]["antiEntropy/passes"] >= 1
    assert "antiEntropy/lastPassSeconds" in snap["gauges"]
    assert "failpoints" not in snap  # nothing evaluated, nothing armed
    with fp.failpoint("executor.fanout", "raise", times=1):
        with pytest.raises(fp.FailpointError):
            fp.hit("executor.fanout")
    status, out = http("GET", s0.uri, "/debug/vars")
    snap = json.loads(out)
    assert snap["failpoints"]["points"]["executor.fanout"]["fired"] == 1
    assert snap["failpoints"]["armed"] is False
    status, out = http("GET", s0.uri, "/metrics")
    assert status == 200
    assert b"failpoints" in out and b"antiEntropy" in out
    # a fan-out fault through the executor fails over like a dead peer
    with fp.failpoint("executor.fanout", "raise", times=1):
        status, res = jpost(s0.uri, "/index/i/query",
                            raw=b"Count(Row(f=1))")
    assert (status, res.get("results")) == (200, [40])


def test_a_slow_fence_check_leaves_no_peer_out(trio):
    """ROADMAP Queue C 14: with every internal RPC delayed before it is
    sent (the fence check's GET /debug/vars among them), a bit planted on
    one owner still reaches the other through its scrub passes."""
    s0 = trio[0]
    _seed_corpus(s0)
    shard = 2
    owners = [s for s in trio
              if s.node_id in {n.id for n in s0.cluster.shard_nodes(
                  "i", shard)}]
    col = shard * SW + 4444
    st, _ = jpost(owners[0].uri,
                  f"/index/i/query?remote=true&shards={shard}",
                  raw=f"Set({col}, f=3)".encode())
    assert st == 200
    other = owners[1]
    for mod in (fp, jfp):
        mod.configure("net.client.send", "delay", arg=0.05)
    try:
        merged = sum(other.scrub_pass()
                     for _ in range(2 if isinstance(other, Server) else 1))
    finally:
        fp.reset()
        jfp.reset()
    assert merged >= 1
    st, out = jpost(other.uri, f"/index/i/query?remote=true&shards={shard}",
                    raw=b"Row(f=3)")
    assert col in out["results"][0]["columns"]
    assert fp.counters() == {}


# -- crash durability: SIGKILL mid-write with wal-fsync=always ---------------

CRASH_WRITER = r"""
import sys
from pilosa_tpu_torch.storage.fragment import Fragment

f = Fragment(sys.argv[1], "i", "f", "standard", 0).open()
assert f.wal_fsync is True
col = 0
while True:
    f.set_bit(col % 7, col)
    print(f"ACK {col % 7} {col}", flush=True)
    col += 1
"""

CRASH_WRITER_BATCHED = r"""
import sys, threading
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder

h = Holder(sys.argv[1]).open()
idx = h.create_index("i")
idx.create_field("f")
ex = Executor(h, device="cpu")
plock = threading.Lock()
acks = 0

def writer(tid):
    global acks
    col = tid * 1000000
    while True:
        cols = list(range(col, col + 5))
        ex.execute("i", "".join(f"Set({c}, f={tid})" for c in cols))
        with plock:
            for c in cols:
                print(f"ACK {tid} {c}", flush=True)
            acks += len(cols)
            if 120 <= acks < 125:
                s = ex.ingest_snapshot()
                print(f"STATS {s['mutations']} {s['walAppends']}",
                      flush=True)
        col += 5

ts = [threading.Thread(target=writer, args=(t,), daemon=True)
      for t in range(4)]
for t in ts:
    t.start()
for t in ts:
    t.join()
"""


def _run_writer(tmp_path, script, target, need, store="dict"):
    path = tmp_path / "writer.py"
    path.write_text(script)
    env = dict(os.environ, PILOSA_TPU_WAL_FSYNC="always",
               PILOSA_TPU_CONTAINER_STORE=store, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("PILOSA_TPU_TORCH_INGEST", None)
    proc = subprocess.Popen([sys.executable, str(path), target],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=env)
    acked, stats, err = [], None, b""
    try:
        for line in proc.stdout:
            parts = line.split()
            if parts[0] == b"STATS":
                stats = (int(parts[1]), int(parts[2]))
                continue
            assert parts[0] == b"ACK", line
            acked.append((int(parts[1]), int(parts[2])))
            if len(acked) >= need:
                os.kill(proc.pid, signal.SIGKILL)
                break
        rest, err = proc.communicate(timeout=30)
        for line in rest.splitlines():
            parts = line.split()
            if len(parts) == 3 and parts[0] == b"ACK":
                acked.append((int(parts[1]), int(parts[2])))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert len(acked) >= need, (acked, err)
    return acked, stats


@pytest.mark.parametrize("store", ["dict", "btree"])
def test_sigkill_mid_write_loses_no_acked_writes(tmp_path, store,
                                                 monkeypatch):
    frag_path = str(tmp_path / "data" / "frag")
    acked, _ = _run_writer(tmp_path, CRASH_WRITER, frag_path, 150, store)
    from pilosa_tpu.storage.fragment import Fragment as JaxFragment

    for Frag in (Fragment, JaxFragment):  # the port's file opens in both
        g = Frag(frag_path, "i", "f", "standard", 0).open()
        have = {r: set(g.row_columns(r).tolist()) for r in range(7)}
        missing = [(r, c) for r, c in acked if c not in have[r]]
        assert not missing, f"{len(missing)} acked writes lost"
        assert 0 <= g.bit_count() - len(acked) <= 1
        g.close()
    monkeypatch.setenv("PILOSA_TPU_CONTAINER_STORE", store)
    g = Fragment(frag_path, "i", "f", "standard", 0).open()
    g.set_bit(6, 123456)
    g.close()
    h = Fragment(frag_path, "i", "f", "standard", 0).open()
    assert h.wal_truncated_bytes == 0
    assert 123456 in h.row_columns(6).tolist()
    h.close()


def test_sigkill_mid_batched_ingest_loses_no_acked_writes(tmp_path):
    data_dir = str(tmp_path / "data")
    acked, stats = _run_writer(tmp_path, CRASH_WRITER_BATCHED, data_dir,
                               200)
    assert stats is not None and stats[0] >= 120 and stats[1] < stats[0]
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder

    h = Holder(data_dir).open()
    ex = Executor(h, device="cpu")
    present = {t: set(ex.execute("i", f"Row(f={t})")[0].columns().tolist())
               for t in range(4)}
    missing = [(r, c) for r, c in acked if c not in present[r]]
    assert not missing, f"{len(missing)} acked writes lost: {missing[:5]}"
    exist = set(ex.execute("i", "Not(Row(f=99))")[0].columns().tolist())
    assert all(c in exist for _r, c in acked)
    assert ex.execute("i", "Set(999999, f=0)") == [True]
    h.close()
    h2 = Holder(data_dir).open()
    ex2 = Executor(h2, device="cpu")
    assert 999999 in ex2.execute("i", "Row(f=0)")[0].columns().tolist()
    h2.close()
