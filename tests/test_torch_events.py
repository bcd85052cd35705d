"""The port's event journal, clock, logger and newly served keys, held
against the JAX package's modules.

The same injected wall sequences through both clocks, the same seeded
emit sequences (time.time fixed) through both journals, spools written
by one and reloaded by the other, the same log calls through both
loggers, the same TOML through both loaders and the same metric calls
through both StatsD clients give equal results; the port's SIGQUIT dump
runs in a subprocess that never imports JAX.
"""

import json
import os
import random
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from pilosa_tpu import qos as jax_qos
from pilosa_tpu.cli import config as jax_config
from pilosa_tpu.utils import events as jev
from pilosa_tpu.utils import logger as jlog
from pilosa_tpu.utils import stats as jstats
from pilosa_tpu.utils import tracing as jtracing
from pilosa_tpu_torch import qos as port_qos
from pilosa_tpu_torch.cli import config as port_config
from pilosa_tpu_torch.utils import events as pev
from pilosa_tpu_torch.utils import logger as plog
from pilosa_tpu_torch.utils import stats as pstats
from pilosa_tpu_torch.utils import tracing as ptracing

ROOT = Path(__file__).resolve().parent.parent
SKEW_MS = 7_200_000  # ±2 h


def _walls(seed: int, n: int) -> list:
    """A wall sequence that creeps forward with backward steps and jumps
    of two hours either way."""
    rng = random.Random(seed)
    base, out = 1_000_000_000_000, []
    for _ in range(n):
        base += rng.choice([0, 0, 1, 3, 50, -20, -400])
        out.append(base + rng.choice([0, 0, 0, SKEW_MS, -SKEW_MS]))
    return out


def _clock_ops(mod, seed: int) -> list:
    rng = random.Random(seed)
    walls = iter(_walls(seed, 400))
    clock = mod.HybridLogicalClock(wall_ms=lambda: next(walls))
    out = []
    for _ in range(150):
        op = rng.choice(["now", "now", "update", "peek", "garbage"])
        if op == "now":
            out.append(clock.now())
        elif op == "update":
            out.append(clock.update(
                (1_000_000_000_000 + rng.randint(-SKEW_MS, SKEW_MS),
                 rng.randint(0, 9))))
        elif op == "garbage":
            out.append(clock.update(rng.choice(["x", None, (1,), [None, 2]])))
        else:
            out.append(clock.peek())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clock_stamps_match_jax(seed):
    got = _clock_ops(pev, seed)
    assert got == _clock_ops(jev, seed)
    stamps = [s for s in got if s != (0, 0)]
    assert stamps == sorted(stamps)  # never backwards


def test_hlc_wire_form_matches_jax():
    assert pev.HLC_HEADER == jev.HLC_HEADER == "X-Pilosa-HLC"
    for stamp in [(0, 0), (123, 4), (1792351765317, 0), (5, 99)]:
        assert pev.encode_hlc(stamp) == jev.encode_hlc(stamp)
    for raw in ["123.4", "123", "123.", "", None, 12, "x", "1.2.3", ".5",
                "-7.1", " 9.2", "9.x", b"1.2", [1, 2]]:
        assert pev.decode_hlc(raw) == jev.decode_hlc(raw), raw


def test_registry_matches_jax():
    assert pev.EVENT_TYPES == jev.EVENT_TYPES
    assert pev.LANES == jev.LANES
    assert all(pev.event_lane(t) == jev.event_lane(t)
               for t in jev.EVENT_TYPES)


def _emit_script(j, seed: int) -> list:
    """A seeded sequence of emits and reads; -> every read's result."""
    rng = random.Random(seed)
    types = sorted(jev.EVENT_TYPES)
    reads = []
    for i in range(300):
        etype = rng.choice(types + ["log.warn"] * 10)
        fields = {"peer": rng.choice(["a", "b", None]), "n": i}
        if rng.random() < 0.1:
            fields["principal"] = "key:x"
        j.emit(etype, **fields)
        if i % 37 == 0:
            cursor = rng.randint(0, i)
            reads.append(j.since(cursor))
            reads.append(j.since(cursor, limit=rng.randint(0, 5)))
            reads.append(j.since(0, etype=etype))
            reads.append(j.since(0, severity=rng.choice(jev.LANES)))
    reads.append(j.snapshot())
    reads.append(len(j))
    return reads


@pytest.mark.parametrize("seed", [3, 4])
def test_journal_feeds_match_jax(monkeypatch, seed):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    got = _emit_script(pev.EventJournal(
        node_id="n", ring_size=32,
        clock=pev.HybridLogicalClock(wall_ms=lambda: 1000)), seed)
    want = _emit_script(jev.EventJournal(
        node_id="n", ring_size=32,
        clock=jev.HybridLogicalClock(wall_ms=lambda: 1000)), seed)
    assert got == want
    assert got[-2]["evicted"]["log"] > 0  # the storm evicted log lines


def test_log_storm_cannot_evict_lifecycle_events():
    j = pev.EventJournal(node_id="n", ring_size=16)
    j.emit("drain.start")
    j.emit("hint.append", target="x")
    for i in range(500):
        j.emit("log.warn", msg=f"storm {i}")
    types = [e["type"] for e in j.events(0)]
    assert types[:2] == ["drain.start", "hint.append"]
    assert types.count("log.warn") == 4
    assert j.snapshot()["evicted"] == {"lifecycle": 0, "log": 496}
    with pytest.raises(ValueError, match="unregistered event type"):
        j.emit("made.up")


def test_kill_switch(monkeypatch):
    j = pev.EventJournal(node_id="n")
    monkeypatch.setenv("PILOSA_TPU_EVENTS", "0")
    assert j.emit("drain.start") is None
    assert len(j) == 0 and j.snapshot()["droppedDisabled"] == 1
    monkeypatch.setenv("PILOSA_TPU_EVENTS", "1")
    assert j.emit("drain.start")["type"] == "drain.start" and len(j) == 1


def test_concurrent_emits_keep_seq_in_hlc_order(tmp_path):
    """The stamp, the seq and the spool line are taken together, so a
    node's seq order is its HLC order and its spool's order, however the
    threads interleave (a slow wall widens the window)."""
    def wall():
        time.sleep(0.0002)
        return 1000

    spool = str(tmp_path / "s.jsonl")
    j = pev.EventJournal(node_id="n", clock=pev.HybridLogicalClock(wall),
                         spool_path=spool, spool_max_bytes=1 << 20)
    threads = [threading.Thread(target=lambda: [j.emit("scrub.pass")
                                                for _ in range(40)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = j.events(0)
    assert len(evs) == 320
    assert sorted(evs, key=pev.hlc_sort_key) == evs
    with open(spool) as f:
        assert [json.loads(x)["seq"] for x in f] == list(range(1, 321))


@pytest.mark.parametrize("writer,reader", [(jev, pev), (pev, jev)])
def test_spool_reloads_across_packages(monkeypatch, tmp_path, writer,
                                       reader):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    spool = str(tmp_path / "events.spool.jsonl")
    w = writer.EventJournal(node_id="n", spool_path=spool,
                            spool_max_bytes=4000,
                            clock=writer.HybridLogicalClock(lambda: 5000))
    for i in range(60):
        w.emit("scrub.pass" if i % 3 else "log.error", blocksMerged=i)
    assert os.path.exists(spool + ".1")  # rotated at the cap
    assert os.path.getsize(spool) <= 4000
    with open(spool, "a") as f:
        f.write('{"torn": ')  # a line torn by a crash
    docs = []
    for i, mod in enumerate((reader, writer)):
        copy = str(tmp_path / f"copy{i}.jsonl")
        with open(spool) as src, open(copy, "w") as dst:
            dst.write(src.read())
        r = mod.EventJournal(node_id="n", spool_path=copy,
                             spool_max_bytes=4000,
                             clock=mod.HybridLogicalClock(lambda: 10))
        fresh = r.emit("node.start")
        docs.append((r.since(0), r.snapshot()["reloaded"], fresh))
    assert docs[0] == docs[1]
    reloaded = docs[0][0]["events"][:-1]
    assert reloaded and docs[0][2]["hlc"] > reloaded[-1]["hlc"]


def test_dump_and_merge_match_jax(tmp_path):
    docs = {}
    for mod in (pev, jev):
        a = mod.EventJournal(node_id="a",
                             clock=mod.HybridLogicalClock(lambda: 2000))
        b = mod.EventJournal(node_id="b",
                             clock=mod.HybridLogicalClock(lambda: 1000))
        a.emit("drain.start")
        b.clock.update(a.clock.peek())
        b.emit("peer.draining", peer="a")
        a.emit("drain.complete")
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        assert a.dump(path) == 2
        with open(path) as f:
            dumped = [json.loads(x) for x in f]
        for e in dumped:
            e.pop("ts")
        merged = mod.merge_events({"a": a.events(0), "b": b.events(0)})
        keys = [mod.hlc_sort_key(e) for e in merged]
        docs[mod] = (dumped, [(e["type"], e["node"], e["hlc"])
                              for e in merged], keys)
    assert docs[pev] == docs[jev]
    # b merged a's stamp before its event: it sorts after a's first two
    assert [t for t, _, _ in docs[pev][1]] == [
        "drain.start", "drain.complete", "peer.draining"]
    assert pev.hlc_sort_key({"hlc": "junk", "node": 3}) == \
        jev.hlc_sort_key({"hlc": "junk", "node": 3})


def test_sigquit_writes_the_crash_file_without_jax(tmp_path):
    """A port server's process on SIGQUIT writes its ring into its data
    dir and goes on; the process never imports JAX."""
    script = textwrap.dedent(f"""
        import os, signal, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from pilosa_tpu_torch.utils import events as ev
        j = ev.EventJournal(node_id="crashy")
        j.emit("drain.start")
        j.emit("log.error", msg="about to die")
        ev.register_crash_dump(j, {str(tmp_path)!r})
        os.kill(os.getpid(), signal.SIGQUIT)
        for _ in range(100):
            if any(n.startswith("events.crash-")
                   for n in os.listdir({str(tmp_path)!r})):
                break
            time.sleep(0.05)
        j.emit("drain.complete")
        assert not any(m.split(".")[0] in ("jax", "pilosa_tpu")
                       for m in sys.modules), "imported JAX"
        print("alive", len(j))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "alive 3"
    name = next(n for n in os.listdir(tmp_path)
                if n.startswith("events.crash-"))
    with open(tmp_path / name) as f:
        assert [json.loads(x)["type"] for x in f] == ["drain.start",
                                                      "log.error"]


def test_sigquit_dump_keeps_the_handler_it_replaced(tmp_path):
    """In a process that already has a SIGQUIT handler (the JAX
    package's, where both run), the port's dump runs and so does the
    handler it replaced."""
    import signal

    seen = []
    prev = signal.signal(signal.SIGQUIT, lambda s, f: seen.append(s))
    installed, kept = pev._CRASH_INSTALLED, pev._PREV_HANDLER
    pev._CRASH_INSTALLED = False
    j = pev.EventJournal(node_id="n")
    j.emit("drain.start")
    try:
        pev.register_crash_dump(j, str(tmp_path))
        os.kill(os.getpid(), signal.SIGQUIT)
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen == [signal.SIGQUIT]
        assert [n for n in os.listdir(tmp_path)
                if n.startswith("events.crash-")]
    finally:
        pev.unregister_crash_dump(j)
        signal.signal(signal.SIGQUIT, prev)
        pev._CRASH_INSTALLED, pev._PREV_HANDLER = installed, kept


class _Sink:
    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)

    def flush(self):
        pass


@pytest.mark.parametrize("fmt", ["plain", "json"])
@pytest.mark.parametrize("verbose", [False, True])
def test_logger_lines_match_jax(monkeypatch, fmt, verbose):
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-02T03:04:05")
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    out = {}
    for mod, ev, tr in ((plog, pev, ptracing), (jlog, jev, jtracing)):
        sink = _Sink()
        lg = mod.Logger(verbose=verbose, out=sink, fmt=fmt)
        lg.journal = ev.EventJournal(
            node_id="n", ring_size=8, clock=ev.HybridLogicalClock(lambda: 7))
        lg.printf("plain %d %s", 3, "x")
        lg.debugf("debug %s", "y")
        lg.warnf("warn with 100%% and ü")
        tok = tr.current_trace_id.set("abc123")
        try:
            lg.errorf("e" * 600)
        finally:
            tr.current_trace_id.reset(tok)
        lg.printf("no args 50%")
        out[mod] = (sink.lines, lg.journal.events(0))
    assert out[plog] == out[jlog]
    lines, evs = out[plog]
    assert len(lines) == (5 if verbose else 4)
    assert [e["type"] for e in evs] == ["log.warn", "log.error"]
    assert len(evs[1]["msg"]) == 512 and evs[1]["trace"] == "abc123"
    for mod in (plog, jlog):
        with pytest.raises(ValueError, match="invalid log format 'xml'"):
            mod.Logger(fmt="xml")
    assert plog.NopLogger().warnf("x") is None


EVENT_KEYS_TOML = """
log-path = "/var/log/n.log"
log-format = "json"
verbose = true
[cluster]
profile = "on"
[metric]
events-ring = 512
events-spool = 1048576
service = "statsd"
host = "10.0.0.1:9125"
"""


def _port_values(cfg) -> dict:
    v = cfg.values
    return {"log_path": v[""]["log_path"],
            "log_format": v[""]["log_format"], "verbose": v[""]["verbose"],
            "profile": v["cluster"]["profile"],
            **{k: v["metric"][k] for k in ("events_ring", "events_spool",
                                           "service", "host")}}


def _jax_values(cfg) -> dict:
    return {"log_path": cfg.log_path, "log_format": cfg.log_format,
            "verbose": cfg.verbose, "profile": cfg.cluster.profile,
            **{k: getattr(cfg.metric, k) for k in ("events_ring",
                                                   "events_spool",
                                                   "service", "host")}}


@pytest.mark.parametrize("environ", [
    {},
    {"PILOSA_TPU_METRIC_EVENTS_RING": "64", "PILOSA_TPU_VERBOSE": "false",
     "PILOSA_TPU_CLUSTER_PROFILE": "off", "PILOSA_TPU_LOG_FORMAT": "plain",
     "PILOSA_TPU_METRIC_SERVICE": "nop", "PILOSA_TPU_EVENTS": "0"}])
def test_loaders_read_the_event_keys_as_jax(tmp_path, environ):
    path = tmp_path / "n.toml"
    path.write_text(EVENT_KEYS_TOML)
    got = _port_values(port_config.load_config(str(path), environ=environ))
    want = _jax_values(jax_config.load_config(str(path), environ=environ))
    assert got == want
    assert got["events_ring"] == int(environ.get(
        "PILOSA_TPU_METRIC_EVENTS_RING", 512))


@pytest.mark.parametrize("kwargs,message", [
    ({"events_ring": 0}, "invalid [metric] events-ring 0 (expected >= 1)"),
    ({"events_spool": -1}, "[metric] events-spool must be >= 0"),
    ({"profile_mode": "sometimes"},
     "invalid [cluster] profile mode 'sometimes' (expected off | auto | on)"),
    ({"log_format": "xml"}, "invalid log format 'xml' (expected plain | "
                            "json)")])
def test_bad_event_values_get_the_jax_messages(tmp_path, kwargs, message):
    from pilosa_tpu.server import Server as JaxServer
    from pilosa_tpu_torch.server import Server

    errors = []
    for cls, extra in ((Server, {"device": "cpu"}), (JaxServer, {})):
        with pytest.raises(ValueError) as e:
            cls(str(tmp_path / cls.__module__), port=0, **extra, **kwargs)
        errors.append(str(e.value))
    assert errors == [message, message]


def test_statsd_datagrams_match_jax():
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(5)
    host = f"127.0.0.1:{recv.getsockname()[1]}"
    got = {}
    try:
        for mod in (pstats, jstats):
            c = mod.new_stats_client("statsd", host).with_tags("node:a")
            c.count("events", 2)
            c.gauge("residency/bytes", 1.5)
            c.timing("query", 12)
            c.histogram("fanout", 3)
            c.set("principals", "key:x")
            c.count_with_custom_tags("events", 1, 1.0, ["type:node.start"])
            got[mod] = [recv.recv(4096) for _ in range(6)]
            assert mod.new_stats_client("nop").snapshot() == {}
            assert mod.new_stats_client("expvar").snapshot()["counts"] == {}
    finally:
        recv.close()
    assert got[pstats] == got[jstats]
    assert got[pstats][0] == b"pilosa.events:2|c|#node:a"


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


def _qos_events(mod, ev, monkeypatch) -> list:
    """A quota-bound tenant's rejections into a storm and deep debt, a
    quiet window, then an admission that ends the storm, on one plane
    with its time injected -> the plane's events."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    plane = mod.QosPlane(mode="enforce", principals={
        "key:b": {"queries-per-s": 0.1}})
    plane.journal = ev.EventJournal(
        node_id="n", clock=ev.HybridLogicalClock(lambda: 1))
    verdicts = []
    for _ in range(25):
        clock.t += 0.1
        verdicts.append(plane.admit("key:b", "batch", None))
    clock.t += plane.STORM_WINDOW_S + 0.5
    verdicts.append(plane.admit("key:a", "interactive", None))
    clock.t += 0.1
    verdicts.append(plane.admit("key:a", "interactive", None))
    rej = [(v.status, v.reason) if v else None for v in verdicts]
    return rej, [{k: v for k, v in e.items() if k not in ("ts", "node")}
                 for e in plane.journal.events(0)]


def test_qos_storm_and_debt_events_match_jax(monkeypatch):
    got = _qos_events(port_qos, pev, monkeypatch)
    want = _qos_events(jax_qos, jev, monkeypatch)
    assert got == want
    assert [e["type"] for e in got[1]] == [
        "qos.quota_debt", "qos.shed_storm.start", "qos.shed_storm.end"]
