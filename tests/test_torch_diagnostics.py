"""Diagnostics, the runtime monitor and the context-carrying threads of
the port, against the JAX package's.

SystemInfo reads the same host facts as the JAX module; a node with
diagnostics_url and interval posts its document to a local listener,
exactly the documents sent are received, nothing after close, and a
listener that is gone costs nothing but a False; the poll-interval
gauges appear on /debug/vars and /metrics. utils/threads.py carries a
request's trace id, usage account, deadline and priority into a spawned
thread, a timer and a pool task, as the JAX helpers do, and a trace id
sent with an import reaches the peer the import is forwarded to from a
background thread.
"""

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from pilosa_tpu.utils import diagnostics as jdiag
from pilosa_tpu.utils import threads as jthreads
from pilosa_tpu_torch import qos
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.utils import accounting, diagnostics, qctx, threads
from pilosa_tpu_torch.utils import tracing

SW = 1 << 20


class _Sink:
    """A local listener that keeps every JSON document POSTed to it."""

    def __init__(self):
        docs = self.docs = []

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                docs.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = HTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/d"
        self.t = threading.Thread(target=self.srv.serve_forever,
                                  daemon=True)
        self.t.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_system_info_equals_jax():
    p, j = diagnostics.SystemInfo(), jdiag.SystemInfo()
    for name in ("platform", "family", "os_version", "kernel_version",
                 "mem_total", "cpu_count", "cpu_model"):
        assert getattr(p, name)() == getattr(j, name)(), name
    assert p.mem_used() > 0 and p.uptime() > 0
    assert diagnostics.process_rss() > 0
    n = diagnostics.NopSystemInfo()
    assert (n.uptime(), n.platform(), n.mem_total()) == (0, "", 0)


def test_collector_document_and_failures_equal_jax():
    class Idx:
        fields = {"a": 1, "b": 2}

    class Holder:
        indexes = {"i": Idx(), "j": Idx()}

    class Cluster:
        nodes = [1, 2, 3]

    args = dict(holder=Holder(), cluster=Cluster(),
                system_info=diagnostics.NopSystemInfo())
    p = diagnostics.DiagnosticsCollector("v1", **args).collect()
    j = jdiag.DiagnosticsCollector("v1", **args).collect()
    assert p == j
    assert (p["NumIndexes"], p["NumFields"], p["NumNodes"]) == (2, 4, 3)
    # no url: nothing sent; a listener that is gone: False, no raise
    assert diagnostics.DiagnosticsCollector("v1").flush() is False
    dead = diagnostics.DiagnosticsCollector(
        "v1", url="http://127.0.0.1:1/d", interval=0.1)
    assert dead.flush() is False
    assert dead.check_version("http://127.0.0.1:1/v") is None
    off = diagnostics.DiagnosticsCollector("v1", url="", interval=1.0)
    off.start()
    assert off._timer is None


def test_node_phones_home_and_samples_the_runtime(tmp_path):
    sink = _Sink()
    s = Server(str(tmp_path / "n"), port=0, device="cpu",
               diagnostics_url=sink.url, diagnostics_interval=0.2,
               metric_poll_interval=0.1).open()
    try:
        urllib.request.urlopen(urllib.request.Request(
            s.uri + "/index/i", data=b"{}", method="POST"), timeout=10)
        deadline = time.monotonic() + 20
        while len(sink.docs) < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(sink.docs) >= 3
        doc = sink.docs[-1]
        from pilosa_tpu_torch import __version__
        assert doc["Version"] == __version__ and doc["NumIndexes"] == 1
        assert doc["NumNodes"] == 1 and doc["NumCPU"] > 0
        with urllib.request.urlopen(s.uri + "/debug/vars", timeout=10) as r:
            gauges = json.loads(r.read())["gauges"]
        assert gauges["threads"] > 1 and gauges["memory/rss"] > 0
        assert "garbage/collections" in gauges
        with urllib.request.urlopen(s.uri + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'pilosa_memory{key="rss"}' in text
        assert "# TYPE pilosa_threads gauge" in text
        assert 'pilosa_garbage{key="collections"}' in text
    finally:
        s.close()
    n = len(sink.docs)
    time.sleep(0.6)
    assert len(sink.docs) == n  # nothing after close
    sink.close()


@pytest.mark.parametrize("mod", [threads, jthreads],
                         ids=["port", "jax"])
def test_helpers_carry_the_context(mod):
    seen = []

    def look():
        acct = accounting.current_account.get()
        seen.append((tracing.current_trace_id.get(),
                     acct.principal if acct is not None else None,
                     qctx.deadline.get(), qos.current_priority.get()))

    tok = [tracing.current_trace_id.set("feedbeef"),
           accounting.current_account.set(
               accounting.Account(accounting.UsageLedger(), "key:a")),
           qctx.deadline.set(123.0), qos.current_priority.set("batch")]
    try:
        t = mod.spawn(look)
        t.join()
        t = mod.ctx_thread(look)
        t.start()
        t.join()
        tm = mod.ctx_timer(0.01, look)
        tm.start()
        tm.join()
        with ThreadPoolExecutor(1) as pool:
            mod.submit_ctx(pool, look).result()
            pool.submit(look).result()  # a bare submit: empty context
    finally:
        for var, t in zip((tracing.current_trace_id,
                           accounting.current_account, qctx.deadline,
                           qos.current_priority), tok):
            var.reset(t)
    want = ("feedbeef", "key:a", 123.0, "batch")
    assert seen[:4] == [want] * 4
    assert seen[4] == (None, None, None, None)


def test_a_trace_id_reaches_the_forwarded_import(tmp_path):
    """The import's forward to the peer runs on a helper thread; the
    peer's dispatch sees the request's trace id."""
    nodes = [Server(str(tmp_path / f"n{i}"), port=0, device="cpu").open()
             for i in range(2)]
    try:
        uris = [n.uri for n in nodes]
        for n in nodes:
            n.cluster_hosts = uris
            n.refresh_membership()
        seen = []
        for n in nodes:
            orig = n.handler.dispatch

            def spy(method, path, query, body, headers=None, _o=orig):
                if path.endswith("/import") and headers is not None:
                    seen.append((path, headers.get(tracing.TRACE_HEADER)))
                return _o(method, path, query, body, headers)

            n.handler.dispatch = spy

        def post(path, body, hdrs=None):
            req = urllib.request.Request(uris[0] + path, data=body,
                                         method="POST", headers=hdrs or {})
            with urllib.request.urlopen(req, timeout=20) as r:
                return json.loads(r.read() or b"{}")

        post("/index/i", b"{}")
        post("/index/i/field/f", b"{}")
        cols = [s * SW + 5 for s in range(8)]
        post("/index/i/field/f/import",
             json.dumps({"rowIDs": [1] * 8, "columnIDs": cols}).encode(),
             {tracing.TRACE_HEADER: "0123abcd"})
        assert len(seen) >= 2  # the request and its forward
        assert {t for _p, t in seen} == {"0123abcd"}
        assert post("/index/i/query", b"Count(Row(f=1))")["results"] == [8]
    finally:
        for n in nodes:
            n.close()
