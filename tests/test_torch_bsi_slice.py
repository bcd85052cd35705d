"""The port's BSI path end to end, against the JAX server.

Both servers run in-process (the port on the CPU, through its kernels'
plain versions) and get the same HTTP traffic: int fields created over
HTTP, JSON `values` imports, Set/Clear of int values; then a seeded list
of Sum/Min/Max, Range (every op, BETWEEN, != null and every out-of-range
clamp) and Count/Intersect/Union/Not over Range, with ?shards= subsets,
must give identical JSON, and the same errors the same status. The port
also serves a data dir the JAX server wrote.
"""

import http.client
import json
import sys
import threading
from urllib.parse import urlparse

import numpy as np

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server

N_SHARDS = 3
SHARD_WIDTH = 1 << 20
# (name, min, max): depth 10, depth 11 with a negative min, depth 1
INT_FIELDS = (("v", 0, 1023), ("n", -500, 1000), ("c", 5, 5), ("e", 0, 100))


def _call(uri: str, method: str, path: str, body: bytes = b""):
    u = urlparse(uri)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _post(uri: str, path: str, body) -> tuple:
    if not isinstance(body, str):
        body = json.dumps(body)
    return _call(uri, "POST", path, body.encode())


def _ask(uri: str, index: str, queries: list) -> list:
    answers = []
    for q, shards in queries:
        path = f"/index/{index}/query"
        if shards is not None:
            path += "?shards=" + ",".join(str(s) for s in shards)
        answers.append(_post(uri, path, q))
    return answers


def _traffic() -> list:
    rng = np.random.default_rng(21)
    out = [("/index/i", {"options": {"trackExistence": True}}),
           ("/index/i/field/f", {"options": {"type": "set"}})]
    out += [(f"/index/i/field/{name}",
             {"options": {"type": "int", "min": lo, "max": hi}})
            for name, lo, hi in INT_FIELDS]
    for r, card in ((0, 6000), (1, 900), (2, 3000)):
        cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=card)
        out.append(("/index/i/field/f/import",
                    {"rowIDs": [r] * card, "columnIDs": cols.tolist()}))
    for name, lo, hi in INT_FIELDS[:3]:
        for card in (5000, 800):  # the second import overwrites some values
            cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=card)
            if card == 800:
                cols[:300] = out[-1][1]["columnIDs"][:300]
            vals = rng.integers(lo, hi + 1, size=card)
            out.append((f"/index/i/field/{name}/import",
                        {"columnIDs": cols.tolist(),
                         "values": vals.tolist()}))
    writes = ["Set(5, v=1023)", "Set(5, v=7) Set(6, n=-500) Set(7, n=1000)",
              "Set(2097160, c=5)", "Clear(5, v=0)", "Set(5, v=0)",
              "Clear(3145727, n=0)", "Set(3145727, v=7) Clear(77, v=0)"]
    out += [("/index/i/query", w) for w in writes]
    return out


def _queries() -> list:
    """Seeded (pql, shards) pairs over every BSI call of the slice."""
    fixed = []
    for name, _, _ in INT_FIELDS:
        fixed += [f"Sum(field={name})", f"Min(field={name})",
                  f"Max(field={name})"]
    fixed += [
        "Sum(Row(f=1), field=v)", "Sum(Range(v > 511), field=v)",
        "Min(Row(f=0), field=n)", "Max(Row(f=0), field=n)",
        "Max(Intersect(Row(f=0), Row(f=2)), field=v)",
        "Sum(Row(f=99), field=n)", "Min(Range(n < 0), field=n)",
        "Max(Not(Row(f=0)), field=v)", "Sum(Range(c == 5), field=n)",
        "Range(v >< [100, 200])", "Range(n >< [-100, 50])",
        "Range(n >< [50, -100])", "Range(v != null)", "Range(c != null)",
        "Range(e != null)", "Range(e > 3)",
        # every out-of-range clamp
        "Range(v > 5000)", "Range(v >= 1024)", "Range(v < -1)",
        "Range(v <= -1)", "Range(v == 2000)", "Range(v == -3)",
        "Range(v != 2000)", "Range(v < 1024)", "Range(v <= 1023)",
        "Range(v > -5)", "Range(v >= 0)", "Range(v >< [-10, 2000])",
        "Range(v >< [2000, 3000])", "Range(v >< [-30, -10])",
        "Range(n < -500)", "Range(n <= -500)", "Range(n > 1000)",
        "Range(n >= 1000)", "Range(n == -500)", "Range(n != 1000)",
        "Range(c == 5)", "Range(c != 5)", "Range(c > 5)", "Range(c < 5)",
        "Range(c >= 5)", "Range(c <= 5)", "Range(c > 4)",
        "Count(Range(v > 511))", "Count(Range(v != null))",
        "Count(Intersect(Row(f=0), Range(v < 300)))",
        "Count(Union(Range(v < 10), Range(n > 900)))",
        "Count(Not(Range(v == 7)))", "Not(Range(n > 0))",
        "Count(Difference(Range(v >= 100), Row(f=1)))",
        "Count(Xor(Range(n < 0), Range(v > 500)))",
        "Intersect(Range(v < 50), Range(n > 900))",
        "Count(Range(v >< [0, 1023])) Sum(field=v) Count(Range(n == 0))",
    ]
    out = [(q, None) for q in fixed]
    rng = np.random.default_rng(22)
    ops = ["<", "<=", ">", ">=", "==", "!="]
    for i in range(24):
        name, lo, hi = INT_FIELDS[i % 2]
        op = ops[i % len(ops)]
        x = int(rng.integers(lo, hi + 1))
        kind = i % 4
        if kind == 0:
            q = f"Range({name} {op} {x})"
        elif kind == 1:
            q = f"Count(Range({name} {op} {x}))"
        elif kind == 2:
            q = f"Sum(Range({name} {op} {x}), field={INT_FIELDS[1 - i % 2][0]})"
        else:
            agg = "Min" if i % 8 == 3 else "Max"
            q = f"{agg}(Intersect(Row(f={i % 3}), Range({name} {op} {x})), field={name})"
        shards = None
        if i % 3 == 1:
            shards = sorted(rng.choice(N_SHARDS + 1, size=2, replace=False))
        out.append((q, shards))
    return out


ERRORS = ["Sum(field=f)", "Min(field=f)", "Range(zz > 5)", "Sum(field=zz)",
          "Range(f > 5)", "Sum(Range(v > 5))", "Set(5, v=5000)",
          "Range(v == null)"]


def test_port_answers_bsi_like_the_jax_server(tmp_path):
    queries = _queries()
    assert len(queries) >= 60
    jax_dir = str(tmp_path / "jax")
    jax_srv = JaxServer(jax_dir, port=0).open()
    try:
        port_srv = Server(str(tmp_path / "torch"), port=0, device="cpu").open()
        try:
            for path, body in _traffic():
                want = _post(jax_srv.uri, path, body)
                assert want[0] == 200, (path, want)
                assert _post(port_srv.uri, path, body) == want, (path, body)
            assert (_call(port_srv.uri, "GET", "/schema")
                    == _call(jax_srv.uri, "GET", "/schema"))
            want = _ask(jax_srv.uri, "i", queries)
            got = _ask(port_srv.uri, "i", queries)
            for (q, shards), g, w in zip(queries, got, want):
                assert w[0] == 200, (q, w)
                assert g == w, (q, shards)
            for q in ERRORS:
                w = _post(jax_srv.uri, "/index/i/query", q)
                g = _post(port_srv.uri, "/index/i/query", q)
                assert w[0] != 200 and g[0] == w[0], (q, g, w)
        finally:
            port_srv.close()
    finally:
        jax_srv.close()
    # the port opens the data dir the JAX server wrote: same answers
    reopened = Server(jax_dir, port=0, device="cpu").open()
    try:
        assert _ask(reopened.uri, "i", queries) == want
    finally:
        reopened.close()


def _bsi_server(tmp_path, rng):
    srv = Server(str(tmp_path / "c"), port=0, device="cpu").open()
    _post(srv.uri, "/index/i", {})
    _post(srv.uri, "/index/i/field/v",
          {"options": {"type": "int", "min": -100, "max": 923}})
    cols = rng.integers(0, 2 * SHARD_WIDTH, size=20000)
    vals = rng.integers(-100, 924, size=cols.size)
    _post(srv.uri, "/index/i/field/v/import",
          {"columnIDs": cols.tolist(), "values": vals.tolist()})
    last = dict(zip(cols.tolist(), vals.tolist()))
    return srv, np.array(list(last.values()))


def test_concurrent_sums_coalesce(tmp_path):
    srv, vals = _bsi_server(tmp_path, np.random.default_rng(23))
    try:
        errors = []

        def client(seed: int) -> None:
            r = np.random.default_rng(seed)
            for _ in range(8):
                x = int(r.integers(-100, 924))
                status, out = _post(srv.uri, "/index/i/query",
                                    f"Sum(Range(v > {x}), field=v)")
                sel = vals[vals > x]
                want = {"value": int(sel.sum()), "count": int(sel.size)}
                if status != 200 or out["results"][0] != want:
                    errors.append((x, status, out, want))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert srv.executor.sum_batcher.max_batch_seen > 1
    finally:
        srv.close()


def test_unbatched_sums_answer_the_same(tmp_path, monkeypatch):
    """PILOSA_TPU_TORCH_BATCH=0 sends every Sum to one bsi_sum_counts call
    of its own."""
    from pilosa_tpu_torch.executor import Executor

    srv, vals = _bsi_server(tmp_path, np.random.default_rng(24))
    try:
        queries = ["Sum(field=v)", "Sum(Range(v < 0), field=v)",
                   "Sum(Range(v >< [10, 20]), field=v)"]
        want = [srv.executor.execute("i", q)[0] for q in queries]
        assert want[0].val == int(vals.sum())
        monkeypatch.setenv("PILOSA_TPU_TORCH_BATCH", "0")
        unbatched = Executor(srv.holder, device="cpu")
        assert unbatched.sum_batcher is None
        assert [unbatched.execute("i", q)[0] for q in queries] == want
    finally:
        srv.close()
