"""The port's dense PQL read path end to end, against the JAX server.

Both servers run in-process (the port on the CPU, through its kernels'
plain versions) and get the same create/import/Set/Clear traffic over
HTTP; a seeded list of Count and Row queries must then give identical JSON
responses. The port also serves a data dir the JAX server wrote.
"""

import http.client
import json
import sys
import threading
from urllib.parse import urlparse

import numpy as np
import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server

N_SHARDS = 4
SHARD_WIDTH = 1 << 20


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
    if not isinstance(body, (bytes, str)):
        body = json.dumps(body)
    return _call(uri, "POST", path, body.encode() if isinstance(body, str)
                 else body)


def _imports(rng) -> list:
    """(field, rowIDs, columnIDs) batches: dense rows (above the JAX
    package's 4096-bit sparse threshold per shard), sparse rows, and a
    row confined to one shard."""
    out = []
    for field, rows in (("f", range(6)), ("g", range(3))):
        for r in rows:
            card = 9000 if r % 2 == 0 else 700
            cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=card)
            out.append((field, [r] * card, cols.tolist()))
    cols = rng.integers(2 * SHARD_WIDTH, 3 * SHARD_WIDTH, size=500)
    out.append(("f", [7] * cols.size, cols.tolist()))
    return out


WRITES = [
    "Set(5, f=1)",
    "Set(5, f=1) Set(4194303, f=8) Clear(5, f=1) Set(77, g=2)",
    "Clear(4194303, f=8)",
    "Set(3145729, f=8) Set(12, f=0)",
    "Clear(999999999, g=1)",
]


def _row(rng, fields=("f", "g")) -> str:
    field = fields[int(rng.integers(len(fields)))]
    top = 8 if field == "f" else 3
    r = int(rng.integers(top)) if rng.random() < 0.9 else 99
    return f"Row({field}={r})"


def _bitmap(rng, depth: int = 0) -> str:
    kind = int(rng.integers(7)) if depth < 2 else 0
    if kind == 0:
        return _row(rng)
    if kind == 6:
        return f"Not({_bitmap(rng, depth + 1)})"
    name = ["Intersect", "Intersect", "Union", "Xor", "Difference"][kind - 1]
    n = int(rng.integers(2, 6)) if name == "Intersect" else \
        int(rng.integers(2, 4))
    return f"{name}({', '.join(_bitmap(rng, depth + 1) for _ in range(n))})"


def _queries() -> list:
    """Seeded (pql, shards) pairs: Count and Row over every call of the
    slice, 2- to 5-way Intersects, nesting, and ?shards= subsets."""
    rng = np.random.default_rng(7)
    fixed = ["Count(Row(f=0))", "Row(f=7)", "Count(Row(g=99))",
             "Count(Intersect(Row(f=0), Row(f=2)))",
             "Count(Intersect(Row(f=0), Row(f=2), Row(f=4)))",
             "Count(Intersect(Row(f=0), Row(f=1), Row(f=2), Row(f=3)))",
             "Count(Intersect(Row(f=0), Row(f=2), Row(f=4), Row(g=0), "
             "Row(g=2)))",
             "Count(Union(Row(f=1), Row(f=3)))", "Count(Xor(Row(f=0), "
             "Row(g=0)))", "Count(Difference(Row(f=0), Row(f=1), Row(f=2)))",
             "Count(Not(Row(f=0)))", "Not(Union(Row(f=0), Row(f=2)))",
             "Count(Union())", "Intersect(Row(f=8), Row(f=8))",
             "Count(Row(f=0)) Count(Row(f=1)) Row(f=8)"]
    # 40 Rows resolve to 40 leaves: wider than any fixed leaf table
    wide = ", ".join(f"Row(f={i % 8})" for i in range(40))
    fixed += [f"Count(Union({wide}))",
              f"Count(Xor(Row(g=0), Difference({wide})))"]
    out = [(q, None) for q in fixed]
    for i in range(40):
        body = _bitmap(rng)
        q = f"Count({body})" if i % 3 else body
        shards = None
        if i % 4 == 1:
            shards = sorted(rng.choice(N_SHARDS + 1, size=2, replace=False))
        out.append((q, shards))
    return out


def _ask(uri: str, index: str, queries: list) -> list:
    answers = []
    for q, shards in queries:
        path = f"/index/{index}/query"
        if shards is not None:
            path += "?shards=" + ",".join(str(s) for s in shards)
        answers.append(_post(uri, path, q))
    return answers


def _feed_and_ask(jax_uri: str, port_uri: str, queries: list) -> list:
    """Same traffic to both servers, identical JSON asserted; returns the
    JAX server's answers to `queries`."""
    rng = np.random.default_rng(3)
    traffic = [("/index/i", {"options": {"trackExistence": True}}),
               ("/index/i/field/f", {"options": {"type": "set"}}),
               ("/index/i/field/g", {})]
    traffic += [(f"/index/i/field/{f}/import", {"rowIDs": r, "columnIDs": c})
                for f, r, c in _imports(rng)]
    traffic += [("/index/i/query", w) for w in WRITES]
    traffic += [("/index/i/field/g/import",
                 {"rowIDs": [2, 2], "columnIDs": [77, 78], "clear": True})]
    for path, body in traffic:
        want = _post(jax_uri, path, body)
        assert want[0] == 200, want
        assert _post(port_uri, path, body) == want, (path, body)
    assert _call(port_uri, "GET", "/schema") == _call(jax_uri, "GET", "/schema")
    want = _ask(jax_uri, "i", queries)
    got = _ask(port_uri, "i", queries)
    for (q, shards), g, w in zip(queries, got, want):
        assert w[0] == 200, (q, w)
        assert g == w, (q, shards)
    return want


def test_port_answers_like_the_jax_server(tmp_path):
    queries = _queries()
    assert len(queries) >= 40
    jax_dir = str(tmp_path / "jax")
    jax_srv = JaxServer(jax_dir, port=0).open()
    try:
        port_srv = Server(str(tmp_path / "torch"), port=0, device="cpu").open()
        try:
            want = _feed_and_ask(jax_srv.uri, port_srv.uri, queries)
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


def test_concurrent_counts_coalesce(tmp_path):
    srv = Server(str(tmp_path / "c"), port=0, device="cpu").open()
    try:
        _post(srv.uri, "/index/i", {})
        _post(srv.uri, "/index/i/field/f", {})
        rng = np.random.default_rng(5)
        for r in range(4):
            # above 4096 bits per shard: dense leaves, which the batcher takes
            cols = rng.integers(0, 2 * SHARD_WIDTH, size=12000).tolist()
            _post(srv.uri, "/index/i/field/f/import",
                  {"rowIDs": [r] * len(cols), "columnIDs": cols})
        want = {}
        for a in range(4):
            for b in range(4):
                q = f"Count(Intersect(Row(f={a}), Row(f={b})))"
                want[q] = _post(srv.uri, "/index/i/query", q)[1]["results"][0]
        errors = []

        def client(seed: int) -> None:
            r = np.random.default_rng(seed)
            for _ in range(12):
                q = (f"Count(Intersect(Row(f={int(r.integers(4))}), "
                     f"Row(f={int(r.integers(4))})))")
                status, out = _post(srv.uri, "/index/i/query", q)
                if status != 200 or out["results"][0] != want[q]:
                    errors.append((q, status, out))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]  # more clients than cores
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # interleave the batcher's threads hard
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert srv.executor.batcher.max_batch_seen > 1
    finally:
        srv.close()


def test_unbatched_counts_answer_the_same(tmp_path, monkeypatch):
    """PILOSA_TPU_TORCH_BATCH=0 sends every Count to the runner (the 2-leaf
    AND through intersect_count, the rest through program_count)."""
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder

    holder = Holder(str(tmp_path / "d")).open()
    try:
        idx = holder.create_index("i")
        f = idx.create_field("f")
        rng = np.random.default_rng(11)
        for r in range(3):
            # above 4096 bits per shard: dense leaves, as the batcher needs
            cols = rng.integers(0, 2 * SHARD_WIDTH, size=12000)
            f.import_bits(np.full(cols.size, r), cols)
            idx.mark_exists(cols)
        queries = ["Count(Intersect(Row(f=0), Row(f=1)))", "Count(Row(f=2))",
                   "Count(Not(Row(f=1)))", "Count(Xor(Row(f=0), Row(f=2)))"]
        batched = Executor(holder, device="cpu")
        assert batched.batcher is not None
        want = [batched.execute("i", q)[0] for q in queries]
        monkeypatch.setenv("PILOSA_TPU_TORCH_BATCH", "0")
        unbatched = Executor(holder, device="cpu")
        assert unbatched.batcher is None
        assert [unbatched.execute("i", q)[0] for q in queries] == want
    finally:
        holder.close()
