"""The port's hybrid sparse/run/dense leaves end to end, against the JAX
server.

Both servers run in-process (the port on the CPU, through its kernels'
plain versions) with their default thresholds (4096 bits per shard for
sparse leaves, 2048 intervals for run leaves), over 4 shards: sparse rows
(under 4096 bits per shard), runny rows (two contiguous ranges of 3000
bits per shard), dense rows, and an index whose existence row is runny.
A seeded list of Count, Row, Intersect, Union, Xor, Difference and Not
queries, some over ?shards= subsets, with writes between them, must give
identical JSON. The port must have uploaded sparse and run leaves; with
both thresholds 0 it answers the same from dense leaves only.
"""

import http.client
import json
from urllib.parse import urlparse

import numpy as np
import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server

N_SHARDS = 4
SHARD_WIDTH = 1 << 20
# (index, field) -> row ids by form
ROWS = {("i", "f"): {"sparse": [0, 1, 2, 3], "run": [4, 5], "dense": [6, 7]},
        ("i", "g"): {"sparse": [0], "run": [1], "dense": [2]},
        ("j", "h"): {"sparse": [2], "run": [0, 1], "dense": []}}


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


def _row_cols(rng, form: str) -> np.ndarray:
    out = []
    for s in range(N_SHARDS):
        base = s * SHARD_WIDTH
        if form == "sparse":
            n = int(rng.integers(30, 3000))
            c = rng.choice(SHARD_WIDTH, size=n, replace=False)
        elif form == "run":
            a, b = sorted(rng.choice(SHARD_WIDTH // 4096 - 1, size=2,
                                     replace=False) * 4096)
            c = np.concatenate([np.arange(a, a + 3000),
                                np.arange(b, b + 3000)])
        else:
            c = rng.choice(SHARD_WIDTH, size=12000, replace=False)
        out.append(c + base)
    return np.concatenate(out)


def _setup() -> list:
    """(path, body) of the schema and imports."""
    rng = np.random.default_rng(41)
    out = [("/index/i", {"options": {"trackExistence": True}}),
           ("/index/i/field/f", {}), ("/index/i/field/g", {}),
           ("/index/j", {"options": {"trackExistence": True}}),
           ("/index/j/field/h", {})]
    for (index, field), forms in ROWS.items():
        for form, ids in forms.items():
            for r in ids:
                cols = _row_cols(rng, form)
                out.append((f"/index/{index}/field/{field}/import",
                            {"rowIDs": [r] * cols.size,
                             "columnIDs": cols.tolist()}))
    return out


def _row(rng, index: str) -> str:
    if index == "j":
        return f"Row(h={int(rng.integers(3))})"
    field = "f" if rng.random() < 0.7 else "g"
    top = 8 if field == "f" else 3
    r = int(rng.integers(top)) if rng.random() < 0.93 else 99
    return f"Row({field}={r})"


def _bitmap(rng, index: str, depth: int = 0) -> str:
    kind = int(rng.integers(7)) if depth < 2 else 0
    if kind == 0:
        return _row(rng, index)
    if kind == 6:
        return f"Not({_bitmap(rng, index, depth + 1)})"
    name = ["Intersect", "Intersect", "Union", "Xor", "Difference"][kind - 1]
    n = int(rng.integers(2, 4))
    return f"{name}({', '.join(_bitmap(rng, index, depth + 1) for _ in range(n))})"


FIXED = [
    ("i", "Count(Row(f=0))"), ("i", "Row(f=1)"), ("i", "Count(Row(f=4))"),
    ("i", "Count(Intersect(Row(f=0), Row(f=6)))"),       # sparse ∩ dense
    ("i", "Count(Intersect(Row(f=7), Row(f=1)))"),       # dense ∩ sparse
    ("i", "Intersect(Row(f=2), Row(f=6))"),
    ("i", "Count(Intersect(Row(f=0), Row(f=1)))"),       # sparse ∩ sparse
    ("i", "Count(Union(Row(f=0), Row(f=1)))"),
    ("i", "Count(Xor(Row(f=2), Row(f=3)))"),
    ("i", "Count(Difference(Row(f=0), Row(f=6)))"),      # sparse &~ dense
    ("i", "Count(Difference(Row(f=4), Row(f=0)))"),      # run &~ sparse
    ("i", "Count(Not(Row(f=0)))"),
    ("i", "Count(Intersect(Row(f=0), Row(f=4)))"),       # sparse ∩ run
    ("i", "Count(Intersect(Row(f=4), Row(f=6)))"),       # run ∩ dense
    ("i", "Count(Intersect(Row(f=4), Row(f=5)))"),       # run ∩ run
    ("i", "Count(Intersect(Row(f=4), Row(f=5), Row(g=1)))"),
    ("i", "Intersect(Row(f=4), Row(g=1))"),
    ("i", "Count(Union(Row(f=4), Row(f=0)))"),
    ("i", "Count(Intersect(Row(f=0), Row(f=99)))"),
    ("j", "Count(Not(Row(h=2)))"),                        # run existence
    ("j", "Not(Row(h=0))"),
    ("j", "Count(Intersect(Row(h=0), Row(h=2)))"),
]

WRITES = [
    ("i", "Set(5, f=0) Set(3145729, f=0) Clear(5, f=6)"),
    ("i", "Set(3000000, f=4) Clear(4194303, f=7)"),
    ("j", "Set(12, h=2) Set(1048577, h=0)"),
    ("i", "Clear(5, f=0) Set(77, g=0) Set(78, g=1)"),
    ("i", "Set(2097160, f=3)"),
]


def _traffic() -> list:
    """Seeded (index, pql, shards) queries with a write every 12 items."""
    rng = np.random.default_rng(8)
    queries = [(i, q, None) for i, q in FIXED]
    for n in range(44):
        index = "j" if n % 5 == 4 else "i"
        body = _bitmap(rng, index)
        q = f"Count({body})" if n % 3 else body
        shards = None
        if n % 4 == 1:
            shards = sorted(rng.choice(N_SHARDS + 1, size=2, replace=False))
        queries.append((index, q, shards))
    out = []
    writes = iter(WRITES)
    for k, item in enumerate(queries):
        if k and k % 12 == 0:
            w = next(writes, None)
            if w is not None:
                out.append(("write",) + w)
        out.append(("query",) + item)
    return out


def _query_path(index: str, shards) -> str:
    path = f"/index/{index}/query"
    if shards is not None:
        path += "?shards=" + ",".join(str(s) for s in shards)
    return path


def _final_queries() -> list:
    return [(i, q, None) for i, q in FIXED] + [
        ("i", "Count(Xor(Row(f=4), Row(f=6), Row(f=1)))", [0, 2]),
        ("i", "Difference(Row(f=3), Row(f=5))", [1, 2, 3])]


def test_port_answers_like_the_jax_server_with_hybrid_leaves(tmp_path):
    traffic = _traffic()
    assert sum(t[0] == "query" for t in traffic) >= 60
    port_dir = str(tmp_path / "torch")
    jax_srv = JaxServer(str(tmp_path / "jax"), port=0).open()
    try:
        port_srv = Server(port_dir, port=0, device="cpu").open()
        try:
            for path, body in _setup():
                want = _post(jax_srv.uri, path, body)
                assert want[0] == 200, want
                assert _post(port_srv.uri, path, body) == want, path
            for kind, index, pql, *rest in traffic:
                path = (_query_path(index, rest[0]) if kind == "query"
                        else f"/index/{index}/query")
                want = _post(jax_srv.uri, path, pql)
                assert want[0] == 200, (pql, want)
                assert _post(port_srv.uri, path, pql) == want, (pql, rest)
            final = [_post(jax_srv.uri, _query_path(i, s), q)
                     for i, q, s in _final_queries()]
            for (i, q, s), want in zip(_final_queries(), final):
                assert _post(port_srv.uri, _query_path(i, s), q) == want, q
            snap = port_srv.executor.hybrid_snapshot()
            assert snap["sparseUploads"] >= 1 and snap["runUploads"] >= 1
            assert snap["residentSparseLeaves"] >= 1
            assert snap["residentRunLeaves"] >= 1
        finally:
            port_srv.close()
    finally:
        jax_srv.close()
    # both forms off: the same answers from dense leaves only
    dense_srv = Server(port_dir, port=0, device="cpu", sparse_threshold=0,
                       run_threshold=0).open()
    try:
        for (i, q, s), want in zip(_final_queries(), final):
            assert _post(dense_srv.uri, _query_path(i, s), q) == want, q
        snap = dense_srv.executor.hybrid_snapshot()
        assert snap["sparseUploads"] == 0 and snap["runUploads"] == 0
        assert snap["denseUploads"] >= 1
    finally:
        dense_srv.close()


def test_thresholds_must_not_be_negative(tmp_path):
    for kw in ({"sparse_threshold": -1}, {"run_threshold": -5}):
        with pytest.raises(ValueError, match="threshold"):
            Server(str(tmp_path / "x"), device="cpu", **kw)
