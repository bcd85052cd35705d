"""The port's TopN, Rows and GroupBy end to end, against the JAX server.

Both servers run in-process (the port on the CPU, through its kernels'
plain versions) and get the same HTTP traffic: set fields with a Zipf-like
spread of row sizes over 3 shards (one ranked with the default cache size,
one ranked with a cache of 4 rows so eviction and the merged-count
recount run, one LRU, one without a cache), an int field for Range
filters, JSON imports, Set/Clear and clearing imports between rounds of
queries. Every JSON response must be the JAX server's. Both executors
prune GroupBy chunks with a live bound of 3, so the overflow refetch runs.
The multi-axis GroupBys run mostly in the last round: the JAX package
pads each level to 512 prefixes, seconds per query on a CPU.

The rank caches travel between the packages in the `.cache` files beside
the fragments: a data dir one package wrote and closed, then the other
wrote and closed, must give the first package TopN answers that match
the bits.
"""

import http.client
import json
from urllib.parse import urlparse

import numpy as np

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server

N_SHARDS = 3
SHARD_WIDTH = 1 << 20
N_COLS = N_SHARDS * SHARD_WIDTH


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


def _ask(uri: str, queries: list) -> list:
    out = []
    for q, shards in queries:
        path = "/index/i/query"
        if shards is not None:
            path += "?shards=" + ",".join(str(s) for s in shards)
        out.append(_post(uri, path, q))
    return out


def _zipf_row(rng, r: int, top: int, skew_shard=None) -> np.ndarray:
    """About top / (r + 1) distinct columns; skewed rows put 80 % of them
    in one shard, so the shards' caches rank differently."""
    card = max(top // (r + 1), 3)
    cols = rng.integers(0, N_COLS, size=card)
    if skew_shard is not None:
        k = int(card * 0.8)
        cols[:k] = skew_shard * SHARD_WIDTH + rng.integers(0, SHARD_WIDTH,
                                                           size=k)
    return np.unique(cols)


def _imports(rng) -> list:
    """(field, rows, columns) JSON import batches."""
    out = []
    t_rows = {r: _zipf_row(rng, r, 4000, r % N_SHARDS if r % 2 else None)
              for r in range(20)}
    for r, cols in t_rows.items():
        out.append(("t", r, cols))
    for r in range(4):
        cols = np.unique(rng.integers(0, N_COLS, size=3000 + 700 * r))
        if r == 3:  # close to t's row 2: Tanimoto scores that clear a bar
            cols = np.union1d(t_rows[2], cols[:300])
        out.append(("f", r, cols))
    for r in range(12):
        shard = (r * 5) % N_SHARDS
        cols = np.concatenate([
            rng.integers(0, N_COLS, size=40 + 9 * r),
            shard * SHARD_WIDTH + rng.integers(0, SHARD_WIDTH,
                                               size=300 - 20 * r)])
        out.append(("g", r, np.unique(cols)))
    for r in range(9):
        out.append(("l", r, _zipf_row(rng, r, 900)))
    for r in range(3):
        out.append(("z", r, _zipf_row(rng, r, 500)))
    return out


def _queries(col_t: int, col_f: int) -> list:
    rng = np.random.default_rng(31)
    qs = [
        "TopN(t, n=5)", "TopN(t)", "TopN(t, n=0)", "TopN(g, n=3)", "TopN(g)",
        "TopN(l, n=4)", "TopN(z, n=3)",
        "TopN(t, Row(f=0), n=5)",
        "TopN(t, Intersect(Row(f=1), Row(f=2)), n=4)",
        "TopN(t, Not(Row(f=3)), n=6)",
        "TopN(t, Range(v > 500), n=5)",
        "TopN(g, Row(f=0), n=3)",
        "TopN(g, Union(Row(f=1), Row(f=2)))",
        "TopN(t, Row(f=1), n=5, tanimotoThreshold=5)",
        "TopN(t, Row(f=3), n=3, tanimotoThreshold=50)",
        "TopN(t, Row(f=3), tanimotoThreshold=80)",
        "TopN(t, threshold=500)",
        "TopN(t, Row(f=0), threshold=20, n=10)",
        "TopN(t, ids=[0, 3, 7, 19, 99])",
        "TopN(t, Row(f=2), ids=[1, 2, 5, 15])",
        "TopN(t, Row(f=3), ids=[2, 4, 6], tanimotoThreshold=30)",
        "Rows(field=t)", "Rows(field=t, limit=5, previous=3)",
        f"Rows(field=t, column={col_t})", "Rows(field=g, limit=3)",
        "Rows(field=t, previous=18)", f"Rows(field=f, column={col_f})",
        "GroupBy(Rows(field=t))", "GroupBy(Rows(field=t), filter=Row(f=1))",
        "GroupBy(Rows(field=t, previous=100), Rows(field=f))",
        "GroupBy(Rows(field=f), Rows(field=t), limit=0)",
    ]
    out = [(q, None) for q in qs]
    for q in ("TopN(t, n=3)", "TopN(g, Row(f=1), n=4)", "Rows(field=g)"):
        out.append((q, sorted(rng.choice(N_SHARDS, size=2, replace=False)
                              .tolist())))
    return out


def _group_queries() -> list:
    """The multi-axis GroupBys (the cross_count_matrix levels)."""
    qs = [
        "GroupBy(Rows(field=f), Rows(field=t))",
        "GroupBy(Rows(field=f), Rows(field=t), limit=20)",
        "GroupBy(Rows(field=f), Rows(field=t), filter=Range(v > 500))",
        "GroupBy(Rows(field=f), Rows(field=g), Rows(field=t, limit=5), "
        "limit=30)",
        "GroupBy(Rows(field=f), Rows(field=t, limit=8), Row(f=2))",
        "GroupBy(Rows(field=f, limit=2), Rows(field=t, previous=10), "
        "Rows(field=f, previous=1))",
    ]
    return [(q, None) for q in qs] + [
        ("GroupBy(Rows(field=f), Rows(field=g), limit=7)", [0, 2])]


def _writes(rng, rnd: int) -> list:
    """(path, body) writes between rounds of queries: single bits (the
    rank cache's add path, evicting from g's 4-row cache), a JSON import
    that makes a new top row, and a clearing import."""
    cols = rng.integers(0, N_COLS, size=40).tolist()
    sets = " ".join(f"Set({c}, g={12 + rnd})" for c in cols)
    out = [("/index/i/query", sets),
           ("/index/i/query", f"Clear({cols[0]}, g={12 + rnd}) "
                              f"Set({cols[1]}, t=19) Set({cols[2]}, l=8)"),
           ("/index/i/field/t/import",
            {"rowIDs": [15 + rnd] * 6000,
             "columnIDs": rng.integers(0, N_COLS, size=6000).tolist()}),
           ("/index/i/field/t/import",
            {"rowIDs": [0] * 3000,
             "columnIDs": rng.integers(0, N_COLS, size=3000).tolist(),
             "clear": True})]
    return out


def test_port_answers_topn_rows_groupby_like_the_jax_server(tmp_path):
    rng = np.random.default_rng(5)
    batches = _imports(rng)
    col_t = int(batches[0][2][7])
    col_f = int(batches[20][2][3])
    setup = [("/index/i", {"options": {"trackExistence": True}}),
             ("/index/i/field/t", {"options": {"type": "set"}}),
             ("/index/i/field/f", {}),
             ("/index/i/field/g", {"options": {"cacheType": "ranked",
                                               "cacheSize": 4}}),
             ("/index/i/field/l", {"options": {"cacheType": "lru",
                                               "cacheSize": 5}}),
             ("/index/i/field/z", {"options": {"cacheType": "none"}}),
             ("/index/i/field/v", {"options": {"type": "int", "min": 0,
                                               "max": 1000}})]
    setup += [(f"/index/i/field/{f}/import",
               {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()})
              for f, r, cols in batches]
    vcols = rng.integers(0, N_COLS, size=20000)
    setup.append(("/index/i/field/v/import",
                  {"columnIDs": vcols.tolist(),
                   "values": rng.integers(0, 1001, size=vcols.size).tolist()}))
    light = _queries(col_t, col_f)
    jax_srv = JaxServer(str(tmp_path / "jax"), port=0).open()
    port_srv = Server(str(tmp_path / "torch"), port=0, device="cpu").open()
    try:
        jax_srv.executor._groupby_live_cap = 3
        port_srv.executor.groupby_live_cap = 3
        asked = 0
        for rnd in range(3):
            queries = light + _group_queries()[:(2, 0, 7)[rnd]]
            traffic = setup if rnd == 0 else _writes(rng, rnd)
            for path, body in traffic:
                want = _post(jax_srv.uri, path, body)
                assert want[0] == 200, (path, want)
                assert _post(port_srv.uri, path, body) == want, path
            want = _ask(jax_srv.uri, queries)
            got = _ask(port_srv.uri, queries)
            for (q, shards), g, w in zip(queries, got, want):
                assert w[0] == 200, (q, w)
                assert g == w, (rnd, q, shards)
            asked += len(queries)
            # non-empty answers of every kind were compared
            kinds = {q.split("(")[0] for (q, _), (_, body) in zip(queries,
                                                                  got)
                     if body["results"][0]}
            assert kinds == {"TopN", "Rows", "GroupBy"}
        assert asked >= 60
        ex = port_srv.executor
        assert ex.topn_recount_rows > 0 and ex.groupby_host_syncs > 0
    finally:
        port_srv.close()
        jax_srv.close()


def _topn_oracle(rows: dict) -> list:
    """TopN(t) of {row: set of columns}: count desc, id asc, no zeros."""
    pairs = sorted(((len(c), r) for r, c in rows.items() if c),
                   key=lambda x: (-x[0], x[1]))
    return [{"id": r, "count": n} for n, r in pairs]


def _import(uri: str, rows: dict, row: int, cols, clear=False) -> None:
    cols = [int(c) for c in cols]
    st = _post(uri, "/index/i/field/t/import",
               {"rowIDs": [row] * len(cols), "columnIDs": cols,
                "clear": clear})
    assert st[0] == 200, st
    if clear:
        rows[row] -= set(cols)
    else:
        rows.setdefault(row, set()).update(cols)


def _set_bits(uri: str, rows: dict, row: int, cols) -> None:
    pql = " ".join(f"Set({int(c)}, t={row})" for c in cols)
    assert _post(uri, "/index/i/query", pql)[0] == 200
    rows.setdefault(row, set()).update(int(c) for c in cols)


def _topn(uri: str, n=None) -> list:
    q = "TopN(t)" if n is None else f"TopN(t, n={n})"
    st, body = _post(uri, "/index/i/query", q)
    assert st == 200, body
    return body["results"][0]


def _round_trip(tmp_path, first, second) -> None:
    """`first` creates t, imports rows 0..9 and closes; `second` opens the
    same dir, writes two new top rows (a bulk import and single Sets) and
    closes; `first` reopens: its TopN must match the bits."""
    rng = np.random.default_rng(17)
    data = str(tmp_path / "d")
    rows: dict = {}
    srv = first(data)
    try:
        assert _post(srv.uri, "/index/i", {})[0] == 200
        assert _post(srv.uri, "/index/i/field/t", {})[0] == 200
        for r in range(10):
            _import(srv.uri, rows, r,
                    rng.integers(0, 2 * SHARD_WIDTH, size=1000 - 90 * r))
        assert _topn(srv.uri) == _topn_oracle(rows)
    finally:
        srv.close()
    srv = second(data)
    try:
        _import(srv.uri, rows, 50, rng.integers(0, 2 * SHARD_WIDTH,
                                                size=3000))
        _set_bits(srv.uri, rows, 60, rng.integers(0, 2 * SHARD_WIDTH,
                                                  size=1500))
        _import(srv.uri, rows, 1, sorted(rows[1])[:400], clear=True)
        assert _topn(srv.uri) == _topn_oracle(rows)
    finally:
        srv.close()
    srv = first(data)
    try:
        assert _topn(srv.uri, 3) == _topn_oracle(rows)[:3]
        assert _topn(srv.uri) == _topn_oracle(rows)
    finally:
        srv.close()


def _jax(data: str):
    return JaxServer(data, port=0).open()


def _port(data: str):
    return Server(data, port=0, device="cpu").open()


def test_rank_caches_survive_port_writes_for_the_jax_package(tmp_path):
    """The JAX package reopens what the port wrote: the port must keep and
    save the rank caches, or the JAX package ranks from stale ones."""
    _round_trip(tmp_path, _jax, _port)


def test_rank_caches_survive_jax_writes_for_the_port(tmp_path):
    _round_trip(tmp_path, _port, _jax)
