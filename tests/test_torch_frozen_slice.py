"""The frozen bulk loads end to end, against the JAX server.

Both servers run in-process (the port on the CPU, through its kernels'
plain versions). Each gets the same fields over HTTP and then the same
frozen loads on its holder (Field.import_rows_frozen, View.
load_frozen_fragment, Field.import_values_frozen) at small sizes of the
shapes of benches/scale_configs.py and examples/similarity.py; every query
must give identical JSON: Count over Union/Intersect/Xor/Difference, TopN
with and without a Src and a Tanimoto threshold (the sparse host walk),
the dense fallback after a Set into a candidate row, Rows paging, and
Sum/Min/Max with filters. Concurrent Min/Max go through the port's
MinMaxBatcher, and /debug/vars (minMaxBatcher, volatileFragments) and
/metrics (batcher/minMax) carry what the JAX server's do.
"""

import sys
import threading

import numpy as np
import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server

from test_torch_obs_slice import _call, _families, _post

SHARD_WIDTH = 1 << 20
FP_BITS, FP_PER_MOL, N_MOL = 2048, 48, 3000


def _config2(rng):
    """64 head rows of 200 bits over 10K columns, then 1-bit tail rows."""
    head_rows = np.repeat(np.arange(64, dtype=np.uint64), 200)
    head_cols = rng.integers(0, 10_000, head_rows.size).astype(np.uint64)
    tail_rows = np.arange(64, 30_000, dtype=np.uint64)
    tail_cols = rng.integers(0, 10_000, tail_rows.size).astype(np.uint64)
    return (np.concatenate([head_rows, tail_rows]),
            np.concatenate([head_cols, tail_cols]))


def _config3(rng, n_shards: int = 4, head: int = 500, rows: int = 40_000):
    """Per shard: a Zipf head's share of bits and a 1-bit tail striped
    over the shards (row r -> shard r % n_shards)."""
    head_n = np.maximum(np.minimum(200, rows // (10 * (np.arange(head) + 1))),
                        1)
    head_rows = np.repeat(np.arange(head, dtype=np.uint64), head_n)
    w = np.uint64(SHARD_WIDTH)
    out = []
    for s in range(n_shards):
        h = head_rows[rng.integers(0, n_shards, head_rows.size) == s]
        hc = rng.integers(0, SHARD_WIDTH, h.size).astype(np.uint64)
        t = np.arange(head + s, rows, n_shards, dtype=np.uint64)
        tc = rng.integers(0, SHARD_WIDTH, t.size).astype(np.uint64)
        out.append(np.unique(np.concatenate([h * w + hc, t * w + tc])))
    return out


def _fingerprints(rng, n: int = N_MOL):
    """examples/similarity.py's corpus, vectorized: families of 100, 75 %
    of a family motif kept, noise bits up to 48."""
    n_fam = max(n // 100, 1)
    motifs = np.argsort(rng.random((n_fam, FP_BITS)), axis=1)[:, :FP_PER_MOL]
    fam = np.arange(n) % n_fam
    keep = rng.random((n, FP_PER_MOL)) < 0.75
    noise = rng.integers(0, FP_BITS, (n, FP_PER_MOL))
    bits = np.where(keep, motifs[fam], noise)
    rows = np.repeat(np.arange(n, dtype=np.uint64), FP_PER_MOL)
    return rows, bits.reshape(-1).astype(np.uint64)


def _load(holder, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    idx = holder.index("c")
    idx.field("f").import_rows_frozen(*_config2(rng))
    t = idx.field("t")
    tv = t.create_view_if_not_exists("standard")
    for s, pos in enumerate(_config3(rng)):
        tv.load_frozen_fragment(s, pos)
        if hasattr(t, "add_available_shard"):  # the JAX field
            t.add_available_shard(s)
        else:
            t.add_available_shards([s])
    n = 2 * 4096
    cols = np.concatenate([np.arange(n), SHARD_WIDTH + np.arange(n)])
    vals = rng.integers(0, 1024, cols.size)
    idx.field("v").import_values_frozen(cols.astype(np.uint64), vals)
    idx.field("fp").import_rows_frozen(*_fingerprints(rng))
    rows_l, cols_l = [], []
    for r in range(3000):  # tests/test_topn.py:256-264
        c = np.unique(rng.integers(0, 2 * SHARD_WIDTH, 40))
        rows_l.append(np.full(c.size, r, dtype=np.uint64))
        cols_l.append(c.astype(np.uint64))
    idx.field("fz").import_rows_frozen(np.concatenate(rows_l),
                                       np.concatenate(cols_l))


SCHEMA = [("/index/c", {"options": {"trackExistence": False}}),
          ("/index/c/field/f", {"options": {"type": "set"}}),
          ("/index/c/field/t", {"options": {"type": "set"}}),
          ("/index/c/field/v", {"options": {"type": "int", "min": 0,
                                            "max": 1023}}),
          ("/index/c/field/fp", {"options": {"type": "set",
                                             "cacheSize": N_MOL}}),
          ("/index/c/field/fz", {"options": {"type": "set",
                                             "cacheSize": 5000}})]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frozen")
    jax_srv = JaxServer(str(tmp / "jax"), port=0).open()
    port_srv = Server(str(tmp / "torch"), port=0, device="cpu").open()
    try:
        for path, body in SCHEMA:
            want = _post(jax_srv.uri, path, body)
            assert want[0] == 200, (path, want)
            assert _post(port_srv.uri, path, body) == want, path
        _load(jax_srv.holder, 5)
        _load(port_srv.holder, 5)
        yield jax_srv, port_srv
    finally:
        port_srv.close()
        jax_srv.close()


def _same(jax_srv, port_srv, queries):
    for q in queries:
        w = _post(jax_srv.uri, "/index/c/query", q)
        assert w[0] == 200, (q, w)
        assert _post(port_srv.uri, "/index/c/query", q) == w, q
    return w


QUERIES = {
    "config2": ["Count(Union(Row(f=0), Row(f=1)))",
                "Count(Intersect(Row(f=0), Row(f=1)))",
                "Count(Xor(Row(f=2), Row(f=3)))",
                "Count(Difference(Row(f=0), Row(f=1)))",
                "Count(Row(f=29999))", "Row(f=5)", "TopN(f, n=10)"],
    "config3": ["TopN(t, n=50)", "TopN(t, n=5, threshold=100)",
                "Rows(field=t, limit=10)",
                "Rows(field=t, previous=100, limit=10)",
                "Rows(field=t, previous=39990, limit=10)",
                "Count(Row(t=0))", "TopN(t, Row(t=1), n=10)"],
    "config4": ["Sum(Range(v > 511), field=v)", "Min(field=v)",
                "Max(field=v)", "Sum(field=v)",
                "Min(Range(v > 700), field=v)", "Max(Range(v < 300), field=v)",
                "Min(Row(t=0), field=v)", "Max(Row(t=3), field=v)",
                "Count(Range(v >< [100, 200]))"],
    "similarity": ["TopN(fp, Row(fp=7), n=20)",
                   "TopN(fp, Row(fp=7), n=20, tanimotoThreshold=90)",
                   "TopN(fp, Row(fp=7), n=20, tanimotoThreshold=70)",
                   "TopN(fp, Row(fp=7), n=20, tanimotoThreshold=50)",
                   "TopN(fp, Row(fp=123), n=0, tanimotoThreshold=60)",
                   "TopN(fp, Row(fp=7), ids=[7, 107, 9], n=3)"],
}


@pytest.mark.parametrize("config", sorted(QUERIES))
def test_frozen_loads_answer_like_the_jax_server(servers, config):
    _same(*servers, QUERIES[config])


def test_similarity_takes_the_sparse_walk(servers, monkeypatch):
    """Every candidate of a Src TopN over frozen fragments is recounted on
    the host, once; no topn_counts_packed call."""
    _, port_srv = servers
    from pilosa_tpu_torch.ops import kernels

    calls = []
    monkeypatch.setattr(kernels, "topn_counts_packed",
                        lambda *a: calls.append(a))
    ex = port_srv.executor
    before = ex.topn_recount_rows
    (pairs,) = ex.execute("c", "TopN(fp, Row(fp=7), n=20)")
    assert not calls and len(pairs) == 20
    assert ex.topn_recount_rows - before == N_MOL
    (pairs,) = ex.execute("c", "TopN(fp, Row(fp=7), n=20, "
                               "tanimotoThreshold=70)")
    assert not calls


def test_fallback_after_a_set_into_a_candidate(servers):
    """A Set into a frozen candidate row moves it into the overlay; the
    walk then goes densely (topn_counts_packed) and still answers as the
    JAX server does (tests/test_topn.py:275-285)."""
    jax_srv, port_srv = servers
    from pilosa_tpu_torch.ops import kernels

    q = "TopN(fz, Row(fz=7), n=15)"
    _same(jax_srv, port_srv, [q, q.replace(")", ", tanimotoThreshold=30)",
                                           1)])
    _same(jax_srv, port_srv, [f"Set({2 * SHARD_WIDTH - 1}, fz=7)"])
    real = kernels.topn_counts_packed
    calls = []

    def spy(*a):
        calls.append(len(a[0]))
        return real(*a)

    kernels.topn_counts_packed = spy
    try:
        _same(jax_srv, port_srv, [q, "TopN(fz, Row(fz=7), n=15, "
                                     "tanimotoThreshold=30)"])
    finally:
        kernels.topn_counts_packed = real
    assert calls


def test_concurrent_min_max_batch_like_the_jax_server(servers):
    """12 concurrent Min/Max per server (tests/test_batcher.py:268-310),
    each answer equal to the JAX server's, the port's through the
    MinMaxBatcher."""
    jax_srv, port_srv = servers
    qs = [f"{'Min' if i % 2 else 'Max'}(Range(v > {40 * i}), field=v)"
          for i in range(12)]
    want = {q: _post(jax_srv.uri, "/index/c/query", q) for q in qs}
    before = port_srv.executor.minmax_batcher.snapshot()["batched_queries"]
    got = {}
    start = threading.Barrier(len(qs))

    def worker(q):
        start.wait()
        got[q] = _post(port_srv.uri, "/index/c/query", q)

    threads = [threading.Thread(target=worker, args=(q,)) for q in qs]
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
    assert got == want
    snap = port_srv.executor.minmax_batcher.snapshot()
    assert snap["batched_queries"] - before == len(qs)


def test_debug_vars_and_metrics(servers):
    jax_srv, port_srv = servers
    _same(jax_srv, port_srv, ["Min(field=v)", "Max(field=v)"])
    _, j = _call(jax_srv.uri, "GET", "/debug/vars")
    _, t = _call(port_srv.uri, "GET", "/debug/vars")
    assert set(t["minMaxBatcher"]) == set(j["minMaxBatcher"])
    assert t["minMaxBatcher"]["batched_queries"] > 0

    def vol(doc):
        return sorted((v["field"], v["view"], v["shard"], v["mutations"])
                      for v in doc["volatileFragments"])

    assert vol(t) == vol(j)
    assert {(f, v) for f, v, _, _ in vol(t)} >= {
        ("f", "standard"), ("t", "standard"), ("v", "bsig_v"),
        ("fp", "standard"), ("fz", "standard")}
    _, jtext = _call(jax_srv.uri, "GET", "/metrics")
    _, ttext = _call(port_srv.uri, "GET", "/metrics")
    jt, jv = _families(jtext)
    tt, tv = _families(ttext)
    fam = "pilosa_batcher_total"
    keys = {k for k in jv[fam] if "minMax" in str(k)}
    assert keys and keys == {k for k in tv[fam] if "minMax" in str(k)}
    assert [k for k in tv["pilosa_batcher"] if "minMax" in str(k)]


def test_snapshot_ends_volatility(servers):
    """A snapshotted frozen fragment reopens through the frozen parse
    (it holds more than FROZEN_PARSE_MIN containers), answers the same and
    leaves volatileFragments."""
    import pilosa_tpu_torch.storage.frozen as tfz

    jax_srv, port_srv = servers
    q = "TopN(fp, Row(fp=7), n=20, tanimotoThreshold=50)"
    want = _post(jax_srv.uri, "/index/c/query", q)
    for srv in servers:
        srv.holder.index("c").field("fp").view("standard").fragment(
            0).snapshot()
    frag = port_srv.holder.index("c").field("fp").view("standard").fragment(0)
    frag.close()
    tfz_min = tfz.FROZEN_PARSE_MIN
    tfz.FROZEN_PARSE_MIN = 1000  # the similarity field holds 3000 rows
    try:
        frag.open()
    finally:
        tfz.FROZEN_PARSE_MIN = tfz_min
    assert isinstance(frag.storage.containers, tfz.FrozenContainers)
    assert _post(port_srv.uri, "/index/c/query", q) == want
    for srv in servers:
        _, doc = _call(srv.uri, "GET", "/debug/vars")
        assert ("fp", "standard") not in {
            (v["field"], v["view"]) for v in doc["volatileFragments"]}
