"""A mesh-backed port server against the JAX package's mesh server.

Three servers run in-process on the CPU: the JAX server over a 2 x 4
mesh of the 8 virtual devices tests/conftest.py forces, the port's over a
2 x 4 mesh of CPU positions (every leaf blocked, every kernel's plain
version run per block), and the port's single-device server. They get the
same traffic over HTTP, the read corpora of the dense, BSI, TopN/GroupBy
and hybrid slice tests (Count, Row, Not, Sum/Min/Max/Range, TopN with Src
and Tanimoto, Rows, GroupBy, sparse and run leaves, ?shards= subsets,
writes between rounds), at 3 and 4 shards, the first ragged on 4 slots.
The JSON must be identical across the three. A port trio whose nodes
carry meshes then serves "auto" reads slice_local, with no
/internal/query-batch envelope (as tests/test_ici_serving.py holds for
the JAX package).
"""

import time
import urllib.request

import numpy as np
import pytest
import torch

import test_torch_bsi_slice as bsi_slice
import test_torch_hybrid_slice as hybrid_slice
import test_torch_slice as dense_slice
import test_torch_topn_slice as topn_slice
from chip_smoke import _free_ports
from pilosa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.parallel.mesh import make_mesh
from pilosa_tpu_torch.server import Server

CPU = torch.device("cpu")
_post, _call = dense_slice._post, dense_slice._call


class Three:
    """The JAX mesh server, the port's mesh server and the port's
    single-device server, fed alike."""

    def __init__(self, tmp, **port_kw):
        self.jax = JaxServer(str(tmp / "jax"), port=0,
                             mesh=jax_make_mesh(replicas=2),
                             **port_kw).open()
        self.mesh = Server(str(tmp / "mesh"), port=0, device="cpu",
                           mesh=make_mesh([CPU] * 8, replicas=2),
                           **port_kw).open()
        self.one = Server(str(tmp / "one"), port=0, device="cpu",
                          **port_kw).open()
        assert self.mesh.executor.runner.mesh.shape == {"replica": 2,
                                                        "shard": 4}

    @property
    def servers(self):
        return (self.jax, self.mesh, self.one)

    def post(self, path: str, body, ok: bool = True):
        """The three answers to one request, asserted identical."""
        want, got, one = (_post(s.uri, path, body) for s in self.servers)
        if ok:
            assert want[0] == 200, (path, want)
        assert got == want, (path, body, got, want)
        assert one == want, (path, body, one, want)
        return want

    def close(self):
        for s in self.servers:
            s.close()


def _hbm(srv) -> dict:
    return _call(srv.uri, "GET", "/debug/hbm?top=0")[1]


def test_dense_corpus(tmp_path):
    # dense leaves only: the mesh serving forms, not the hybrid path
    t = Three(tmp_path, sparse_threshold=0, run_threshold=0)
    try:
        rng = np.random.default_rng(3)
        for path, body in (
                [("/index/i", {"options": {"trackExistence": True}}),
                 ("/index/i/field/f", {"options": {"type": "set"}}),
                 ("/index/i/field/g", {})]
                + [(f"/index/i/field/{f}/import",
                    {"rowIDs": r, "columnIDs": c})
                   for f, r, c in dense_slice._imports(rng)]
                + [("/index/i/query", w) for w in dense_slice.WRITES]):
            t.post(path, body)
        for q, shards in dense_slice._queries():
            path = "/index/i/query"
            if shards is not None:
                path += "?shards=" + ",".join(str(s) for s in shards)
            t.post(path, q)
        # the resident leaves cost what the JAX mesh server's cost: one
        # copy of each padded leaf, by field and form, pad waste included
        ex = t.mesh.executor
        assert ex.runner.n_replicas == 2 and ex.residency.bytes > 0
        hbm, jhbm = _hbm(t.mesh), _hbm(t.jax)
        for key in ("residentBytes", "entries", "planCacheBytes",
                    "planCacheEntries", "wasteByRep", "byField",
                    "otherKinds"):
            assert hbm[key] == jhbm[key], key
        assert hbm["wasteByRep"]["dense"] > 0  # the pad shards
        assert hbm["residentBytes"] == ex.residency.bytes
        # every position's block is device memory
        assert hbm["accountedBytes"] >= 2 * hbm["residentBytes"] - \
            hbm["planCacheBytes"]
        assert ex.ici_snapshot()["programCache"]["programs"] >= 1
    finally:
        t.close()


def test_bsi_corpus(tmp_path):
    t = Three(tmp_path)
    try:
        for path, body in bsi_slice._traffic():
            t.post(path, body)
        for q, shards in bsi_slice._queries():
            path = "/index/i/query"
            if shards is not None:
                path += "?shards=" + ",".join(str(s) for s in shards)
            t.post(path, q)
        for q in bsi_slice.ERRORS:
            w = t.post("/index/i/query", q, ok=False)
            assert w[0] != 200
    finally:
        t.close()


def test_topn_rows_groupby_corpus(tmp_path):
    rng = np.random.default_rng(5)
    batches = topn_slice._imports(rng)
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
    vcols = rng.integers(0, topn_slice.N_COLS, size=20000)
    setup.append(("/index/i/field/v/import",
                  {"columnIDs": vcols.tolist(),
                   "values": rng.integers(0, 1001, size=vcols.size).tolist()}))
    t = Three(tmp_path)
    try:
        t.jax.executor._groupby_live_cap = 3
        t.mesh.executor.groupby_live_cap = 3
        t.one.executor.groupby_live_cap = 3
        light = topn_slice._queries(col_t, col_f)
        for rnd in range(2):
            traffic = setup if rnd == 0 else topn_slice._writes(rng, rnd)
            for path, body in traffic:
                t.post(path, body)
            for q, shards in light + topn_slice._group_queries()[:(3, 5)[rnd]]:
                path = "/index/i/query"
                if shards is not None:
                    path += "?shards=" + ",".join(str(s) for s in shards)
                t.post(path, q)
        assert t.mesh.executor.topn_recount_rows > 0
        assert t.mesh.executor.groupby_host_syncs > 0
    finally:
        t.close()


def test_hybrid_corpus(tmp_path):
    t = Three(tmp_path)
    try:
        for path, body in hybrid_slice._setup():
            t.post(path, body)
        for kind, index, pql, *rest in hybrid_slice._traffic():
            path = (hybrid_slice._query_path(index, rest[0])
                    if kind == "query" else f"/index/{index}/query")
            t.post(path, pql)
        for i, q, s in hybrid_slice._final_queries():
            t.post(hybrid_slice._query_path(i, s), q)
        snap = t.mesh.executor.hybrid_snapshot()
        assert snap["sparseUploads"] >= 1 and snap["runUploads"] >= 1
        assert snap["residentSparseLeaves"] >= 1
    finally:
        t.close()


def test_writes_patch_blocked_leaves(tmp_path):
    """Set/Clear envelopes through the IngestBatcher after reads made the
    leaves resident: each block of a dense or sparse leaf takes its own
    shards' patch at every position, and the reads after agree."""
    t = Three(tmp_path)
    try:
        rng = np.random.default_rng(9)
        sw, n = 1 << 20, 3  # ragged: 3 shards on 4 slots
        t.post("/index/i", {"options": {"trackExistence": True}})
        t.post("/index/i/field/f", {})
        for r, card in ((0, 9000), (1, 9000), (2, 300), (3, 300)):
            cols = np.unique(np.concatenate([
                s * sw + rng.integers(0, sw, size=card) for s in range(n)]))
            t.post("/index/i/field/f/import",
                   {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()})
        reads = ["Count(Row(f=0))", "Count(Row(f=2))", "Row(f=3)",
                 "Count(Intersect(Row(f=0), Row(f=1)))",
                 "Count(Intersect(Row(f=2), Row(f=0)))",
                 "Count(Not(Row(f=1)))", "Union(Row(f=2), Row(f=3))"]
        for rnd in range(3):
            for q in reads:
                t.post("/index/i/query", q)
            cols = (rng.integers(0, n, size=40) * sw
                    + rng.integers(0, sw, size=40)).tolist()
            body = " ".join(
                f"{'Set' if k % 3 else 'Clear'}({c}, f={k % 4})"
                for k, c in enumerate(cols))
            t.post("/index/i/query", body)
        for q in reads:
            t.post("/index/i/query", q)
        snap = t.mesh.executor.ingest_snapshot()
        assert snap["patchedDense"] >= 1 and snap["patchedSparse"] >= 1
    finally:
        t.close()


# -- a port trio whose nodes carry meshes -------------------------------------

TIER1_MIX = [
    "Count(Intersect(Row(f=0), Row(f=1)))",
    "Count(Union(Row(f=2), Row(f=3)))",
    "Intersect(Row(f=0), Row(f=2))",
    "Union(Row(f=1), Difference(Row(f=3), Row(f=0)))",
    "Count(Not(Row(f=1)))",
    "TopN(f, n=3)",
    "TopN(f, Row(g=1), n=2)",
    "Sum(Range(v > 511), field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Rows(field=f)",
    "GroupBy(Rows(field=g), Rows(field=f))",
    "GroupBy(Rows(field=f), limit=3)",
]


def _envelopes(ex) -> int:
    s = ex.coalescer.snapshot()
    return s["batches"] + s["fallback_queries"]


def test_mesh_trio_serves_auto_reads_slice_local(tmp_path):
    ports = _free_ports(3)
    uris = [f"http://127.0.0.1:{p}" for p in ports]
    meshes = [make_mesh([CPU] * 4), make_mesh([CPU] * 4, replicas=2),
              make_mesh([CPU] * 8, replicas=2)]
    nodes = [Server(str(tmp_path / f"n{i}"), port=ports[i], device="cpu",
                    mesh=meshes[i], node_id="abc"[i], replica_n=3,
                    cluster_hosts=uris, membership_interval=0.0,
                    telemetry_interval=0.0).open() for i in range(3)]
    try:
        for n in nodes:
            n.refresh_membership()
        rng = np.random.default_rng(13)
        sw, n_shards = 1 << 20, 5
        row_ids, col_ids = [], []
        for shard in range(n_shards):
            for row in range(4):
                cols = rng.choice(sw, size=128, replace=False) + shard * sw
                row_ids += [row] * 128
                col_ids += cols.tolist()
        vcols = [s * sw + k for s in range(n_shards) for k in range(48)]
        for path, body in (
                ("/index/i", {}), ("/index/i/field/f", {}),
                ("/index/i/field/g", {}),
                ("/index/i/field/v", {"options": {"type": "int", "min": 0,
                                                  "max": 1023}}),
                ("/index/i/field/f/import", {"rowIDs": row_ids,
                                             "columnIDs": col_ids}),
                ("/index/i/field/g/import",
                 {"rowIDs": [r % 2 for r in row_ids], "columnIDs": col_ids}),
                ("/index/i/field/v/import",
                 {"columnIDs": vcols,
                  "values": rng.integers(0, 1024, len(vcols)).tolist()})):
            assert _post(uris[0], path, body)[0] == 200
        want = int(np.sum([1 for r, c in zip(row_ids, col_ids) if r == 0]))
        deadline = time.monotonic() + 30
        for u in uris:
            while _post(u, "/index/i/query", "Count(Row(f=0))")[1] != \
                    {"results": [want]}:
                assert time.monotonic() < deadline, u
                time.sleep(0.1)
        answers = {}
        for i, n in enumerate(nodes):
            ex = n.executor
            assert ex.ici_mode == "auto" and ex.runner.ici_serving
            env0, local0 = _envelopes(ex), ex.ici_slice_local
            for q in TIER1_MIX:
                st, body = _post(uris[i], "/index/i/query", q)
                assert st == 200, (q, body)
                assert answers.setdefault(q, body) == body, (i, q)
            assert _envelopes(ex) == env0, "slice_local reads sent envelopes"
            assert ex.ici_slice_local == local0 + len(TIER1_MIX)
            snap = ex.ici_snapshot()
            assert snap["programCache"]["hits"] + \
                snap["programCache"]["misses"] > 0
        # ici-serving off: the HTTP plane answers the same
        ex = nodes[0].executor
        ex.ici_mode = "off"
        env0 = _envelopes(ex)
        for q in TIER1_MIX:
            assert _post(uris[0], "/index/i/query", q)[1] == answers[q], q
        assert _envelopes(ex) > env0
        dv = _call(uris[1], "GET", "/debug/vars")[1]
        assert dv["iciServing"]["programCache"]["programs"] >= 1
        metrics = urllib.request.urlopen(uris[1] + "/metrics").read()
        assert b"iciProgramCache" in metrics
    finally:
        for n in nodes:
            n.close()


@pytest.mark.parametrize("replicas", [1, 2])
def test_ragged_mesh_counts_ignore_pad_shards(tmp_path, replicas):
    """5 shards on 4 slots: a Not() and a whole-width count over pad
    shards count nothing; a Row result never names a pad shard. One
    replica row reads dense leaves (zero-padded), two read sparse ones
    (sentinel-padded)."""
    forms = {} if replicas == 2 else dict(sparse_threshold=0,
                                          run_threshold=0)
    srv = Server(str(tmp_path / "r"), port=0, device="cpu",
                 mesh=make_mesh([CPU] * (4 * replicas), replicas=replicas),
                 **forms).open()
    try:
        u = srv.uri
        _post(u, "/index/i", {"options": {"trackExistence": True}})
        _post(u, "/index/i/field/f", {})
        cols = [s * (1 << 20) + k for s in range(5) for k in (0, 9, 4000)]
        _post(u, "/index/i/field/f/import",
              {"rowIDs": [1] * len(cols), "columnIDs": cols})
        _post(u, "/index/i/query", "Set(12, f=2)")
        got = [_post(u, "/index/i/query", q)[1]["results"][0] for q in (
            "Count(Not(Row(f=2)))", "Count(Union(Row(f=1), Row(f=2)))",
            "Count(Not(Union(Row(f=1), Row(f=2))))")]
        assert got == [len(cols), len(cols) + 1, 0]
        row = _post(u, "/index/i/query", "Not(Row(f=2))")[1]["results"][0]
        assert sorted(row["columns"]) == sorted(cols)
        kind = "sparse" if replicas == 2 else "row"
        leaf = next(v for k, v in srv.executor.residency._lru.items()
                    if k[0] == kind)
        assert leaf.length == 8 and leaf.n_replicas == replicas
    finally:
        srv.close()
