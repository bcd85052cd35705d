"""The observability layer end to end, against the JAX server.

Both servers run in-process (the port on the CPU, through its kernels'
plain versions) over 4 shards, with the slow-query history armed, and get
the same schema, imports, writes and a seeded mix of queries over every
served path: Count (batched and 3+-way), Row and Not, Sum/Min/Max and
Range, TopN/Rows/GroupBy, sparse and run leaves, Set/Clear envelopes and
a per-bit write. Then:

  * the two servers gave identical JSON;
  * the port's /metrics passes the conformance parser of
    tests/test_metrics_conformance.py, and every family it shares with
    the JAX server has the same type, and the same values where it counts
    deterministic things (queries by call, ingest, hybrid uploads);
  * ?profile=true trees have the same keys (but the JAX server's "qos",
    from its QoS plane), calls, batcher dispatch records and residency
    hits, misses and host-to-device bytes;
  * /debug/query-history fills, /debug/heat totals of reads and writes
    are equal, /debug/vars has the JAX block names;
  * the kill switches PILOSA_TPU_TORCH_TELEMETRY=0,
    PILOSA_TPU_TORCH_HEAT=0, PILOSA_TPU_TORCH_PLANNER=0 and
    PILOSA_TPU_TORCH_PLAN_CACHE=0 give the same answers and empty blocks.

Both servers run with their planner and plan cache on, as they do by
default. A plan-cache hit reads no leaf and launches nothing, so the
profile test checks the batchers' dispatch records with the cache off at
run time (plan_cache.enabled, the planner still on), then the plan nodes
with it on.
"""

import http.client
import json
from urllib.parse import urlparse

import numpy as np
import pytest
import torch

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.utils import telemetry as ttel

from tests.test_metrics_conformance import check_conformance

N_SHARDS = 4
SW = 1 << 20


def _call(uri: str, method: str, path: str, body: bytes = b""):
    u = urlparse(uri)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        raw = resp.read()
        if resp.getheader("Content-Type", "").startswith("text/plain"):
            return resp.status, raw.decode()
        return resp.status, json.loads(raw or b"null")
    finally:
        conn.close()


def _post(uri: str, path: str, body) -> tuple:
    if not isinstance(body, (str, bytes)):
        body = json.dumps(body)
    return _call(uri, "POST", path,
                 body.encode() if isinstance(body, str) else body)


def _setup() -> list:
    """(path, body) of the schema and imports: dense, sparse and run rows
    of f, sparse rows of g, a ranked field t, an int field v."""
    rng = np.random.default_rng(23)
    out = [("/index/i", {"options": {"trackExistence": True}}),
           ("/index/i/field/f", {}), ("/index/i/field/g", {}),
           ("/index/i/field/t", {"options": {"cacheType": "ranked",
                                             "cacheSize": 100}}),
           ("/index/i/field/v", {"options": {"type": "int", "min": 0,
                                             "max": 1000}})]

    def imp(field, row, cols):
        out.append((f"/index/i/field/{field}/import",
                    {"rowIDs": [row] * len(cols),
                     "columnIDs": [int(c) for c in cols]}))

    for r in range(4):  # dense: 9000 bits in every shard
        imp("f", r, np.concatenate([rng.choice(SW, 9000, replace=False)
                                    + s * SW for s in range(N_SHARDS)]))
    for r in (4, 5):  # sparse
        imp("f", r, rng.integers(0, N_SHARDS * SW, size=900))
    for r in (6,):  # run: two ranges of 5000 bits per shard
        imp("f", r, np.concatenate([np.arange(a, a + 5000) + s * SW
                                    for s in range(N_SHARDS)
                                    for a in (4096, 409600)]))
    for r in range(3):
        imp("g", r, rng.integers(0, N_SHARDS * SW, size=600 * (r + 1)))
    for r in range(8):
        imp("t", r, rng.integers(0, N_SHARDS * SW, size=3000 // (r + 1)))
    cols = rng.choice(N_SHARDS * SW, size=4000, replace=False)
    out.append(("/index/i/field/v/import",
                {"columnIDs": cols.tolist(),
                 "values": rng.integers(0, 1001, size=cols.size).tolist()}))
    return out


def _bitmap(rng, depth: int = 0) -> str:
    kind = int(rng.integers(6)) if depth < 2 else 0
    if kind == 0:
        field = "f" if rng.random() < 0.7 else "g"
        return f"Row({field}={int(rng.integers(7 if field == 'f' else 3))})"
    if kind == 5:
        return f"Not({_bitmap(rng, depth + 1)})"
    name = ["Intersect", "Union", "Xor", "Difference"][kind - 1]
    n = int(rng.integers(2, 4))
    return f"{name}({', '.join(_bitmap(rng, depth + 1) for _ in range(n))})"


FIXED = [
    "Count(Row(f=0))", "Count(Intersect(Row(f=0), Row(f=1)))",
    "Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))",
    "Count(Not(Row(f=3)))", "Row(f=4)",
    "Count(Intersect(Row(f=4), Row(f=0)))",   # sparse ∩ dense
    "Count(Intersect(Row(f=6), Row(f=1)))",   # run ∩ dense
    "Count(Row(f=6))",
    "Sum(field=v)", "Sum(Range(v > 400), field=v)", "Min(field=v)",
    "Max(Row(f=0), field=v)", "Count(Range(v < 20))",
    "Count(Range(200 < v < 300))", "Count(Intersect(Range(v >= 900), "
    "Row(f=1)))",
    "TopN(t, n=3)", "TopN(t, Row(f=0), n=3)", "Rows(field=t)",
    "GroupBy(Rows(field=g), Rows(field=t), limit=5)",
    "Count(Union(Row(g=0), Row(g=2)))",
]

WRITES = [
    "Set(5, f=1) Set(1048580, g=0) Clear(7, f=0) Set(9, t=2)",
    "Set(2097200, f=4) Clear(2097200, f=4) Set(3145800, g=2)",
    "Set(11, v=77)",   # an int field: the per-bit path
    "Clear(11, v=77) Clear(99, g=1)",
]


def _mix() -> list:
    rng = np.random.default_rng(31)
    out = list(FIXED)
    for i in range(24):
        body = _bitmap(rng)
        out.append(f"Count({body})" if i % 3 else body)
    for i, w in enumerate(WRITES):
        out.insert(6 * i + 3, w)
    return out


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jax_srv = JaxServer(str(tmp_path_factory.mktemp("jax")), port=0,
                        long_query_time=1e-9).open()
    port_srv = Server(str(tmp_path_factory.mktemp("port")), port=0,
                      device="cpu", long_query_time=1e-9,
                      telemetry_interval=0.05).open()
    for path, body in _setup():
        for srv in (jax_srv, port_srv):
            status, got = _post(srv.uri, path, body)
            assert status == 200, (path, got)
    answers = {"jax": [], "port": []}
    for pql in _mix():
        for name, srv in (("jax", jax_srv), ("port", port_srv)):
            answers[name].append(_post(srv.uri, "/index/i/query", pql))
    yield jax_srv, port_srv, answers
    port_srv.close()
    jax_srv.close()


def test_same_answers_over_every_path(servers):
    _, _, answers = servers
    for pql, j, t in zip(_mix(), answers["jax"], answers["port"]):
        assert j[0] == 200, (pql, j)
        assert t == j, pql


def _families(text: str) -> tuple:
    types, samples = check_conformance(text)
    values: dict = {}
    for name, labels, value in samples:
        values.setdefault(name, {})[tuple(sorted(labels.items()))] = value
    return types, values


def test_metrics_conform_and_share_families(servers):
    jax_srv, port_srv, _ = servers
    _, jtext = _call(jax_srv.uri, "GET", "/metrics")
    _, ttext = _call(port_srv.uri, "GET", "/metrics")
    jtypes, jvals = _families(jtext)
    ttypes, tvals = _families(ttext)
    shared = set(jtypes) & set(ttypes)
    for fam in shared:
        assert ttypes[fam] == jtypes[fam], fam
    for fam in ("pilosa_query_total", "pilosa_ingest_total",
                "pilosa_ingestBatches_total", "pilosa_ingestWal_total",
                "pilosa_hybrid_total", "pilosa_batcher_total",
                "pilosa_residency_total", "pilosa_heat_total",
                "pilosa_hbmBudgetBytes", "pilosa_kernelsDispatches_total"):
        assert fam in shared, fam
    for fam in ("pilosa_query_total", "pilosa_ingest_total",
                "pilosa_ingestWal_total", "pilosa_hybrid_total"):
        for labels, v in tvals[fam].items():
            if labels[0][0] == "transition":
                continue  # the port expands fewer roots to planes
            assert jvals[fam][labels] == v, (fam, labels)
    q = tvals["pilosa_query_total"]
    assert q[(("key", "Count"),)] > 10 and q[(("key", "Set"),)] == 1
    assert tvals["pilosa_ingest_total"][(("op", "set"),)] > 0
    # every registered kernel family is emitted, zeros included
    assert (("rep", "dense"),) in tvals["pilosa_kernelsDispatches_total"] \
        or len(tvals["pilosa_kernelsDispatches_total"]) >= 15


def _profiled(srv, pql: str) -> dict:
    status, got = _post(srv.uri, "/index/i/query?profile=true", pql)
    assert status == 200, got
    return got


@pytest.mark.parametrize("pql,batcher", [
    ("Count(Intersect(Row(f=0), Row(f=2)))", "CountBatcher"),
    ("Count(Row(f=1))", "CountBatcher"),
    ("Sum(Range(v > 123), field=v)", "PlaneSumBatcher"),
    ("Count(Intersect(Row(f=4), Row(f=1)))", None),  # hybrid: no batcher
    ("Count(Intersect(Row(f=0), Row(f=1), Row(f=3)))", None),
    ("Count(Not(Row(f=2)))", "CountBatcher"),  # existence &~ row
    ("TopN(t, Row(f=1), n=2)", None),
    ("GroupBy(Rows(field=g), limit=2)", None),
    ("Row(f=5)", None),
    ("Count(Range(v == 500))", "CountBatcher"),  # one mask leaf
])
def test_profile_trees_match_jax(servers, pql, batcher):
    jax_srv, port_srv, _ = servers
    caches = [jax_srv.executor.plan_cache, port_srv.executor.plan_cache]
    # cold, then warm leaves with the cache off; then twice with it on
    for cache_on in (False, False, True, True):
        for pc in caches:
            pc.enabled = cache_on
        try:
            j = _profiled(jax_srv, pql)
            t = _profiled(port_srv, pql)
        finally:
            for pc in caches:
                pc.enabled = True
        assert t["results"] == j["results"]
        jp, tp = j["profile"], t["profile"]
        assert list(tp) == list(jp)
        # the QoS node: the class and the deadline the query ran under
        assert (tp["qos"]["priority"], tp["qos"]["deadlineMs"]) == \
            (jp["qos"]["priority"], jp["qos"]["deadlineMs"])
        assert [c["call"] for c in tp["calls"]] == \
            [c["call"] for c in jp["calls"]]
        assert tp["residency"] == jp["residency"], pql
        assert tp["plan"] == jp["plan"], pql
        assert [d["batcher"] for d in tp["dispatches"]] == \
            [d["batcher"] for d in jp["dispatches"]]
        if not cache_on:
            assert [d["batcher"] for d in tp["dispatches"]] == \
                ([batcher] if batcher else [])
        assert tp["traceId"] and tp["index"] == "i"
        assert sum(c["ms"] for c in tp["calls"]) <= tp["elapsedMs"] + 1e-3
        if not cache_on:
            warm = tp["residency"]
    assert warm["hits"] > 0 and warm["misses"] == 0
    assert warm["hostToDeviceBytes"] == 0
    # warm, with the cache on: a cached answer reads no leaf at all
    assert tp["residency"]["misses"] == 0
    assert tp["residency"]["hostToDeviceBytes"] == 0
    events = tp["plan"][0]["cache"]
    assert all(e["hit"] for e in events)
    if events and pql.startswith(("Count", "Row")):
        assert tp["residency"]["hits"] == 0 and tp["dispatches"] == []


def test_query_history_and_trace_ids(servers):
    jax_srv, port_srv, _ = servers
    _, j = _call(jax_srv.uri, "GET", "/debug/query-history")
    _, t = _call(port_srv.uri, "GET", "/debug/query-history")
    assert t["queries"] and j["queries"]
    e = t["queries"][0]
    assert set(e) == set(j["queries"][0])
    assert e["profile"] is not None and e["traceId"] == \
        e["profile"]["traceId"]
    for srv in (jax_srv, port_srv):  # both: the heat totals stay equal
        u = urlparse(srv.uri)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
        try:
            conn.request("POST", "/index/i/query", body=b"Count(Row(f=2))",
                         headers={"X-Pilosa-Trace-Id": "feedc0de"})
            conn.getresponse().read()
        finally:
            conn.close()
    _, t = _call(port_srv.uri, "GET", "/debug/query-history")
    assert t["queries"][0]["traceId"] == "feedc0de"
    spans = port_srv.tracer.finished("executor.Count")
    assert spans and spans[-1].trace_id == "feedc0de"


def test_heat_totals_match_jax(servers):
    jax_srv, port_srv, _ = servers
    _, j = _call(jax_srv.uri, "GET", "/debug/heat?top=3")
    _, t = _call(port_srv.uri, "GET", "/debug/heat?top=3")
    assert t["enabled"] and j["enabled"]
    for f in ("reads", "writes"):
        assert t["totals"][f] == j["totals"][f] > 0, f
    assert set(t) == set(j)
    assert t["trackedFragments"] == j["trackedFragments"]
    assert len(t["hot"]) == 3 and set(t["hot"][0]) == set(j["hot"][0])


def test_debug_vars_blocks(servers):
    jax_srv, port_srv, _ = servers
    _, j = _call(jax_srv.uri, "GET", "/debug/vars")
    _, t = _call(port_srv.uri, "GET", "/debug/vars")
    blocks = {"deviceResidency", "countBatcher", "planeSumBatcher", "hybrid",
              "ingest", "kernels", "hbm", "heat", "deviceProfiler",
              "topnRecountRows", "groupByHostSyncs"}
    assert blocks <= set(t)
    assert set(t) <= set(j) | {"counts", "gauges", "timings", "sets"}
    for block in ("countBatcher", "planeSumBatcher", "hybrid", "kernels",
                  "heat"):
        assert set(t[block]) - {"streamTimes"} <= set(j[block]), block
    # each storage once: at most the entries' bytes, which count aliases
    assert 0 < t["hbm"]["accountedBytes"] <= \
        t["deviceResidency"]["bytes"] + t["planCache"]["bytes"]
    for block in ("planner", "planCache"):
        assert set(t[block]) == set(j[block]), block
    assert t["hbm"]["allocator"] is None  # the CPU has no allocator view
    assert t["kernels"]["wait"]["batcher"]["waited"] > 0
    fams = {c["family"] for c in t["kernels"]["calls"]}
    assert {"sparse", "run", "bsi", "topn", "ingest"} <= fams


def test_debug_routes(servers):
    _, port_srv, _ = servers
    uri = port_srv.uri
    _, hbm = _call(uri, "GET", "/debug/hbm?top=2")
    assert len(hbm["byField"]) <= 2 and hbm["byFieldTruncated"]
    # Range(v != null) is the not-null row, cached under both keys, and a
    # cached Row result may be its resident leaf: memory is accounted once
    _post(uri, "/index/i/query", "Count(Range(v != null))")
    _, hbm = _call(uri, "GET", "/debug/hbm")
    ex = port_srv.executor
    held = list(ex.residency._lru.values())
    held += [v for v, _ in ex.plan_cache._lru.values()
             if isinstance(v, torch.Tensor)]
    storages = {a.untyped_storage().data_ptr(): a.untyped_storage().nbytes()
                for a in held}
    assert len(storages) < len(held)
    assert hbm["accountedBytes"] == sum(storages.values())
    assert hbm["accountedBytes"] < hbm["residentBytes"] + \
        hbm["planCacheBytes"]
    assert {e["rep"] for e in _call(uri, "GET", "/debug/hbm?top=0")[1][
        "byField"]} == {"dense", "sparse", "run"}
    _, ts = _call(uri, "GET", "/debug/timeseries")
    assert ts["enabled"] and ts["samples"]
    g = ts["samples"][-1]["gauges"]
    assert g["residency.entries"] > 0 and "heat.skew" in g
    _, again = _call(uri, "GET", f"/debug/timeseries?since={ts['seq']}")
    assert all(s["seq"] > ts["seq"] for s in again["samples"])
    status, _ = _call(uri, "GET", "/debug/timeseries?since=x")
    assert status == 400
    status, _ = _call(uri, "GET", "/debug/heat?advice=true")
    assert status == 400  # the cluster advisor's argument: not served
    _, prof = _post(uri, "/debug/device-profile?seconds=0.05", b"")
    assert prof["status"] == "ok" and prof["activity"] == "cpu"
    assert _call(uri, "GET", "/debug/pprof")[1]["profiles"] == \
        ["goroutine", "profile"]
    assert _call(uri, "GET", "/debug/pprof/goroutine")[1]["threads"] > 1
    assert "top" in _call(uri, "GET", "/debug/pprof/profile?seconds=0.05")[1]
    assert _call(uri, "GET", "/debug/pprof/heap")[0] == 404


@pytest.mark.parametrize("switch", ["PILOSA_TPU_TORCH_TELEMETRY",
                                    "PILOSA_TPU_TORCH_HEAT",
                                    "PILOSA_TPU_TORCH_PLANNER",
                                    "PILOSA_TPU_TORCH_PLAN_CACHE"])
def test_kill_switches(servers, tmp_path, monkeypatch, switch):
    """With a switch off the answers stay the same and its surfaces go
    empty: no heat map, no samples and no kernel statistics, or no
    planner or plan-cache block and family."""
    _, port_srv, answers = servers
    monkeypatch.setenv(switch, "0")
    srv = Server(str(tmp_path / "d"), port=0, device="cpu",
                 telemetry_interval=0.05).open()
    try:
        for path, body in _setup():
            assert _post(srv.uri, path, body)[0] == 200
        before = ttel.kernels.snapshot()["dispatches"]
        got = [_post(srv.uri, "/index/i/query", pql) for pql in _mix()]
        assert got == answers["port"]
        _, heat = _call(srv.uri, "GET", "/debug/heat")
        _, ts = _call(srv.uri, "GET", "/debug/timeseries")
        _, dv = _call(srv.uri, "GET", "/debug/vars")
        _, text = _call(srv.uri, "GET", "/metrics")
        check_conformance(text)
        if switch == "PILOSA_TPU_TORCH_HEAT":
            assert heat["enabled"] is False and heat["hot"] == []
            assert "heat" not in dv and srv.executor.heat is None
            assert "pilosa_heat_total" not in text
        elif switch == "PILOSA_TPU_TORCH_PLANNER":
            assert srv.executor.planner is None and "planner" not in dv
            assert "pilosa_planner_total" not in text
            assert dv["planCache"]["hits"] > 0
        elif switch == "PILOSA_TPU_TORCH_PLAN_CACHE":
            assert srv.executor.plan_cache is None and "planCache" not in dv
            assert "pilosa_planCache_total" not in text
            assert dv["planner"]["plans"] > 0
            assert dv["hbm"]["planCacheBytes"] == 0
        else:
            assert ts["enabled"] is False and ts["samples"] == []
            assert dv["kernels"]["enabled"] is False
            assert ttel.kernels.snapshot()["dispatches"] == before
    finally:
        srv.close()
