"""The planner and the plan cache end to end, against the JAX server.

Both servers run in-process with their defaults, planner on and plan
cache on (the port on the CPU, through its kernels' plain versions), over
the schema and data of tests/test_torch_obs_slice.py (4 shards: dense,
sparse and run rows of f, sparse rows of g, a ranked field t, an int
field v). A seeded mix over every served path (Count of 1, 2 and 3+
leaves, Row, Not, Range, Sum/Min/Max with filters, TopN with a Src,
GroupBy with a filter, sparse and run leaves, provably empty branches)
runs in three rounds, each query in two operand permutations, with
Set/Clear envelopes and a per-bit int write between the rounds. Then, at
tolerance 0:

  * identical answer JSON, ?profile=true `plan` nodes (cache events,
    actual cardinality, hybrid entries) and ?explain=true documents;
  * EXPLAIN launches nothing and leaves the residency counters alone;
  * equal /debug/vars `planner` (its calibration entries but their
    clock fields) and `planCache`, /metrics planner and planCache values,
    /debug/hbm plan-cache fields and heat totals;
  * the zero-operand errors of Intersect() and Difference() give the
    same HTTP status and JSON;
  * each kill switch (the port's PILOSA_TPU_TORCH_PLANNER=0,
    PILOSA_TPU_TORCH_PLAN_CACHE=0, Server(plan="off",
    plan_cache_bytes=0)) against the JAX server's twin gives the same
    answers, plan nodes and blocks.
"""

import numpy as np
import pytest

from pilosa_tpu import planner as jplanner
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch import planner as tplanner
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.utils import telemetry as ttel

from tests.test_metrics_conformance import check_conformance
from tests.test_torch_obs_slice import _call, _post, _setup

# leaf pool: dense rows 0-3 of f, sparse 4-5, run 6, an empty row 9;
# sparse rows of g; BSI conditions over v
LEAVES = ["Row(f=0)", "Row(f=1)", "Row(f=2)", "Row(f=3)", "Row(f=4)",
          "Row(f=5)", "Row(f=6)", "Row(f=9)", "Row(g=0)", "Row(g=1)",
          "Row(g=2)", "Range(v > 400)", "Range(v < 120)"]


def _tree(rng, depth: int):
    if depth <= 0 or rng.random() < 0.3:
        return LEAVES[int(rng.integers(len(LEAVES)))]
    op = ("Intersect", "Union", "Xor", "Difference",
          "Not")[int(rng.integers(5))]
    if op == "Not":
        return (op, [_tree(rng, depth - 1)])
    return (op, [_tree(rng, depth - 1)
                 for _ in range(int(rng.integers(2, 4)))])


def _render(t, rng=None) -> str:
    """PQL of a tree; with `rng`, commutative operands are shuffled."""
    if isinstance(t, str):
        return t
    op, kids = t
    kids = [_render(k, rng) for k in kids]
    if rng is not None and op in ("Intersect", "Union", "Xor"):
        kids = [kids[i] for i in rng.permutation(len(kids))]
    return f"{op}({', '.join(kids)})"


def _wrap(rng, body: str) -> str:
    shape = int(rng.integers(7))
    return [f"Count({body})", body, f"Sum({body}, field=v)",
            f"Max({body}, field=v)", f"TopN(t, {body}, n=3)",
            f"GroupBy(Rows(field=g), filter={body})",
            f"Count({body})"][shape]


def _mix(seed: int) -> list:
    """(pql, permuted pql) pairs."""
    rng = np.random.default_rng(seed)
    out = [("Count(Intersect(Row(f=0), Row(f=2), Row(f=1)))",
            "Count(Intersect(Row(f=1), Row(f=0), Row(f=2)))"),
           ("Count(Intersect(Row(f=0), Row(f=9)))",
            "Count(Intersect(Row(f=9), Row(f=0)))"),
           ("Intersect(Row(f=4), Row(f=1))", "Intersect(Row(f=1), Row(f=4))"),
           ("Count(Union(Row(f=6), Row(g=1), Row(f=9)))",
            "Count(Union(Row(f=9), Row(g=1), Row(f=6)))")]
    for _ in range(10):
        t = _tree(rng, int(rng.integers(1, 4)))
        wrap = np.random.default_rng(int(rng.integers(1 << 30)))
        shape_seed = int(rng.integers(1 << 30))
        out.append(tuple(_wrap(np.random.default_rng(shape_seed), body)
                         for body in (_render(t), _render(t, wrap))))
    return out


WRITES = ["Set(5, f=1) Set(1048580, g=0) Clear(7, f=0) Set(9, f=2)",
          "Set(2097200, f=4) Set(3145800, g=2) Clear(5, f=1)",
          "Set(11, v=77)"]

ZERO_OPERAND = ["Count(Intersect())", "Difference()",
                "Union(Row(f=1), Intersect())", "Count(Difference())"]


def _open(tmp_path_factory, jax_kw=None, port_kw=None, jax_env=None,
          port_env=None, monkeypatch=None) -> tuple:
    """A JAX server and a port server over the same schema and data;
    each server's env switches are set while it is built."""
    def build(factory, name, env, kw):
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        try:
            return factory(str(tmp_path_factory.mktemp(name)), port=0,
                           **(kw or {})).open()
        finally:
            for k in env or {}:
                monkeypatch.delenv(k)

    jax_srv = build(JaxServer, "jax", jax_env, jax_kw)
    port_srv = build(Server, "port", port_env,
                     dict(port_kw or {}, device="cpu"))
    for path, body in _setup():
        for srv in (jax_srv, port_srv):
            status, got = _post(srv.uri, path, body)
            assert status == 200, (path, got)
    return jax_srv, port_srv


def _run(srv, pql: str, **args) -> tuple:
    q = "&".join(f"{k}=true" for k in args)
    return _post(srv.uri, "/index/i/query" + (f"?{q}" if q else ""), pql)


def _scrub_calibration(block: dict) -> dict:
    cal = dict(block["calibration"])
    cal["entries"] = [{k: v for k, v in e.items()
                       if k not in ("ts", "elapsedMs")}
                      for e in cal["entries"]]
    return dict(block, calibration=cal)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    jplanner.calibration.reset()
    tplanner.calibration.reset()
    jax_srv, port_srv = _open(tmp_path_factory, monkeypatch=mp)
    seen = {"answers": [], "plans": [], "explains": []}
    for rnd in range(3):
        for pair in _mix(7):
            for i, pql in enumerate(pair + pair):
                if i < 2:
                    j = _run(jax_srv, pql, explain=1)
                    t = _run(port_srv, pql, explain=1)
                    seen["explains"].append((pql, j, t))
                j = _run(jax_srv, pql, profile=1)
                t = _run(port_srv, pql, profile=1)
                seen["answers"].append((pql, j[0], t[0], j[1]["results"]
                                        if j[0] == 200 else j[1],
                                        t[1]["results"]
                                        if t[0] == 200 else t[1]))
                if j[0] == t[0] == 200:
                    seen["plans"].append((pql, j[1]["profile"]["plan"],
                                          t[1]["profile"]["plan"]))
        if rnd < len(WRITES):
            for srv in (jax_srv, port_srv):
                assert _run(srv, WRITES[rnd])[0] == 200
    yield jax_srv, port_srv, seen
    port_srv.close()
    jax_srv.close()
    mp.undo()


def test_same_answers(servers):
    _, _, seen = servers
    assert len(seen["answers"]) > 150
    for pql, js, ts, j, t in seen["answers"]:
        assert (ts, t) == (js, j), pql
    assert sum(js == 200 for _, js, *_ in seen["answers"]) > 100


def test_same_plan_nodes(servers):
    _, _, seen = servers
    hits = shorts = hybrid = 0
    for pql, j, t in seen["plans"]:
        assert t == j, pql
        for node in t:
            hits += sum(e["hit"] for e in node["cache"])
            shorts += node["shortCircuits"]
            hybrid += len(node.get("hybrid", ()))
    assert hits > 50 and shorts > 5 and hybrid > 10


def test_same_explain_documents(servers):
    _, _, seen = servers
    trees = 0
    for pql, j, t in seen["explains"]:
        assert t == j, pql
        trees += sum("tree" in e for e in t[1].get("explain", ()))
    assert trees > 50


def test_explain_launches_nothing(servers):
    jax_srv, port_srv, _ = servers
    pql = ("Count(Intersect(Row(f=3), Row(g=2), Not(Row(f=5)))) "
           "Sum(Range(v > 10), field=v) TopN(t, Row(f=6), n=2) "
           "Set(3, f=1)")
    ex = port_srv.executor
    before = (ttel.kernels.snapshot()["dispatches"],
              ex.residency.snapshot(), ex.hybrid.snapshot(),
              ex.plan_cache.snapshot())
    status, doc = _run(port_srv, pql, explain=1)
    assert status == 200
    assert _run(jax_srv, pql, explain=1) == (status, doc)
    after = (ttel.kernels.snapshot()["dispatches"],
             ex.residency.snapshot(), ex.hybrid.snapshot(),
             ex.plan_cache.snapshot())
    assert after == before
    assert [e["planned"] for e in doc["explain"]] == [True, True, True,
                                                      False]
    # nothing ran: the write's bit is still clear
    assert _run(port_srv, "Count(Intersect(Row(f=1), Row(f=1)))")[1] == \
        _run(jax_srv, "Count(Intersect(Row(f=1), Row(f=1)))")[1]


def test_debug_vars_planner_blocks(servers):
    jax_srv, port_srv, _ = servers
    _, j = _call(jax_srv.uri, "GET", "/debug/vars")
    _, t = _call(port_srv.uri, "GET", "/debug/vars")
    assert t["planCache"] == j["planCache"]
    assert _scrub_calibration(t["planner"]) == \
        _scrub_calibration(j["planner"])
    assert t["planner"]["calibration"]["compared"] > 0
    assert t["planCache"]["hits"] > 0 and t["planCache"]["misses"] > 0
    for k in ("planCacheBytes",):
        assert t["hbm"][k] == j["hbm"][k]
    _, jh = _call(jax_srv.uri, "GET", "/debug/hbm?top=0")
    _, th = _call(port_srv.uri, "GET", "/debug/hbm?top=0")
    for k in ("planCacheBytes", "planCacheEntries"):
        assert th[k] == jh[k] > 0, k


def _planner_values(text: str) -> dict:
    _, samples = check_conformance(text)
    return {(name, tuple(sorted(labels.items()))): value
            for name, labels, value in samples
            if name.startswith(("pilosa_planner", "pilosa_planCache",
                                "pilosa_hbmPlanCacheBytes"))}


def test_metrics_planner_families(servers):
    jax_srv, port_srv, _ = servers
    _, jtext = _call(jax_srv.uri, "GET", "/metrics")
    _, ttext = _call(port_srv.uri, "GET", "/metrics")
    tv = _planner_values(ttext)
    assert tv == _planner_values(jtext)
    names = {n for n, _ in tv}
    assert {"pilosa_planner_total", "pilosa_planCache_total",
            "pilosa_planCache", "pilosa_hbmPlanCacheBytes"} <= names


def test_heat_totals(servers):
    jax_srv, port_srv, _ = servers
    _, j = _call(jax_srv.uri, "GET", "/debug/heat?top=3")
    _, t = _call(port_srv.uri, "GET", "/debug/heat?top=3")
    for f in ("reads", "writes"):
        assert t["totals"][f] == j["totals"][f] > 0, f
    assert t["trackedFragments"] == j["trackedFragments"]


def test_timeseries_series(servers):
    _, port_srv, _ = servers
    g = port_srv.sample_gauges()
    for k in ("plancache.bytes", "plancache.entries", "plancache.hit_rate",
              "plancache.evictions_per_s", "planner.reorders_per_s",
              "planner.pushdowns_per_s", "planner.short_circuits_per_s"):
        assert k in g, k


@pytest.mark.parametrize("pql", ZERO_OPERAND)
def test_zero_operand_errors_match(servers, pql):
    jax_srv, port_srv, _ = servers
    j = _run(jax_srv, pql)
    t = _run(port_srv, pql)
    assert j[0] == 400 and "offending fragment" in j[1]["error"]
    assert t == j


KILL = {
    "env_planner": ({"PILOSA_TPU_PLANNER": "0"},
                    {"PILOSA_TPU_TORCH_PLANNER": "0"}, {}),
    "env_plan_cache": ({"PILOSA_TPU_PLAN_CACHE": "0"},
                       {"PILOSA_TPU_TORCH_PLAN_CACHE": "0"}, {}),
    "config_off": ({}, {}, {"plan": "off", "plan_cache_bytes": 0}),
}


@pytest.mark.parametrize("case", sorted(KILL))
def test_kill_switches_match_jax(tmp_path_factory, monkeypatch, case):
    jenv, tenv, kw = KILL[case]
    jax_srv, port_srv = _open(tmp_path_factory, jax_kw=kw, port_kw=kw,
                              jax_env=jenv, port_env=tenv,
                              monkeypatch=monkeypatch)
    try:
        for pair in _mix(11)[:6]:
            for pql in pair + pair:
                j = _run(jax_srv, pql, profile=1)
                t = _run(port_srv, pql, profile=1)
                assert t[0] == j[0], pql
                if j[0] != 200:
                    assert t == j, pql
                    continue
                assert t[1]["results"] == j[1]["results"], pql
                assert t[1]["profile"]["plan"] == j[1]["profile"]["plan"]
                assert t[1]["profile"]["residency"] == \
                    j[1]["profile"]["residency"], pql
        _, jv = _call(jax_srv.uri, "GET", "/debug/vars")
        _, tv = _call(port_srv.uri, "GET", "/debug/vars")
        for block in ("planner", "planCache"):
            assert (block in tv) == (block in jv), block
        if "planCache" in tv:
            assert tv["planCache"] == jv["planCache"]
        assert ("planner" in tv) == (case == "env_plan_cache")
        assert ("planCache" in tv) == (case == "env_planner")
    finally:
        port_srv.close()
        jax_srv.close()
