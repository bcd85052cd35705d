"""The port's usage accounting, SLO tracker and health score against the
JAX package's (pilosa_tpu/utils/accounting.py, utils/telemetry.py
health_score): the same seeded charges, headers, queries and
observations at injected times through both modules give equal ledgers,
principals, classes, burn rates and health verdicts."""

import numpy as np
import pytest

from pilosa_tpu import pql as jpql
from pilosa_tpu.utils import accounting as JA
from pilosa_tpu.utils import telemetry as JT
from pilosa_tpu_torch import pql as ppql
from pilosa_tpu_torch.utils import accounting as PA
from pilosa_tpu_torch.utils import telemetry as PT


def _strip(snap: dict) -> dict:
    """A ledger snapshot without the wall-clock stamps."""
    out = dict(snap)
    out["principals"] = {p: {k: v for k, v in e.items()
                             if k != "lastChargeWall"}
                         for p, e in snap["principals"].items()}
    return out


def _charges(seed: int, n: int, principals: int) -> list:
    """A seeded sequence of (principal, charge kwargs)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = f"key:p{int(rng.zipf(1.6)) % principals}"
        kw = {}
        if rng.random() < 0.8:
            kw["device_ms"] = round(float(rng.exponential(3.0)), 3)
        if rng.random() < 0.4:
            kw["hbm_bytes"] = int(rng.integers(0, 1 << 27))
        if rng.random() < 0.3:
            kw["rpc_bytes"] = int(rng.integers(0, 1 << 16))
        if rng.random() < 0.5:
            kw["queue_ms"] = round(float(rng.exponential(1.0)), 3)
        kw["queries"] = int(rng.random() < 0.9)
        kw["errors"] = int(rng.random() < 0.05)
        kw["plan_cache_hits"] = int(rng.integers(0, 3))
        out.append((p, kw))
    return out


@pytest.mark.parametrize("seed,n,principals,bound", [
    (0, 200, 8, 256), (1, 500, 40, 8), (2, 400, 300, 16), (3, 50, 3, 2)])
def test_ledger_matches_jax_after_the_same_charges(seed, n, principals,
                                                   bound):
    j = JA.UsageLedger(max_principals=bound, ring_size=5)
    p = PA.UsageLedger(max_principals=bound, ring_size=5)
    seq = _charges(seed, n, principals)
    for i, (who, kw) in enumerate(seq):
        j.charge(who, **kw)
        p.charge(who, **kw)
        if i % 37 == 36:  # the sampler's ticks, at injected wall times
            assert j.sample_tick(ts=1000.0 + i) == p.sample_tick(
                ts=1000.0 + i)
    for top in (0, 1, 5):
        assert _strip(p.snapshot(top=top)) == _strip(j.snapshot(top=top))
    assert p.totals() == j.totals()
    for who in {w for w, _ in seq} | {PA.SPILL, "key:nobody"}:
        assert p.peek(who) == j.peek(who)
    for cursor, limit in ((0, 0), (2, 0), (0, 2), (99, 0)):
        assert p.since(cursor, limit) == j.since(cursor, limit)
    # the totals stay exact under the bound
    assert p.totals()["queries"] == sum(kw["queries"] for _, kw in seq)
    if principals > bound:
        assert p.snapshot()["spilledPrincipals"] > 0
        assert p.snapshot()["trackedPrincipals"] <= bound
    p.clear()
    j.clear()
    assert _strip(p.snapshot()) == _strip(j.snapshot())


_HOSTILE = "a,b\nc\rd\te\"f\\g\x01h" + "x" * 100


@pytest.mark.parametrize("headers,addr", [
    ({}, None),
    ({}, "10.0.0.7"),
    ({"X-API-Key": "tenant-a"}, "10.0.0.7"),
    ({"Authorization": "Bearer s3cret"}, "10.0.0.7"),
    ({"Authorization": "Basic dXNlcjpwYXNz", "X-API-Key": "k"}, None),
    ({"X-Pilosa-Principal": "key:tenant-c", "X-API-Key": "other"}, "1.2.3.4"),
    ({"X-Pilosa-Principal": _HOSTILE}, None),
    ({"X-API-Key": _HOSTILE}, None),
    ({"X-API-Key": "   "}, "5.6.7.8"),
    ({"X-Pilosa-Principal": "", "Authorization": _HOSTILE}, None),
    ({}, _HOSTILE),
    (None, "::1"),
])
def test_principal_precedence_matches_jax(headers, addr):
    got = PA.principal_from_headers(headers, addr)
    assert got == JA.principal_from_headers(headers, addr)
    assert "," not in got and "\n" not in got and len(got) <= 69
    if headers and headers.get("Authorization") and not (
            headers.get("X-Pilosa-Principal") or headers.get("X-API-Key")):
        assert got.startswith("auth:") and "s3cret" not in got


def test_principal_header_name_and_spill_bucket_match_jax():
    assert PA.PRINCIPAL_HEADER == JA.PRINCIPAL_HEADER
    assert PA.SPILL == JA.SPILL and PA.FIELDS == JA.FIELDS
    assert PA.QUERY_CLASSES == JA.QUERY_CLASSES


_CORPUS = [
    "Count(Row(f=1))", "Row(f=1)", "Union(Row(f=1), Row(f=2))",
    "Intersect(Row(f=1), Row(g=2))", "Difference(Row(f=1), Row(f=2))",
    "Xor(Row(f=1), Row(f=2))", "Not(Row(f=1))", "Range(v > 10)",
    "TopN(f, n=3)", "TopN(f, Row(g=1), n=5)",
    "GroupBy(Rows(field=f), Rows(field=g))", "Rows(field=f)",
    "Sum(field=v)", "Min(Row(f=1), field=v)", "Max(field=v)",
    "Set(1, f=2)", "Clear(1, f=2)", "Options(Count(Row(f=1)), shards=[0])",
    "Options(TopN(f, n=2), shards=[1])", "Options(Row(f=1), shards=[0])",
    "Count(Row(f=1)) TopN(f)", "TopN(f) Count(Row(f=1))",
    "SetRowAttrs(f, 1, x=1)", "ClearRow(f=1)", "Store(Row(f=1), g=2)",
]


@pytest.mark.parametrize("pql", _CORPUS)
def test_classify_query_matches_jax(pql):
    got = PA.classify_query(ppql.parse_string(pql))
    assert got == JA.classify_query(jpql.parse_string(pql))
    assert got in PA.QUERY_CLASSES + ("other",)


def _slo_pair(**kw):
    objs = [("availability", None, None, 0.999),
            ("count-latency", "count", 50.0, 0.99),
            ("topn-latency", "topn", 200.0, 0.9)]
    return (JA.SLOTracker([JA.Objective(*o) for o in objs], **kw),
            PA.SLOTracker([PA.Objective(*o) for o in objs], **kw))


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"short_window": 60.0, "long_window": 600.0}),
    (2, {"burn_yellow": 1.0, "burn_red": 2.0}),
    (3, {"short_window": 30.0, "long_window": 30.0, "burn_red": 5.0}),
])
def test_slo_burn_math_matches_jax_at_injected_times(seed, kw):
    j, p = _slo_pair(**kw)
    rng = np.random.default_rng(seed)
    now = 5000.0
    for step in range(600):
        now += float(rng.exponential(4.0))
        qclass = ("read", "count", "topn", "groupby",
                  "other")[int(rng.integers(5))]
        elapsed = float(rng.exponential(0.08))
        ok = bool(rng.random() > 0.02 * (1 + step // 200))
        j.observe(qclass, elapsed, ok, now=now)
        p.observe(qclass, elapsed, ok, now=now)
        if step % 50 == 49:
            for at in (now, now + 100.0, now + 4000.0):
                assert p.evaluate(at) == j.evaluate(at)
                assert p.worst(at) == j.worst(at)
    ev = p.evaluate(now)
    assert set(ev) == {"availability", "count-latency", "topn-latency"}


def test_slo_validation_and_idle_objective_match_jax():
    for target in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError) as pe:
            PA.Objective("x", None, None, target)
        with pytest.raises(ValueError) as je:
            JA.Objective("x", None, None, target)
        assert str(pe.value) == str(je.value)
    for short, long in ((0.0, 10.0), (20.0, 10.0)):
        with pytest.raises(ValueError) as pe:
            PA.SLOTracker([], short_window=short, long_window=long)
        with pytest.raises(ValueError) as je:
            JA.SLOTracker([], short_window=short, long_window=long)
        assert str(pe.value) == str(je.value)
    j, p = _slo_pair()
    assert p.evaluate(10.0) == j.evaluate(10.0)
    assert p.worst(10.0) == ("green", "")


_HEALTH = [
    {},
    {"walPoisoned": True},
    {"needsRebuild": 2},
    {"damagedFragments": 3},
    {"damagedFragments": 3, "needsRebuild": 1},
    {"errorRate": 0.05},
    {"errorRate": 0.1},
    {"errorRate": 1.99},
    {"errorRate": 2.0},
    {"queueSaturation": 1.9},
    {"queueSaturation": 2.0},
    {"draining": True},
    {"draining": True, "errorRate": 3.0},
    {"fencedShards": 5},
    {"sloStatus": "yellow", "sloReason": "SLO count-latency burning"},
    {"sloStatus": "red", "sloReason": "SLO x burning error budget"},
    {"sloStatus": "red"},
    {"sloStatus": "green", "sloReason": "ignored"},
    {"needsRebuild": 1, "fencedShards": 2, "draining": True,
     "queueSaturation": 4.5, "errorRate": 0.5},
    {"walPoisoned": False, "needsRebuild": 0, "damagedFragments": 0,
     "errorRate": 0.0, "queueSaturation": 0.0, "draining": False,
     "fencedShards": 0},
]


@pytest.mark.parametrize("inputs", _HEALTH)
def test_health_score_matches_jax(inputs):
    got = PT.health_score(inputs)
    assert got == JT.health_score(inputs)
    assert got["score"] in ("green", "yellow", "red")


def test_health_thresholds_match_jax():
    for name in ("ERROR_RATE_YELLOW", "ERROR_RATE_RED",
                 "QUEUE_SATURATION_YELLOW"):
        assert getattr(PT, name) == getattr(JT, name)


def test_account_charges_its_ledger_and_kill_switch(monkeypatch):
    led = PA.UsageLedger()
    tok = PA.current_account.set(PA.Account(led, "key:a"))
    try:
        PA.current_account.get().charge(device_ms=1.5, queries=1)
    finally:
        PA.current_account.reset(tok)
    assert PA.current_account.get() is None
    assert led.peek("key:a")["deviceMs"] == 1.5
    assert PA.enabled()
    monkeypatch.setenv("PILOSA_TPU_TORCH_ACCOUNTING", "0")
    assert not PA.enabled()
