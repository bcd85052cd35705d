"""The port's observability modules against their JAX originals.

pilosa_tpu_torch/utils/ holds trimmed copies of pilosa_tpu/utils/ stats,
tracing, profile, heat and telemetry. The same seeded inputs go through
both: the Prometheus text is byte-identical, the heat tracker gives the
same scores (to 1e-12 relative), counters, spills, snapshots and ring,
KernelStats and Ring the same documents. The CUDA-event timing of kernel
launches is driven with stand-in events on the CPU: it never synchronizes
and resolves only finished pairs.
"""

import os
import time

import numpy as np
import pytest
import torch

from pilosa_tpu.utils import heat as jheat
from pilosa_tpu.utils import profile as jprofile
from pilosa_tpu.utils import stats as jstats
from pilosa_tpu.utils import telemetry as jtel
from pilosa_tpu.utils import tracing as jtracing
from pilosa_tpu_torch.utils import heat as theat
from pilosa_tpu_torch.utils import profile as tprofile
from pilosa_tpu_torch.utils import stats as tstats
from pilosa_tpu_torch.utils import telemetry as ttel
from pilosa_tpu_torch.utils import tracing as ttracing

from tests.test_metrics_conformance import check_conformance

# -------------------------------------------------------------- stats


def _drive_stats(mod, seed: int):
    """One StatsClient of `mod` fed a seeded mix, with the adversarial
    keys of tests/test_metrics_conformance.py."""
    rng = np.random.default_rng(seed)
    s = mod.StatsClient()
    s.count("query/Count")
    s.count("weird name!@#")
    s.with_tags("index:idx-1", "bare").count("tagged/x", 3)
    s.with_tags("a", "b").count("multi", 1)
    s.with_tags("a", "b").timing("multi_t", 2.0)
    s.gauge("memory/rss", 123.5)
    s.set("uniq/things", "a")
    s.set("uniq/things", "b")
    s.timing("fanoutLatency/node-id-with-dashes", -1.0)
    s.timing("ünïcode/kéy", 0.25)
    s.count("9starts/with-digit", 2)
    for _ in range(200):
        name = ["query/Row", "query/Count", "http/serverErrors",
                "kernel/x", "a:b/c"][int(rng.integers(5))]
        kind = int(rng.integers(4))
        if kind == 0:
            s.count(name, int(rng.integers(1, 5)))
        elif kind == 1:
            s.gauge(name, float(rng.normal(0, 100)))
        elif kind == 2:
            s.timing(name, float(rng.exponential(5.0)))
        else:
            s.with_tags(f"node:{int(rng.integers(3))}").timing(
                name, float(rng.exponential(1.0)))
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_and_snapshot_match_jax(seed):
    j, t = _drive_stats(jstats, seed), _drive_stats(tstats, seed)
    assert t.snapshot() == j.snapshot()
    text = tstats.prometheus_exposition(t.snapshot())
    assert text == jstats.prometheus_exposition(j.snapshot())
    assert text.encode() == jstats.prometheus_exposition(
        t.snapshot()).encode()
    check_conformance(text)
    assert tstats.prometheus_exposition({}) == ""


def test_pow2_bucket_matches_jax():
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.exponential(10.0, 500), -rng.random(20),
                           [0.0, 1.0, 2.0, 1e-9, 1e9, 3.0, 0.5]])
    for v in vals.tolist():
        assert tstats._pow2_bucket(v) == jstats._pow2_bucket(v)


def test_nop_and_statsd_clients():
    assert tstats.NopStatsClient().snapshot() == {}
    sent = []

    class Sock:
        def sendto(self, msg, addr):
            sent.append((msg, addr))

    c = tstats.new_stats_client("statsd", "127.0.0.1:9")
    c.close()
    c = tstats.StatsDClient("h", 1, _sock=Sock()).with_tags("t:1")
    c.count("q", 2)
    c.timing("lat", 1.5)
    assert sent == [(b"pilosa.q:2|c|#t:1", ("h", 1)),
                    (b"pilosa.lat:1.5|ms|#t:1", ("h", 1))]
    assert isinstance(tstats.new_stats_client("expvar"), tstats.StatsClient)
    assert isinstance(tstats.new_stats_client("none"), tstats.NopStatsClient)


# -------------------------------------------------------------- tracing


def test_tracer_records_spans_and_trace_ids():
    assert ttracing.TRACE_HEADER == jtracing.TRACE_HEADER
    tr = ttracing.Tracer(limit=3)
    tok = ttracing.current_trace_id.set("abc")
    try:
        with tr.start_span("executor.Count") as span:
            span.set_tag("index", "i")
    finally:
        ttracing.current_trace_id.reset(tok)
    for i in range(4):
        tr.start_span(f"s{i}").finish()
    assert [s.name for s in tr.finished()] == ["s1", "s2", "s3"]
    assert len(ttracing.new_trace_id()) == 16
    tr2 = ttracing.Tracer()
    with tr2.start_span("executor.Count") as span:
        span.set_tag("index", "i")
    got = tr2.finished("executor.Count")[0]
    assert got.tags == {"index": "i"} and got.duration() >= 0
    assert len(got.trace_id) == 16
    nop = ttracing.NopTracer()
    with nop.start_span("x") as s:
        s.set_tag("a", 1)
    assert nop.finished() == []


# -------------------------------------------------------------- profile


def test_query_profile_matches_jax():
    def drive(mod):
        p = mod.QueryProfile(trace_id="t1", node_id="n", index="i",
                             pql=mod.truncate_pql("Count(Row(f=1))" * 40))
        p.record_call("Count", 1.23456)
        p.record_dispatch("CountBatcher", 7, 3, 2.5)
        p.record_residency(True)
        p.record_residency(False, 4096)
        p.record_residency(False, 0)
        p.finish()
        p.record_call("late", 1.0)  # sealed: dropped
        p.start_wall, p.elapsed_ms = 1.0, 2.0
        p._cached_dict = None
        return p.to_dict()

    j, t = drive(jprofile), drive(tprofile)
    assert list(t) == list(j)
    assert t == j
    h = tprofile.QueryHistory(2)
    for i in range(3):
        h.append({"i": i})
    assert h.snapshot() == [{"i": 2}, {"i": 1}] and len(h) == 2


# ----------------------------------------------------------------- heat

_GROUPS = [("i", "f", "standard"), ("i", "g", "standard"),
           ("i", "v", "bsig_v"), ("j", "f", "standard")]


def _charge(rng) -> dict:
    kind = int(rng.integers(4))
    if kind == 0:
        return {"reads": int(rng.integers(1, 3))}
    if kind == 1:
        return {"writes": int(rng.integers(1, 5))}
    if kind == 2:
        return {"h2d_bytes": int(rng.integers(1, 10000)), "uploads": 1}
    return {"evictions": 1, "device_ms": float(rng.random())}


@pytest.mark.parametrize("frags_form", [True, False],
                         ids=["frags", "keys"])
@pytest.mark.parametrize("max_fragments", [8, 30, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_heat_tracker_matches_jax(seed, max_fragments, frags_form):
    """The same seeded touch_many / scores_for / snapshot / sample_tick
    sequence at injected `now` values: scores to 1e-12 relative, the
    snapshot documents (counters, order, spill) and the ring equal."""
    rng = np.random.default_rng(seed)
    J = jheat.HeatTracker(max_fragments=max_fragments)
    T = theat.HeatTracker(max_fragments=max_fragments)
    now = 1000.0
    for step in range(300):
        now += float(rng.exponential(30.0))
        g = _GROUPS[int(rng.integers(len(_GROUPS)))]
        shards = tuple(sorted(set(
            rng.integers(0, 24, size=int(rng.integers(1, 12))).tolist())))
        kw = _charge(rng)
        keys = [(*g, s) for s in shards]
        J.touch_many(keys, now=now, **kw)
        T.touch_many(theat.Frags(*g, shards) if frags_form else keys,
                     now=now, **kw)
        if step % 17 == 0:
            q = [(*_GROUPS[int(rng.integers(len(_GROUPS)))], int(s))
                 for s in rng.integers(0, 24, size=5)]
            np.testing.assert_allclose(T.scores_for(q, now=now),
                                       J.scores_for(q, now=now),
                                       rtol=1e-12, atol=0)
        if step % 29 == 0:
            assert T.snapshot(top=5, now=now) == J.snapshot(top=5, now=now)
            assert T.sample_tick(ts=now, now=now) == \
                J.sample_tick(ts=now, now=now)
    assert T.snapshot(top=0, now=now) == J.snapshot(top=0, now=now)
    assert T.totals() == pytest.approx(J.totals(), rel=1e-12)
    assert T.since(0) == J.since(0)
    assert T.since(3, 2) == J.since(3, 2)
    if max_fragments < 100:
        assert T.spilled_fragments == J.spilled_fragments > 0


@pytest.mark.parametrize("max_fragments", [40, 4096])
def test_heat_shared_entry_path_matches_jax(max_fragments):
    """Leaf reads over a field's whole shard set keep its fragments
    equal (one entry's worth, repeated): the same documents as the JAX
    tracker through full charges, a partial read, scores of a subset,
    per-shard writes, and spills of such a group."""
    J = jheat.HeatTracker(max_fragments=max_fragments)
    T = theat.HeatTracker(max_fragments=max_fragments)
    full = tuple(range(16))
    now = 10.0

    def both(fr: theat.Frags, **kw):
        J.touch_many(fr.keys(), now=now, **kw)
        T.touch_many(fr, now=now, **kw)

    def same(top=4):
        assert T.snapshot(top=top, now=now) == J.snapshot(top=top, now=now)

    for step in range(30):
        now += 3.7 * (step % 5 + 1)
        field = "fg"[step % 2]
        both(theat.Frags("i", field, "standard", full), reads=1)
        if step % 3 == 0:
            both(theat.Frags("i", field, "standard", full),
                 h2d_bytes=16 * 4096, uploads=1, device_ms=0.7)
        if step == 9:
            both(theat.Frags("i", "f", "standard", full[2:9]), reads=2)
        if step == 10:  # a subset with gaps: an index array, not a slice
            both(theat.Frags("i", "g", "standard", full[1::3]), reads=1)
        if step == 14:
            q = theat.Frags("i", "g", "standard", full[:5])
            np.testing.assert_allclose(T.scores_for(q, now=now),
                                       J.scores_for(q.keys(), now=now),
                                       rtol=1e-12, atol=0)
        if step == 20:
            both(theat.Frags("j", "h", "standard", full), evictions=1)
            w = np.arange(1, 17)
            for s_, n in zip(full, w.tolist()):
                J.touch("j", "h", "standard", s_, writes=n, now=now)
            T.touch_many(theat.Frags("j", "h", "standard", full), writes=w,
                         now=now)
        if step % 4 == 0:
            fr = theat.Frags("i", field, "standard", full)
            np.testing.assert_allclose(T.scores_for(fr, now=now),
                                       J.scores_for(fr.keys(), now=now),
                                       rtol=1e-12, atol=0)
            same()
    same(top=0)
    assert T.totals() == pytest.approx(J.totals(), rel=1e-12)
    assert T.spilled_fragments == J.spilled_fragments
    assert (T.spilled_fragments > 0) == (max_fragments == 40)


def test_heat_per_shard_writes_match_jax():
    """A Frags with a per-shard write array charges as the JAX batched
    apply's one touch per fragment does."""
    rng = np.random.default_rng(5)
    J, T = jheat.HeatTracker(), theat.HeatTracker()
    now = 50.0
    for _ in range(40):
        now += 7.0
        shards = tuple(sorted(set(rng.integers(0, 64, size=20).tolist())))
        w = rng.integers(1, 6, size=len(shards))
        for s, n in zip(shards, w.tolist()):
            J.touch("i", "f", "standard", s, writes=n, now=now)
        T.touch_many(theat.Frags("i", "f", "standard", shards), writes=w,
                     now=now)
    assert T.snapshot(top=0, now=now) == J.snapshot(top=0, now=now)
    fr = theat.Frags("i", "f", "standard", tuple(range(64)))
    np.testing.assert_allclose(T.scores_for(fr, now=now + 9),
                               J.scores_for(fr.keys(), now=now + 9),
                               rtol=1e-12, atol=0)


def _spill_scenario(name: str, rng):
    """A seeded charge sequence for one spill regime: (max_fragments,
    [(Frags, now, charge kwargs), ...])."""
    full = tuple(range(16))
    fr = lambda f, sh=full: theat.Frags("i", f, "standard", sh)  # noqa: E731
    steps, now = [], 100.0
    if name == "rotation":  # six fields read in turn, room for three
        for i in range(40):
            now += float(rng.exponential(2.0))
            steps.append((fr("abcdef"[i % 6]), now, {"reads": 1}))
            if i % 7 == 3:
                sub = tuple(sorted(set(rng.integers(0, 24, 6).tolist())))
                steps.append((fr("abcdef"[i % 5], sub), now, {"reads": 2}))
        return 48, steps
    if name == "hot_table":  # hot fields, then new ones churn each other
        for i in range(12):
            now += 1.0
            steps.append((fr("ab"[i % 2]), now, {"reads": 3}))
        for f in "cdc":
            now += 1.0
            steps.append((fr(f), now, {"reads": 1}))
        return 32, steps
    if name == "cold_table":  # the table goes cold: the coldest spill
        for f in "abc":
            now += 5.0
            steps.append((fr(f), now, {"reads": 1}))
        for f in "de":
            now += 4000.0
            steps.append((fr(f, full[::2]), now, {"reads": 1}))
        return 48, steps
    if name == "uploads":  # charges with no read or write score zero
        for f in "abcab":
            now += 3.0
            steps.append((fr(f), now, {"h2d_bytes": 4096, "uploads": 1}))
            steps.append((fr(f, full[4:12]), now, {"reads": 1}))
            steps.append((fr(f), now, {"evictions": 1, "device_ms": 0.5}))
        return 40, steps
    if name == "same_now":  # ties: equal scores, keys decide
        for f in "abcdab":
            steps.append((fr(f), now, {"reads": 1}))
            steps.append((fr(f, full[3:9]), now, {"reads": 1}))
        return 36, steps
    if name == "writes":  # per-shard write counts at capacity
        for i in range(16):
            now += float(rng.exponential(5.0))
            sh = tuple(sorted(set(rng.integers(0, 16, 12).tolist())))
            w = rng.integers(0, 4, size=len(sh))
            steps.append((fr("abc"[i % 3], sh), now, {"writes": w}))
        return 20, steps
    if name == "late_now":  # charges queued after later ones
        for i in range(24):
            now += float(rng.exponential(3.0))
            late = now - 5.0 * (i % 3 == 2)
            steps.append((fr("abcd"[i % 4], full[i % 5:]), late,
                          {"reads": 1 + i % 2}))
        return 40, steps
    assert name == "unsorted"  # out-of-order shards and repeated keys
    for i in range(20):
        now += 2.0
        sh = tuple(rng.integers(0, 16, 10).tolist())
        steps.append((fr("abc"[i % 3], sh), now, {"reads": 1}))
    return 12, steps


@pytest.mark.parametrize("name", ["rotation", "hot_table", "cold_table",
                                  "uploads", "same_now", "writes",
                                  "late_now", "unsorted"])
def test_heat_spill_matches_jax(name, monkeypatch):
    """Charges past max_fragments spill over the arrays as the JAX
    tracker spills key by key: the same spilled count and totals, the
    same tracked entries, scores and order, in every regime: the coldest
    spill, new keys spilling each other on a hot table (the turn-by-turn
    order and its bulk tail), zero-score charges, equal scores, per-shard
    writes, charges with an earlier `now`, unsorted shards."""
    routes = {"coldest": 0, "turns": 0, "tail": 0}
    coldest = theat.HeatTracker._coldest
    tail = theat.HeatTracker._spill_tail

    def spy_coldest(self, *a):
        out = coldest(self, *a)
        routes["coldest" if out is not None else "turns"] += 1
        return out

    def spy_tail(*a):
        routes["tail"] += 1
        return tail(*a)

    monkeypatch.setattr(theat.HeatTracker, "_coldest", spy_coldest)
    monkeypatch.setattr(theat.HeatTracker, "_spill_tail",
                        staticmethod(spy_tail))
    cap, steps = _spill_scenario(name, np.random.default_rng(3))
    J = jheat.HeatTracker(max_fragments=cap)
    T = theat.HeatTracker(max_fragments=cap)
    for fr, now, kw in steps:
        if isinstance(kw.get("writes"), np.ndarray):
            for s_, n in zip(fr.shards, kw["writes"].tolist()):
                J.touch(*fr[:3], s_, writes=n, now=now)
        else:
            J.touch_many(fr.keys(), now=now, **kw)
        T.touch_many(fr if name != "unsorted" else fr.keys(), now=now,
                     **kw)
        assert T.snapshot(top=0, now=now) == J.snapshot(top=0, now=now)
        assert T.spilled_fragments == J.spilled_fragments
    assert T.totals() == pytest.approx(J.totals(), rel=1e-12)
    keys = [(*g, s) for g in {fr[:3] for fr, _, _ in steps}
            for s in range(24)]
    np.testing.assert_allclose(T.scores_for(keys, now=now + 30),
                               J.scores_for(keys, now=now + 30),
                               rtol=1e-12, atol=0)
    assert J.spilled_fragments > 0
    want = {"rotation": {"coldest", "turns"}, "hot_table": {"tail"},
            "cold_table": {"coldest"}, "uploads": {"coldest", "tail"},
            "same_now": {"coldest", "tail"}, "writes": {"turns"},
            "late_now": set(),
            "unsorted": {"coldest", "turns", "tail"}}[name]
    assert all(routes[r] for r in want), routes


def test_heat_leaf_frag_keys_match_jax():
    shards = (0, 3, 5)
    for key in [("row", "i", "f", "standard", 7, shards, (1, 1, 1)),
                ("sparse", "i", "f", "standard", 7, shards, 16, (1, 2, 3)),
                ("run", "i", "f", "standard", 7, shards, 8, (0, 0, 0)),
                ("bsicmp", "i", "v", ">", 5, 10, shards, ((1,),)),
                ("bsiplanes", "i", "v", 10, shards, ((1,),)),
                ("rows_slab", "i", "f", "standard", shards, (1, 2), ()),
                ("zeros", 3), ("bogus",), "row", ()]:
        assert theat.leaf_frag_keys(key) == jheat.leaf_frag_keys(key)
    assert (theat.HALF_LIVES, theat.FIELDS, theat.HOT_SCORE, theat.SPILL) \
        == (jheat.HALF_LIVES, jheat.FIELDS, jheat.HOT_SCORE, jheat.SPILL)


def test_heat_kill_switch_and_toggle(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_TORCH_HEAT", "0")
    assert not theat.enabled()
    monkeypatch.delenv("PILOSA_TPU_TORCH_HEAT")
    assert theat.enabled()
    T = theat.HeatTracker()
    T.enabled = False
    T.touch_many(theat.Frags("i", "f", "standard", (0, 1)), reads=1)
    assert T.snapshot(top=0)["trackedFragments"] == 0
    T.enabled = True
    T.touch_many(theat.Frags("i", "f", "standard", (3, 1)), reads=1)
    assert T.totals()["reads"] == 2  # unsorted shards: in sorted runs
    T.clear()
    assert T.totals()["reads"] == 0


# ------------------------------------------------------------ telemetry


def test_ring_matches_jax():
    rng = np.random.default_rng(9)
    J, T = jtel.Ring(16), ttel.Ring(16)
    for i in range(40):
        g = {"a": float(rng.random()), "b": int(rng.integers(9))}
        ts = 1000.0 + i * 0.7
        assert T.append(g, ts=ts) == J.append(g, ts=ts)
    for cursor, limit in [(0, 0), (30, 0), (30, 3), (99, 0), (0, 5)]:
        assert T.since(cursor, limit) == J.since(cursor, limit)
    assert T.latest() == J.latest() and len(T) == len(J) == 16


def _drive_kernels(mod):
    k = mod.KernelStats()
    rng = np.random.default_rng(11)
    for _ in range(300):
        fam = ["pallas", "sparse", "run", "ingest", "topn", "bsi"][
            int(rng.integers(6))]
        ms = float(rng.exponential(2.0)) if rng.random() < 0.9 else None
        k.record_call(fam, mod.kernel_rep(fam), int(rng.integers(1, 5)),
                      ms=ms, h2d_bytes=int(rng.integers(0, 3)) * 4096)
    k.record_wait("batcher", 12.5, 3)
    k.record_wait("ingest", 1.5)
    k.record_bytes("sparse", h2d=100, d2h=7)
    return k


def test_kernel_stats_match_jax():
    j, t = _drive_kernels(jtel), _drive_kernels(ttel)
    ts = t.snapshot()
    device = ts.pop("streamTimes")
    js = j.snapshot()
    assert ts == js
    assert device == {"pending": 0, "untimed": 0, "overlapped": 0,
                      "poolPairs": 0, "byKernel": {}, "byFamily": {}}
    assert t.totals() == j.totals()
    assert t.metrics_view() == j.metrics_view()
    t.reset()
    assert t.snapshot()["dispatches"] == 0


class _FakeEvent:
    """A CUDA event stand-in: finished once the test says so."""
    clock = 0.0

    def __init__(self):
        self.t = None
        self.done = False
        self.stream = None

    def record(self, stream):
        _FakeEvent.clock += 1.0
        self.t, self.stream, self.done = _FakeEvent.clock, stream, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time of an unfinished pair"
        return (end.t - self.t) * 0.25

    def synchronize(self):
        raise AssertionError("an event was synchronized")


def test_launch_events_never_synchronize(monkeypatch):
    """Kernel launches on a card are timed by a pooled event pair on the
    launch's stream, resolved by query() only: torch.cuda.synchronize is
    never called, unfinished pairs stay pending, and a dry pool counts
    launches as untimed instead of falling back to a synchronizing timer."""
    def no_sync(*a, **k):
        raise AssertionError("torch.cuda.synchronize was called")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.delenv("PILOSA_TPU_TORCH_TELEMETRY", raising=False)
    monkeypatch.delenv("PILOSA_TPU_TORCH_KERNEL_STATS", raising=False)
    stats = ttel.KernelStats()
    stats.stream = ttel._StreamTimes(cap_pairs=2)
    stats.stream.make_event = _FakeEvent
    stats.stream.record = lambda ev, dev: ev.record(("stream", dev))
    monkeypatch.setattr(ttel, "kernels", stats)
    card = torch.device("cuda", 0)
    tokens = []
    for _ in range(3):  # the third finds both pairs in flight
        tok = ttel.launch_begin(card)
        ttel.launch_end(tok, "pallas", "intersect_count", 2,
                        time.perf_counter(), card)
        tokens.append(tok)
    assert tokens[2].pair is None
    assert all(ev.stream == ("stream", card)
               for tok in tokens[:2] for ev in tok.pair)
    snap = stats.snapshot()["streamTimes"]
    assert (snap["pending"], snap["untimed"], snap["overlapped"],
            snap["poolPairs"]) == (2, 1, 0, 2)
    assert snap["byKernel"]["intersect_count"]["timed"] == 0
    assert snap["byKernel"]["intersect_count"]["launches"] == 3
    for ev in tokens[0].pair:
        ev.done = True
    snap = stats.snapshot()["streamTimes"]
    assert snap["pending"] == 1
    k = snap["byKernel"]["intersect_count"]
    assert (k["family"], k["timed"], k["p50Ms"]) == ("pallas", 1, 0.25)
    assert k["launches"] == 3  # the untimed one included
    for ev in tokens[1].pair:
        ev.done = True
    tok = ttel.launch_begin(card)  # a resolved pair comes back
    assert tok.pair in (tokens[0].pair, tokens[1].pair)
    assert stats.snapshot()["dispatches"] == 3
    assert "kernelStreamMs/intersect_count,family:pallas" in \
        stats.metrics_view()[1]


def test_launch_events_keep_only_pairs_alone_on_the_stream(monkeypatch):
    """Launches share one stream, so a pair with another launch begun or
    ended between its two records times that launch too: it is counted
    overlapped and returned to the pool, and only pairs alone on the
    stream give device times."""
    monkeypatch.delenv("PILOSA_TPU_TORCH_TELEMETRY", raising=False)
    monkeypatch.delenv("PILOSA_TPU_TORCH_KERNEL_STATS", raising=False)
    stats = ttel.KernelStats()
    stats.stream = ttel._StreamTimes(cap_pairs=8)
    stats.stream.make_event = _FakeEvent
    stats.stream.record = lambda ev, dev: ev.record(("stream", dev))
    monkeypatch.setattr(ttel, "kernels", stats)
    card = torch.device("cuda", 0)

    def end(tok, name):
        ttel.launch_end(tok, "pallas", name, 2, time.perf_counter(), card)

    a = ttel.launch_begin(card)   # a, b nested: both span the other
    b = ttel.launch_begin(card)
    end(b, "intersect_count")
    end(a, "program_count")
    c = ttel.launch_begin(card)   # c ends after d begins: both overlap
    d = ttel.launch_begin(card)
    end(c, "intersect_count")
    end(d, "intersect_count")
    e = ttel.launch_begin(card)   # e alone
    end(e, "intersect_count")
    with pytest.raises(ValueError):  # a raised step still closes
        with ttel.timed("sparse", "eval_hybrid", card):
            raise ValueError("step failed")
    f = ttel.launch_begin(card)   # alone again after the discard
    end(f, "program_count")
    for tok in (e, f):
        for ev in tok.pair:
            ev.done = True
    snap = stats.snapshot()["streamTimes"]
    assert (snap["pending"], snap["overlapped"], snap["untimed"]) == \
        (0, 4, 0)
    k = snap["byKernel"]
    assert (k["intersect_count"]["launches"], k["intersect_count"]["timed"],
            k["intersect_count"]["overlapped"]) == (4, 1, 3)
    assert (k["program_count"]["launches"], k["program_count"]["timed"],
            k["program_count"]["overlapped"]) == (2, 1, 1)
    assert snap["poolPairs"] <= 4  # overlapped pairs went back


def test_launch_stats_kill_switches(monkeypatch):
    stats = ttel.KernelStats()
    monkeypatch.setattr(ttel, "kernels", stats)
    cpu = torch.device("cpu")
    for env in ("PILOSA_TPU_TORCH_TELEMETRY", "PILOSA_TPU_TORCH_KERNEL_STATS"):
        monkeypatch.setenv(env, "0")
        assert ttel.launch_begin(cpu) is None
        with ttel.timed("sparse", "eval_hybrid", cpu):
            pass
        assert stats.snapshot()["dispatches"] == 0
        monkeypatch.delenv(env)
    with ttel.timed("sparse", "eval_hybrid", cpu):
        pass
    with pytest.raises(ValueError):
        with ttel.timed("run", "x", cpu):
            raise ValueError("step failed")
    snap = stats.snapshot()
    assert snap["dispatches"] == 1 and snap["calls"][0]["family"] == "sparse"


def test_sampler_counts_failures_and_stops():
    calls = []

    def source():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("gauge failed")
        return {"x": float(len(calls))}

    s = ttel.TelemetrySampler(interval=0.0, source=source)
    s.start()  # interval 0: no thread
    assert not s.running
    assert s.sample_once() == 1
    assert s.sample_once() is None and s.sample_errors == 1
    assert s.sample_once() == 2
    assert s.ring.latest() == {"x": 3.0}
    s.close()


def test_device_profiler_on_cpu(tmp_path, monkeypatch):
    prof = ttel.DeviceProfiler("cpu", kernel_names=("x",),
                               spool_dir=str(tmp_path), cap_bytes=1)
    doc = prof.capture(0.05)
    assert doc["status"] == "ok" and doc["activity"] == "cpu"
    assert doc["deviceBusyMs"] is None and doc["idleShare"] is None
    assert doc["kernels"] == doc["kernelMs"] == {}
    assert os.path.exists(doc["trace"])
    prof.capture(0.05)
    # the cap keeps only the newest capture
    assert len([n for n in os.listdir(tmp_path)
                if n.startswith("capture-")]) == 1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert prof.capture(0.05)["status"] == "busy"
    monkeypatch.setenv("PILOSA_TPU_TORCH_DEVICE_PROFILE", "0")
    assert prof.capture(1)["status"] == "disabled"
    assert prof.snapshot()["captures"] == 2


def test_busy_ms_is_a_union():
    assert ttel.busy_ms([]) == 0.0
    assert ttel.busy_ms([(0, 2), (1, 3), (5, 6)]) == 4.0


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        pytest.skip("a card is in use: the stats are the card's")
    assert ttel.device_memory_stats() == []
