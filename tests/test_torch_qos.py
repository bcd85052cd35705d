"""The port's QoS plane against the JAX package's (pilosa_tpu/qos.py):
token buckets at injected times, priority levels and resolution, the
[qos] validation messages, the priority-ordered pool, the port batcher's
priority-ordered cut, and QosPlane decisions call by call: the same
sequence of admit() calls at the same injected times through both planes
gives the same verdicts, counters and surfaces."""

import threading

import numpy as np
import pytest

from pilosa_tpu import qos as jqos
from pilosa_tpu.utils import accounting as JA
from pilosa_tpu_torch import qos as pqos
from pilosa_tpu_torch.parallel.batcher import ContinuousBatcher, _Req
from pilosa_tpu_torch.utils import accounting as PA


class _Clock:
    """A stand-in for the time module: monotonic() is the injected now."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(jqos, "time", c)
    monkeypatch.setattr(pqos, "time", c)
    return c


def _verdict(rej):
    if rej is None:
        return None
    return (rej.status, rej.retry_after, rej.reason, rej.message)


def test_constants_match_jax():
    assert pqos.PRIORITIES == jqos.PRIORITIES
    assert pqos.DEFAULT_LEVEL == jqos.DEFAULT_LEVEL
    assert pqos.MODES == jqos.MODES
    assert pqos.SHED_REASONS == jqos.SHED_REASONS
    assert pqos.THROTTLE_REASONS == jqos.THROTTLE_REASONS
    assert pqos.RETRY_AFTER_MAX_S == jqos.RETRY_AFTER_MAX_S
    assert pqos.PRIORITY_HEADER == jqos.PRIORITY_HEADER
    for name in ("SIGNAL_REFRESH_S", "HEALTH_TTL_S", "EWMA_ALPHA",
                 "STORM_WINDOW_S", "STORM_N", "QUOTA_DEBT_S"):
        assert getattr(pqos.QosPlane, name) == getattr(jqos.QosPlane, name)


@pytest.mark.parametrize("rate,burst,steps", [
    (2.0, 4.0, [(0.0, 1), (0.0, 1), (0.1, 3), (0.5, 0), (2.0, 1)]),
    (10.0, 1.0, [(0.0, 25.0), (0.3, 0), (5.0, 0), (0.0, 4)]),
    (0.5, 0.2, [(0.0, 1), (1.0, 1), (10.0, 0)]),
    (0.0, 3.0, [(0.0, 5), (100.0, 0)]),
])
def test_token_bucket_refill_and_debt_match_jax(clock, rate, burst, steps):
    j, p = jqos.TokenBucket(rate, burst), pqos.TokenBucket(rate, burst)
    assert (p.rate, p.burst, p.tokens) == (j.rate, j.burst, j.tokens)
    for dt, n in steps:
        clock.t += dt
        j.take(n, clock.t)
        p.take(n, clock.t)
        assert p.tokens == j.tokens
        for need in (0.0, 1.0, 3.0):
            assert p.wait_for(need, clock.t) == j.wait_for(need, clock.t)
    assert p.tokens == j.tokens


@pytest.mark.parametrize("name", [None, "", "interactive", "batch",
                                  "internal", "urgent", "BATCH"])
def test_priority_levels_match_jax(name):
    assert pqos.priority_level(name) == jqos.priority_level(name)


def test_current_level_and_kill_switch(monkeypatch):
    assert pqos.current_level() == pqos.DEFAULT_LEVEL
    tok = pqos.current_priority.set("interactive")
    try:
        assert pqos.current_level() == 0
        monkeypatch.setenv("PILOSA_TPU_TORCH_QOS", "0")
        assert not pqos.enabled()
        assert pqos.current_level() == pqos.DEFAULT_LEVEL
    finally:
        pqos.current_priority.reset(tok)


@pytest.mark.parametrize("header,principal", [
    (None, None), ("batch", None), (" Interactive ", "key:x"),
    ("bogus", "key:x"), (None, "key:x"), ("", "key:y"), (None, "key:z"),
    ("internal", "key:y")])
def test_priority_for_matches_jax(header, principal):
    over = {"key:x": {"priority": "batch", "queries-per-s": 5},
            "key:y": {"queries_per_s": 1}}
    j = jqos.QosPlane(default_priority="internal", principals=over)
    p = pqos.QosPlane(default_priority="internal", principals=over)
    assert p.priority_for(header, principal) == \
        j.priority_for(header, principal)
    assert p.overrides == j.overrides


@pytest.mark.parametrize("kw", [
    {"mode": "enfroce"}, {"mode": "ON"}, {"default_priority": "urgent"},
    {"burst_s": 0.0}, {"burst_s": -1.0},
    {"principals": {"key:a": {"queries-per-sec": 1}}},
    {"principals": {"key:a": {"priority": "vip"}}},
    {"principals": {"key:a": {"qps": 1, "rate": 2}}},
])
def test_config_validation_messages_match_jax(kw):
    with pytest.raises(ValueError) as pe:
        pqos.QosPlane(**kw)
    with pytest.raises(ValueError) as je:
        jqos.QosPlane(**kw)
    assert str(pe.value) == str(je.value)


def test_server_refuses_a_bad_qos_mode(tmp_path):
    from pilosa_tpu_torch.server import Server
    with pytest.raises(ValueError, match="invalid \\[qos\\] mode"):
        Server(str(tmp_path / "bad"), port=0, device="cpu",
               qos_mode="enfroce")


def _pool_order(mod) -> list:
    pool = mod.PriorityPool(1, "t")
    release = threading.Event()
    order = []
    try:
        blocker = pool.submit(release.wait, 5.0)
        futs = []
        for i, name in enumerate(("internal", "batch", None, "interactive",
                                  "batch", "interactive", "internal")):
            tok = mod.current_priority.set(name)
            try:
                futs.append(pool.submit(order.append, (name, i)))
            finally:
                mod.current_priority.reset(tok)
        release.set()
        for f in futs:
            f.result(timeout=5)
        assert blocker.result(timeout=5)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    return order


def test_priority_pool_orders_like_jax_under_saturation():
    got = _pool_order(pqos)
    assert got == _pool_order(jqos)
    assert got == [("interactive", 3), ("interactive", 5), ("batch", 1),
                   ("batch", 4), ("internal", 0), (None, 2),
                   ("internal", 6)]


def test_priority_pool_exceptions_shutdown_and_cancel():
    pool = pqos.PriorityPool(2, "t")

    def boom():
        raise RuntimeError("boom")

    f = pool.submit(boom)
    with pytest.raises(RuntimeError, match="boom"):
        f.result(timeout=5)
    assert pool.submit(lambda x: x * 2, 21).result(timeout=5) == 42
    pool.shutdown(wait=True, cancel_futures=True)
    pool.shutdown()  # twice is harmless
    with pytest.raises(RuntimeError, match="after shutdown"):
        pool.submit(lambda: 1)
    # queued work is cancelled by shutdown(cancel_futures=True)
    pool = pqos.PriorityPool(1, "t")
    release = threading.Event()
    blocker = pool.submit(release.wait, 5.0)
    queued = [pool.submit(lambda: 1) for _ in range(3)]
    pool.shutdown(wait=False, cancel_futures=True)
    release.set()
    assert blocker.result(timeout=5)
    assert all(q.cancelled() for q in queued)


def test_fanout_pools_are_priority_pools_unless_killed(monkeypatch,
                                                        tmp_path):
    from pilosa_tpu_torch.server import Server
    srv = Server(str(tmp_path / "a"), port=0, device="cpu").open()
    try:
        assert isinstance(srv.executor.fanout_pool, pqos.PriorityPool)
        assert isinstance(srv.executor.batch_exec_pool, pqos.PriorityPool)
        assert srv.executor.fanout_pool_stats()["queued"] == 0
    finally:
        srv.close()
    monkeypatch.setenv("PILOSA_TPU_TORCH_QOS", "0")
    srv = Server(str(tmp_path / "b"), port=0, device="cpu").open()
    try:
        assert not isinstance(srv.executor.fanout_pool, pqos.PriorityPool)
    finally:
        srv.close()


class _Rec(ContinuousBatcher):
    """A batcher whose dispatch records its batch."""

    def __init__(self, max_batch: int):
        super().__init__(max_batch=max_batch, admission_s=0.0)
        self.seen = []

    def _dispatch(self, key, payloads):
        self.seen.append(list(payloads))
        return payloads

    def _finalize(self, key, handle, payloads):
        return handle


def _queued(b, key, items) -> list:
    reqs = []
    for payload, prio in items:
        tok = pqos.current_priority.set(prio)
        try:
            reqs.append(_Req(payload))
        finally:
            pqos.current_priority.reset(tok)
    b._pending[key] = list(reqs)
    b._leaders.add(key)
    return reqs


@pytest.mark.parametrize("max_batch", [1, 2, 3])
def test_batcher_cut_orders_by_priority_fifo_inside_a_class(max_batch):
    b = _Rec(max_batch)
    key = ("k",)
    items = [("b1", "batch"), ("i1", "interactive"), ("n1", None),
             ("b2", "batch"), ("i2", "interactive"), ("b3", "batch"),
             ("i3", "interactive")]
    reqs = _queued(b, key, items)
    while b._pending.get(key):
        b._serve_one_batch(key)
    flat = [p for batch in b.seen for p in batch]
    # the first cut sorts the whole overflowing queue: interactive first,
    # each class in arrival order; the remainder stays sorted
    assert flat == ["i1", "i2", "i3", "b1", "b2", "b3", "n1"]
    assert all(len(batch) <= max_batch for batch in b.seen)
    assert all(r.done for r in reqs)


def test_batcher_cut_inside_one_batch_keeps_arrival_order():
    b = _Rec(8)
    key = ("k",)
    items = [("b1", "batch"), ("i1", "interactive"), ("n1", None)]
    _queued(b, key, items)
    b._serve_one_batch(key)
    assert b.seen == [["b1", "i1", "n1"]]


def test_batcher_charges_each_request_its_share():
    led = PA.UsageLedger()
    b = _Rec(8)
    key = ("k",)
    reqs = []
    for who in ("key:a", "key:b", "key:a"):
        tok = PA.current_account.set(PA.Account(led, who))
        try:
            reqs.append(_Req(who))
        finally:
            PA.current_account.reset(tok)
    b._pending[key] = list(reqs)
    b._leaders.add(key)
    b._serve_one_batch(key)
    a, bb = led.peek("key:a"), led.peek("key:b")
    assert a["deviceMs"] == pytest.approx(2 * bb["deviceMs"])
    assert a["deviceMs"] > 0 and a["queueMs"] >= 0


# -------------------------------------------------- planes, call by call


class _Batcher:
    def __init__(self, wait_ms_total, waited, depth):
        self.wait_ms_total = wait_ms_total
        self.waited = waited
        self.depth = depth

    def queue_depth(self):
        return self.depth


class _Executor:
    """The load signals admission reads: three batchers and the fan-out
    pool."""

    def __init__(self):
        self.batcher = _Batcher(0.0, 0, 0)
        self.sum_batcher = _Batcher(0.0, 0, 0)
        self.minmax_batcher = None
        self.pool = {"size": 32, "threads": 4, "queued": 0}

    def fanout_pool_stats(self):
        return dict(self.pool)


def _pair(**kw):
    return jqos.QosPlane(**kw), pqos.QosPlane(**kw)


def _same_surfaces(j, p):
    assert p.snapshot() == j.snapshot()
    assert p.totals() == j.totals()
    assert p.metrics_series() == j.metrics_series()


def _run(clock, j, p, calls):
    """calls: (dt, principal, priority, remaining); every verdict equal."""
    out = []
    for dt, principal, priority, remaining in calls:
        clock.t += dt
        vj = _verdict(j.admit(principal, priority, remaining))
        vp = _verdict(p.admit(principal, priority, remaining))
        assert vp == vj, (principal, clock.t)
        out.append(vp)
    _same_surfaces(j, p)
    return out


def test_plane_off_admits_everything(clock):
    j, p = _pair(mode="off", queries_per_s=0.001)
    got = _run(clock, j, p, [(0.01, "key:a", "interactive", None)] * 20
               + [(0.0, "key:a", "batch", -1.0)])
    assert got == [None] * 21 and p.totals()["admitted"] == 0


@pytest.mark.parametrize("mode", ["observe", "enforce"])
def test_plane_quota_decisions_match_jax(clock, mode):
    over = {"key:slow": {"queries-per-s": 0.5},
            "key:vip": {"priority": "interactive", "queries_per_s": 50}}
    j, p = _pair(mode=mode, queries_per_s=2.0, burst_s=1.5,
                 principals=over)
    rng = np.random.default_rng(11)
    who = ["key:a", "key:b", "key:slow", "key:vip", "addr:1.2.3.4"]
    calls = [(float(rng.exponential(0.2)), who[int(rng.integers(5))],
              ("interactive", "batch")[int(rng.integers(2))], None)
             for _ in range(300)]
    got = _run(clock, j, p, calls)
    refused = [v for v in got if v is not None]
    if mode == "enforce":
        assert refused and all(v[0] == 429 for v in refused)
        assert p.throttled["queriesPerS"] == len(refused)
    else:
        assert not refused and p.would_throttled["queriesPerS"] > 0


def test_plane_ledger_fed_device_and_byte_throttling(clock):
    jl, pl = JA.UsageLedger(), PA.UsageLedger()
    j = jqos.QosPlane(mode="enforce", device_ms_per_s=20.0,
                      bytes_per_s=1 << 20, burst_s=1.0, ledger=jl)
    p = pqos.QosPlane(mode="enforce", device_ms_per_s=20.0,
                      bytes_per_s=1 << 20, burst_s=1.0, ledger=pl)
    rng = np.random.default_rng(5)
    for ledger in (jl, pl):
        ledger.charge("key:old", device_ms=1e6)  # before the plane's state
    for step in range(200):
        who = ("key:old", "key:a", "key:b")[step % 3]
        charge = {"device_ms": float(rng.exponential(8.0)),
                  "hbm_bytes": int(rng.integers(0, 1 << 19)),
                  "rpc_bytes": int(rng.integers(0, 1 << 12))}
        jl.charge(who, **charge)
        pl.charge(who, **charge)
        _run(clock, j, p, [(float(rng.exponential(0.1)), who, "batch",
                            None)])
    assert p.throttled["deviceMsPerS"] + p.throttled["bytesPerS"] > 0
    # deep debt: Retry-After at the 30 s cap
    jl.charge("key:a", device_ms=1e6)
    pl.charge("key:a", device_ms=1e6)
    v = _run(clock, j, p, [(0.0, "key:a", "batch", None)])[0]
    assert v[0] == 429 and v[1] == pqos.RETRY_AFTER_MAX_S


def test_plane_health_red_and_its_ttl(clock):
    state = {"score": "green"}

    def health():
        return {"score": state["score"], "reasons": []}

    j, p = _pair(mode="enforce", health_fn=health)
    seq = [("green", 0.0), ("red", 0.5), ("red", 0.6), ("red", 0.2),
           ("green", 0.5), ("green", 1.2), ("red", 2.0), ("boom", 2.0)]
    for score, dt in seq:
        state["score"] = score
        if score == "boom":
            def health():  # noqa: F811 — a failing input sheds nothing
                raise RuntimeError("input failed")
            j.health_fn = p.health_fn = health
        _run(clock, j, p, [(dt, "key:a", "interactive", None)])
    assert p.shed["healthRed"] > 0


def test_plane_estimated_wait_and_deadline_sheds(clock):
    ej, ep = _Executor(), _Executor()
    j = jqos.QosPlane(mode="enforce", executor=ej)
    p = pqos.QosPlane(mode="enforce", executor=ep)
    rng = np.random.default_rng(3)
    for step in range(120):
        waited = int(rng.integers(0, 20))
        add_ms = float(rng.exponential(40.0)) * waited
        depth = int(rng.integers(0, 80))
        queued = int(rng.integers(0, 64))
        for ex in (ej, ep):
            ex.batcher.wait_ms_total += add_ms
            ex.batcher.waited += waited
            ex.batcher.depth = depth
            ex.pool["queued"] = queued
        if step % 7 == 0:
            ms = float(rng.exponential(100.0))
            j.observe_service("count", ms)
            p.observe_service("count", ms)
        rem = (None, -0.01, 0.0, 0.02, 0.2, 2.0, 60.0)[int(rng.integers(7))]
        _run(clock, j, p, [(float(rng.exponential(0.2)), "key:a",
                            "interactive", rem)])
        assert p.estimated_wait_ms() == j.estimated_wait_ms()
        assert p.class_cost_ms("count") == j.class_cost_ms("count")
    assert p.shed["estimatedWait"] > 0 and p.shed["deadline"] > 0


def test_plane_counters_of_the_execution_boundary():
    j, p = _pair(mode="enforce")
    for plane in (j, p):
        plane.record_expired(False)
        plane.record_expired(True)
        plane.record_expired(True)
        plane.record_cost_shed()
        plane.record_drain_shed()
    _same_surfaces(j, p)
    assert p.shed["deadlineRemote"] == 2 and p.shed["draining"] == 1


@pytest.mark.parametrize("bound", [2, 4, 16])
def test_plane_bounded_principal_tables(clock, bound):
    j, p = _pair(mode="enforce", queries_per_s=3.0, max_principals=bound)
    rng = np.random.default_rng(bound)
    calls = [(0.05, f"key:{int(rng.integers(0, 60))}", "interactive", None)
             for _ in range(400)]
    _run(clock, j, p, calls)
    assert len(p._principals) <= bound
    assert len(p._per_principal) <= bound


def test_plane_storm_counters_match_jax(clock):
    j, p = _pair(mode="enforce", queries_per_s=0.1, burst_s=10.0)
    calls = ([(0.01, "key:a", "batch", None)] * 60
             + [(6.0, "key:a", "batch", None)]
             + [(0.01, "key:b", "batch", None)] * 3)
    _run(clock, j, p, calls)
    assert p.storms == 1


@pytest.mark.parametrize("seconds", [0.0, 0.2, 1.0, 2.4, 29.1, 30.0, 1e9])
def test_retry_after_cap_and_header_match_jax(seconds):
    pr = pqos.Rejection(429, seconds, "queriesPerS", "m")
    jr = jqos.Rejection(429, seconds, "queriesPerS", "m")
    assert pr.retry_after == jr.retry_after <= pqos.RETRY_AFTER_MAX_S
    assert pqos.retry_after_header(pr.retry_after) == \
        jqos.retry_after_header(jr.retry_after)


def test_observe_mode_logs_would_be_refusals(clock):
    lines = []
    p = pqos.QosPlane(mode="observe", queries_per_s=1.0, burst_s=1.0,
                      logger=lines.append)
    for _ in range(3):
        assert p.admit("key:a", "batch", None) is None
    assert len(lines) == 2 and "would throttle key:a" in lines[0]
