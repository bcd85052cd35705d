"""The port's planner, plan cache and calibration ring, held against the
JAX package's on twin holders.

Both holders get the same data from a numpy seed over 4 shards: set
fields f and g with rows of skewed cardinality (rows 4 and 5 of f stay
empty, so short-circuits fire), an existence row and an int field v.
Then, at tolerance 0:

  * plan_call of both planners over seeded random trees of every planned
    call gives the same planned PQL and the same plan node (reorders,
    short-circuits, pushdown, order, estimates);
  * subtree_cache_key is equal or different in the same cases: equal for
    permuted operands once planned, different after a write to any leaf,
    None for the shapes neither can key;
  * the executors with planner and cache on give the JAX answers, plan
    nodes (cache events, hybrid entries, actual cardinality) and cache
    counters, over queries with Set/Clear writes between rounds;
  * PlanCache (LRU by bytes, the scalar cost, the epoch fence, enabled)
    and CalibrationRing replay the same sequences to the same state;
  * a cached Row result whose tensor is the resident leaf itself is never
    read again after a write patches that leaf: the answer carries the
    new bit, for each leaf form.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu import planner as jplanner
from pilosa_tpu.executor import ExecutionError as JaxExecutionError
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.parallel import residency as jres
from pilosa_tpu.pql import parse_string as jparse
from pilosa_tpu.utils import profile as jprofile
from pilosa_tpu_torch import planner as tplanner
from pilosa_tpu_torch.executor import ExecutionError, Executor
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.parallel import residency as tres
from pilosa_tpu_torch.pql.parser import parse_string as tparse
from pilosa_tpu_torch.utils import profile as tprofile

N_SHARDS = 4
SW = 1 << 20
SHARDS = list(range(N_SHARDS))


def _load(h, field_options, int_options) -> None:
    """The seeded data set: f rows 0-3 of 12 to 12000 bits per shard
    (sparse, dense and one run row), g rows 0-2, existence over every
    column set, int field v over 3000 columns."""
    rng = np.random.default_rng(5)
    idx = h.create_index("i")
    f = idx.create_field("f", field_options())
    g = idx.create_field("g", field_options())
    v = idx.create_field("v", int_options())
    every = []
    for r, n in enumerate((12, 300, 12000)):
        cols = np.concatenate([rng.choice(SW, n, replace=False) + s * SW
                               for s in SHARDS])
        f.import_bits([r] * cols.size, cols.tolist())
        every.append(cols)
    run = np.concatenate([np.arange(a, a + 6000) + s * SW
                          for s in SHARDS for a in (1000, 500000)])
    f.import_bits([3] * run.size, run.tolist())
    every.append(run)
    for r in range(3):
        cols = rng.integers(0, N_SHARDS * SW, size=400 * (r + 1))
        g.import_bits([r] * cols.size, cols.tolist())
        every.append(cols)
    vcols = rng.choice(N_SHARDS * SW, size=3000, replace=False)
    v.import_values(vcols.tolist(), rng.integers(0, 100, size=3000).tolist())
    every.append(vcols)
    ex = np.unique(np.concatenate(every))
    idx.existence_field().import_bits([0] * ex.size, ex.tolist())


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax"))).open()
    th = Holder(str(tmp_path_factory.mktemp("port"))).open()
    _load(jh, JaxFieldOptions,
          lambda: JaxFieldOptions(type="int", min=0, max=100))
    _load(th, FieldOptions, lambda: FieldOptions(type="int", min=0, max=100))
    yield jh, th
    th.close()
    jh.close()


def _bitmap(rng, depth: int) -> str:
    if depth <= 0 or rng.random() < 0.3:
        k = rng.random()
        if k < 0.1:
            return f"Range(v {['<', '>=', '=='][int(rng.integers(3))]} " \
                   f"{int(rng.integers(100))})"
        field = "f" if k < 0.75 else "g"
        return f"Row({field}={int(rng.integers(6 if field == 'f' else 4))})"
    op = ("Intersect", "Union", "Difference", "Xor",
          "Not")[int(rng.integers(5))]
    if op == "Not":
        return f"Not({_bitmap(rng, depth - 1)})"
    kids = ", ".join(_bitmap(rng, depth - 1)
                     for _ in range(int(rng.integers(2, 4))))
    return f"{op}({kids})"


def _query(rng) -> str:
    inner = _bitmap(rng, int(rng.integers(1, 4)))
    shape = rng.random()
    if shape < 0.4:
        return f"Count({inner})"
    if shape < 0.5:
        return f"TopN(f, {inner}, n=3)"
    if shape < 0.6:
        return f"Sum({inner}, field=v)"
    if shape < 0.65:
        return f"Max({inner}, field=v)"
    if shape < 0.75:
        return f"GroupBy(Rows(field=g), filter={inner})"
    return inner


@pytest.mark.parametrize("seed", range(4))
def test_plan_call_matches_jax(twins, seed):
    jh, th = twins
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(40):
        pql = _query(rng)
        jp, ji = jex.planner.plan_call(jh.index("i"), jparse(pql).calls[0],
                                       SHARDS)
        tp, ti = tex.planner.plan_call(th.index("i"), tparse(pql).calls[0],
                                       SHARDS)
        assert tp.to_pql() == jp.to_pql(), pql
        assert ti == ji, pql
    assert tex.planner.snapshot() == jex.planner.snapshot()
    assert tex.planner.snapshot()["shortCircuits"] > 0


def test_planner_never_mutates_the_parsed_call(twins):
    _, th = twins
    tex = Executor(th, device="cpu")
    call = tparse("Count(Intersect(Row(f=2), Row(f=0), Row(f=5)))").calls[0]
    before = call.to_pql()
    planned, info = tex.planner.plan_call(th.index("i"), call, SHARDS)
    assert call.to_pql() == before
    assert planned.to_pql() == "Count(Union())"
    assert info["shortCircuits"] == 1 and info["pushdown"]


@pytest.mark.parametrize("pql", ["Count(Intersect())", "Difference()",
                                 "Union(Row(f=1), Intersect())",
                                 "Count(Difference())"])
def test_zero_operand_error_matches_jax(twins, pql):
    """From the planner, and from _compile with the planner off."""
    jh, th = twins
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    with pytest.raises(JaxExecutionError) as je:
        jex.execute("i", pql)
    with pytest.raises(ExecutionError) as te:
        tex.execute("i", pql)
    assert str(te.value) == str(je.value)
    tex.planner = None
    with pytest.raises(ExecutionError) as te2:
        tex.execute("i", pql)
    assert str(te2.value) == str(je.value)


def _keys(ex, key_fn, h, pqls: list) -> list:
    """The plan-cache key of each planned bitmap call."""
    out = []
    for pql, parse in pqls:
        call = parse(pql).calls[0]
        planned, _ = ex.planner.plan_call(h.index("i"), call, SHARDS)
        out.append(key_fn(ex, h.index("i"), planned, SHARDS))
    return out


KEYED = ["Intersect(Row(f=0), Row(f=2), Row(f=1))",
         "Intersect(Row(f=1), Row(f=0), Row(f=2))",
         "Intersect(Row(f=2), Row(f=1), Row(f=0))",
         "Union(Row(g=1), Not(Row(f=2)))", "Union(Not(Row(f=2)), Row(g=1))",
         "Difference(Row(f=2), Row(g=0))", "Difference(Row(g=0), Row(f=2))",
         "Intersect(Range(v > 40), Row(f=2))",
         "Intersect(Row(f=2), Range(v > 40))", "Range(v < 10)",
         "Row(nofield=1)", "Intersect(Row(f=2), Row(nofield=3))",
         "Row(f=1)", "Xor(Row(f=1), Row(f=3), Row(g=2))"]


def test_subtree_cache_keys_equal_in_the_same_cases(twins, tmp_path):
    jh, th = twins
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    jk = _keys(jex, jplanner.subtree_cache_key, jh,
               [(p, jparse) for p in KEYED])
    tk = _keys(tex, tplanner.subtree_cache_key, th,
               [(p, tparse) for p in KEYED])
    assert [k is None for k in tk] == [k is None for k in jk]
    assert sum(k is None for k in tk) == 2
    for a in range(len(KEYED)):
        for b in range(len(KEYED)):
            assert (tk[a] == tk[b]) == (jk[a] == jk[b]), (KEYED[a],
                                                           KEYED[b])
    assert tk[0] == tk[1] == tk[2] and tk[3] == tk[4] and tk[5] != tk[6]
    # a write to any leaf changes the key of every subtree over it
    for h, ex, key_fn, parse in (
            (jh, jex, jplanner.subtree_cache_key, jparse),
            (th, tex, tplanner.subtree_cache_key, tparse)):
        before = _keys(ex, key_fn, h, [(p, parse) for p in KEYED])
        h.index("i").field("g").set_bit(1, 3 * SW + 17)
        h.index("i").field("v").set_value(SW + 5, 50)
        after = _keys(ex, key_fn, h, [(p, parse) for p in KEYED])
        h.index("i").field("g").clear_bit(1, 3 * SW + 17)
        changed = [a != b for a, b in zip(before, after)]
        assert changed == [False, False, False, True, True, False, False,
                           True, True, True, False, False, False, False]
        h.index("i").field("v").clear_value(SW + 5)


def _canon(result):
    if hasattr(result, "segments"):
        return {int(s): [int(c) for c in cols]
                for s, cols in result.segments.items()}
    if hasattr(result, "val"):
        return (result.val, result.count)
    if isinstance(result, list):
        return [tuple(r) if isinstance(r, tuple) else r for r in result]
    return result


def _profiled(ex, prof_mod, pql: str) -> tuple:
    prof = prof_mod.QueryProfile()
    tok = prof_mod.current_profile.set(prof)
    try:
        res = ex.execute("i", pql)
    finally:
        prof_mod.current_profile.reset(tok)
    prof.finish()
    return [_canon(r) for r in res], prof.to_dict()["plan"]


WRITES = ["Set(17, f=2) Set(1048600, g=0) Clear(2097200, f=1)",
          "Set(3145800, f=0) Clear(17, f=2)", "Set(5000, v=77)"]


@pytest.mark.parametrize("seed", range(2))
def test_executors_with_planner_and_cache_match_jax(tmp_path, seed):
    """Seeded queries, each in two operand permutations and twice, with
    writes between rounds: answers, plan nodes and cache counters."""
    jh = JaxHolder(str(tmp_path / "jax")).open()
    th = Holder(str(tmp_path / "port")).open()
    try:
        _load(jh, JaxFieldOptions,
              lambda: JaxFieldOptions(type="int", min=0, max=100))
        _load(th, FieldOptions,
              lambda: FieldOptions(type="int", min=0, max=100))
        jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
        rng = np.random.default_rng(100 + seed)
        queries = [_query(rng) for _ in range(14)]
        queries += ["Count(Intersect(Row(f=1), Row(f=2)))",
                    "Count(Intersect(Row(f=2), Row(f=1)))",
                    "Count(Intersect(Row(f=0), Row(f=5)))", "Row(f=1)",
                    "Sum(Range(v > 30), field=v)"]
        for rnd in range(3):
            for pql in queries + queries:
                jr, jplan = _profiled(jex, jprofile, pql)
                tr, tplan = _profiled(tex, tprofile, pql)
                assert tr == jr, pql
                assert tplan == jplan, pql
            if rnd < len(WRITES):
                assert tex.execute("i", WRITES[rnd]) == \
                    jex.execute("i", WRITES[rnd])
        tsnap, jsnap = tex.plan_cache.snapshot(), jex.plan_cache.snapshot()
        assert tsnap == jsnap
        assert tsnap["hits"] > 0 and tsnap["misses"] > 0
        assert tex.planner.snapshot() == jex.planner.snapshot()
        th_hbm, jh_hbm = tex.hbm_snapshot(top=0), jex.hbm_snapshot(top=0)
        for k in ("planCacheBytes", "planCacheEntries"):
            assert th_hbm[k] == jh_hbm[k], k
    finally:
        th.close()
        jh.close()


# ------------------------------------------------------------- PlanCache


def _cache_ops(cache, make_value) -> list:
    """A fixed sequence over a 3-row budget: puts of rows and scalars,
    hits, misses, an over-budget put, a put fenced by clear(), a put and
    a get while disabled. Returns the snapshot after each step."""
    row = 4 * 128
    cache.budget = 3 * row
    snaps = []
    steps = [("put", "a", row), ("put", "b", row), ("get", "a", 0),
             ("put", "n1", 0), ("put", "n2", 0), ("get", "zz", 0),
             ("put", "c", row), ("get", "b", 0), ("put", "d", row),
             ("get", "a", 0), ("get", "n1", 0), ("put", "big", 5 * row),
             ("get", "big", 0), ("fence", "e", row), ("put", "f", row),
             ("off", "g", row), ("on", "f", 0)]
    for op, key, nbytes in steps:
        if op == "put":
            if nbytes:
                cache.put((key,), make_value(nbytes), nbytes)
            else:
                cache.put((key,), 7, cache.SCALAR_COST)
        elif op == "get":
            cache.get((key,))
        elif op == "fence":
            epoch = cache.epoch
            cache.clear()
            cache.put((key,), make_value(nbytes), nbytes, epoch=epoch)
        elif op == "off":
            cache.enabled = False
            cache.put((key,), make_value(nbytes), nbytes)
            assert cache.get(("f",)) is None
        else:
            cache.enabled = True
            assert cache.get((key,)) is not None
        snaps.append((cache.snapshot(), list(cache._lru)))
    return snaps


def test_plan_cache_replays_jax():
    jc, tc = jres.PlanCache(), tres.PlanCache()
    assert tc.SCALAR_COST == jc.SCALAR_COST == 256
    assert tc.budget == jc.budget == 256 << 20
    js = _cache_ops(jc, lambda n: np.zeros(n // 4, dtype=np.uint32))
    ts = _cache_ops(tc, lambda n: torch.zeros(n // 4, dtype=torch.int32))
    assert ts == js
    assert ts[-1][0]["evictions"] > 0 and ts[-1][0]["hits"] > 0
    # scalars hold no device memory: only the tensors' storages count
    assert sum(n for _, n in tc.storages()) == 4 * 128


def test_calibration_ring_replays_jax():
    jr, tr = jplanner.CalibrationRing(size=4), tplanner.CalibrationRing(
        size=4)
    rng = np.random.default_rng(3)
    for i in range(9):
        est = None if i % 4 == 3 else int(rng.integers(0, 50))
        actual = None if i % 3 == 2 else int(rng.integers(0, 50))
        entry = {"call": "Count", "est": est, "actual": actual, "i": i}
        jr.record(dict(entry))
        tr.record(dict(entry))
    for limit in (0, 2, 32):
        assert tr.snapshot(limit) == jr.snapshot(limit)
    assert tr.snapshot()["compared"] > 0
    tr.reset()
    jr.reset()
    assert tr.snapshot() == jr.snapshot()


def test_record_calibration_matches_jax(twins):
    """One profiled query's plan nodes beside its results: a count
    calibrates, a ValCount records its estimate alone, h2d bytes ride
    the first entry."""
    jh, th = twins
    pql = "Count(Intersect(Row(f=1), Row(f=2))) Sum(Row(f=1), field=v) " \
          "Count(Row(g=2))"
    got = []
    for ex, prof_mod, pl in ((JaxExecutor(jh), jprofile, jplanner),
                             (Executor(th, device="cpu"), tprofile,
                              tplanner)):
        pl.calibration.reset()
        prof = prof_mod.QueryProfile()
        tok = prof_mod.current_profile.set(prof)
        try:
            query = (jparse if pl is jplanner else tparse)(pql)
            results = ex.execute("i", query)
        finally:
            prof_mod.current_profile.reset(tok)
        prof.finish()
        pl.record_calibration(prof, query.calls, results)
        snap = pl.calibration.snapshot()
        for e in snap["entries"]:
            e.pop("ts"), e.pop("elapsedMs")
        got.append(snap)
        pl.calibration.reset()
    assert got[1] == got[0]
    assert got[1]["recorded"] == 3 and got[1]["compared"] == 2


# ---------------------------------------------------------- aliasing


@pytest.mark.parametrize("row,rep", [(2, "dense"), (1, "sparse"),
                                     (3, "run")])
def test_cached_row_result_never_read_after_write(tmp_path, row, rep):
    """Row(f=r) of a dense row caches the resident leaf tensor itself. A
    Set through the ingest path patches the row's leaves to their new
    keys; the next read misses the cache (the old key carries the old
    generations) and answers with the bit. The same for Count."""
    th = Holder(str(tmp_path / "d")).open()
    try:
        _load(th, FieldOptions, lambda: FieldOptions(type="int", min=0,
                                                     max=100))
        ex = Executor(th, device="cpu")
        pql = f"Row(f={row})"
        _, plan = _profiled(ex, tprofile, pql)
        assert plan[0]["hybrid"][0]["rep"] == rep
        (first,), plan = _profiled(ex, tprofile, pql)
        assert plan[0]["cache"] == [{"expr": pql, "hit": True}]
        cached = [v for v, _ in ex.plan_cache._lru.values()
                  if isinstance(v, torch.Tensor)]
        if rep == "dense":
            # the cached result is the resident leaf: one storage
            leaves = {tres.tensor_storage(a)
                      for a in ex.residency._lru.values()}
            assert tres.tensor_storage(cached[0]) in leaves
        have = set(first[2])
        col = next(c for c in range(2 * SW + 4321, 3 * SW) if c not in have)
        count = ex.execute("i", f"Count(Row(f={row}))")[0]
        assert ex.execute("i", f"Set({col}, f={row})") == [True]
        assert ex.ingest_snapshot()["mutations"] == 1
        (again,), plan = _profiled(ex, tprofile, pql)
        assert plan[0]["cache"] == [{"expr": pql, "hit": False}]
        assert again[2] == sorted(first[2] + [col])
        assert ex.execute("i", f"Count(Row(f={row}))")[0] == count + 1
        _, plan = _profiled(ex, tprofile, pql)
        assert plan[0]["cache"] == [{"expr": pql, "hit": True}]
    finally:
        th.close()


def test_estimation_surprise_keeps_the_executor_error(twins):
    """A call the planner cannot estimate is left as written: the
    executor raises its own error, the JAX one's."""
    from pilosa_tpu.pql import Call as JaxCall
    from pilosa_tpu_torch.pql import Call

    jh, th = twins
    errors = []
    for ex, h, call_cls, err in (
            (JaxExecutor(jh), jh, JaxCall, JaxExecutionError),
            (Executor(th, device="cpu"), th, Call, ExecutionError)):
        weird = call_cls("Count", {}, [call_cls("Intersect", {}, [
            call_cls("Row", {"f": 0}), call_cls("Bogus", {})])])
        with pytest.raises(err, match="expected bitmap call") as e:
            ex._execute_call(h.index("i"), weird, None)
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_planned_port_matches_unplanned_port(tmp_path, monkeypatch):
    """The port with planner and cache on against the port with both off
    (the kill switches) on one holder, over seeded queries with per-bit
    writes between them: a warm cache never serves a pre-write answer."""
    th = Holder(str(tmp_path / "d")).open()
    try:
        _load(th, FieldOptions, lambda: FieldOptions(type="int", min=0,
                                                     max=100))
        planned = Executor(th, device="cpu")
        monkeypatch.setenv("PILOSA_TPU_TORCH_PLANNER", "0")
        monkeypatch.setenv("PILOSA_TPU_TORCH_PLAN_CACHE", "0")
        plain = Executor(th, device="cpu")
        assert plain.planner is None and plain.plan_cache is None
        rng = np.random.default_rng(17)
        idx = th.index("i")
        queries = [_query(rng) for _ in range(12)]
        for _ in range(6):
            for pql in queries:
                try:
                    a = [_canon(r) for r in planned.execute("i", pql)]
                except (ExecutionError, ValueError):
                    a = "error"
                try:
                    b = [_canon(r) for r in plain.execute("i", pql)]
                except (ExecutionError, ValueError):
                    b = "error"
                assert a == b, pql
            field = ("f", "g")[int(rng.integers(2))]
            row, col = int(rng.integers(4)), int(rng.integers(N_SHARDS * SW))
            if rng.random() < 0.7:
                idx.field(field).set_bit(row, col)
                idx.mark_exists([col])
            else:
                idx.field(field).clear_bit(row, col)
        snap = planned.plan_cache.snapshot()
        assert snap["hits"] > 0 and snap["misses"] > 0
    finally:
        th.close()
