"""The port's coalesced write path end to end.

Three parts:
  * the JAX package's ingest parity fuzz (tests/test_ingest_parity.py),
    ported: a port executor with ingest on against a twin pinned to the
    per-bit path by PILOSA_TPU_TORCH_INGEST=0, the same changed flags and
    the same reads, with the switch also flipped at run time;
  * both HTTP servers in-process (the port on the CPU) fed the same seeded
    Set/Clear envelopes and reads over 4 shards: identical JSON;
  * what the write does to the port's resident leaves: a dense leaf is
    patched and served without a re-upload, a sparse leaf is patched or
    dropped when its row changes slot bucket, a run leaf is dropped and
    its row, kept well above 4096 bits per shard, stays run and exact;
    Not() sees the new columns and TopN ranks from the refreshed caches.
"""

import http.client
import json
import random
import threading
from urllib.parse import urlparse

import numpy as np
import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.server import Server

SW = 1 << 20
N_SHARDS = 4


# ------------------------------------------------------ twin executors


@pytest.fixture
def twins(tmp_path, monkeypatch):
    """Two port stacks fed the same inputs: `ex` takes the coalesced path,
    `legacy` is pinned per bit through the kill switch (read per call)."""
    monkeypatch.delenv("PILOSA_TPU_TORCH_INGEST", raising=False)
    ha = Holder(str(tmp_path / "a")).open()
    hb = Holder(str(tmp_path / "b")).open()
    for h in (ha, hb):
        h.create_index("i").create_field("f")
        h.index("i").create_field("g")
    yield Executor(ha, device="cpu"), Executor(hb, device="cpu"), monkeypatch
    ha.close()
    hb.close()


def _legacy(monkeypatch, ex, pql):
    monkeypatch.setenv("PILOSA_TPU_TORCH_INGEST", "0")
    try:
        return ex.execute("i", pql)
    finally:
        monkeypatch.delenv("PILOSA_TPU_TORCH_INGEST")


def _row_columns(ex, field, row):
    return ex.execute("i", f"Row({field}={row})")[0].columns().tolist()


def test_ingest_parity_fuzz(twins):
    """~600 seeded mutations (two fields, few rows, columns straddling
    shard boundaries, Set/Clear colliding heavily) one call at a time,
    with reads between: every flag and read as the per-bit twin gives."""
    ex, legacy, monkey = twins
    rng = random.Random(0xB17)
    rows = [0, 1, 7]
    cols = ([rng.randrange(0, 2000) for _ in range(25)]
            + [SW - 3, SW + 5, 2 * SW + 11])
    for step in range(600):
        field = rng.choice(["f", "g"])
        pql = (f"{'Set' if rng.random() < 0.6 else 'Clear'}"
               f"({rng.choice(cols)}, {field}={rng.choice(rows)})")
        got = ex.execute("i", pql)
        assert got == _legacy(monkey, legacy, pql), f"step {step}: {pql}"
        if step % 40 == 17:
            f2, r2 = rng.choice(["f", "g"]), rng.choice(rows)
            assert (_row_columns(ex, f2, r2)
                    == _row_columns(legacy, f2, r2)), f"read @ {step}"
            q = f"Count(Union(Row(f={r2}), Not(Row(g={r2}))))"
            assert ex.execute("i", q) == legacy.execute("i", q)
    for field in ("f", "g"):
        for row in rows:
            assert _row_columns(ex, field, row) == _row_columns(
                legacy, field, row)
    assert (ex.execute("i", "Count(Not(Row(f=999)))")
            == legacy.execute("i", "Count(Not(Row(f=999)))"))
    assert ex.ingest_snapshot()["mutations"] == 600
    assert legacy.ingest_snapshot()["mutations"] == 0


def test_ingest_kill_switch_flip_parity(twins):
    """The switch flips every 25 mutations on one stack (batched and per
    bit alternate) while the twin stays per bit: same flags, same bits."""
    ex, legacy, monkey = twins
    rng = random.Random(0xFA)
    for step in range(300):
        pql = (f"{'Set' if rng.random() < 0.55 else 'Clear'}"
               f"({rng.randrange(0, 300)}, f={rng.randrange(0, 3)})")
        if (step // 25) % 2:
            got = _legacy(monkey, ex, pql)
        else:
            got = ex.execute("i", pql)
        assert got == _legacy(monkey, legacy, pql), f"step {step}: {pql}"
    for row in range(3):
        assert _row_columns(ex, "f", row) == _row_columns(legacy, "f", row)


def test_envelope_group_commit_and_concurrent_writers(twins):
    """A 100-call envelope is one WAL append per touched fragment (f's
    and the existence row's), where the per-bit path writes one record per
    Set and one per existence mark; concurrent writers all get their acks
    and the union reads back."""
    ex, _, _ = twins
    pql = "".join(f"Set({c}, f=5)" for c in range(100))
    assert ex.execute("i", pql) == [True] * 100
    snap = ex.ingest_snapshot()
    assert snap["mutations"] == 100 and snap["setMutations"] == 100
    assert snap["walAppends"] == 2 and snap["walOps"] == 200
    errs: list = []
    acks: dict = {}

    def writer(tid: int) -> None:
        try:
            acks[tid] = [x for c in range(tid * 50, tid * 50 + 50)
                         for x in ex.execute("i", f"Set({c}, g=9)")]
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    ts = [threading.Thread(target=writer, args=(t,), daemon=True)
          for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert not errs
    assert all(acks[t] == [True] * 50 for t in range(8))
    assert _row_columns(ex, "g", 9) == list(range(400))


def test_envelopes_the_batch_declines_take_the_per_bit_path(twins):
    """Int fields, missing fields, timestamps and string keys are not
    batched: the answers and errors are the per-bit path's."""
    ex, legacy, monkey = twins
    for h in (ex.holder, legacy.holder):
        from pilosa_tpu_torch.models.field import FieldOptions
        h.index("i").create_field("v", FieldOptions(type="int", min=0,
                                                    max=100))
    pql = "Set(3, f=1) Set(4, v=17) Clear(3, f=1)"
    assert ex.execute("i", pql) == _legacy(monkey, legacy, pql)
    assert ex.ingest_snapshot()["mutations"] == 0
    for bad in ("Set(5, f=1) Set(6, nope=1)", "Set(5, f=1, 2017-01-01T00:00)",
                "Set('k', f=1)"):
        with pytest.raises(ValueError) as got:
            ex.execute("i", bad)
        with pytest.raises(ValueError) as want:
            _legacy(monkey, legacy, bad)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
    assert _row_columns(ex, "f", 1) == _row_columns(legacy, "f", 1) == [5]
    assert ex.ingest_snapshot()["mutations"] == 0


# --------------------------------------------------- against the JAX server


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


def _rows(rng) -> dict:
    """(field, row) -> global columns: f rows 0-2 dense (12000 random bits
    per shard), f row 3 sparse, s rows 0-1 sparse (row 1 with exactly 64
    bits in shard 0, so one more moves it to the next slot bucket), r row
    0 runny (two ranges of 6000 bits per shard)."""
    out = {}
    for s in range(N_SHARDS):
        base = s * SW
        for r in range(3):
            out.setdefault(("f", r), []).append(
                base + rng.choice(SW, size=12000, replace=False))
        out.setdefault(("f", 3), []).append(
            base + rng.choice(SW, size=40, replace=False))
        out.setdefault(("s", 0), []).append(
            base + rng.choice(SW, size=100, replace=False))
        out.setdefault(("s", 1), []).append(
            base + rng.choice(SW, size=64 if s == 0 else 30, replace=False))
        a = int(rng.integers(0, 60)) * 8192
        out.setdefault(("r", 0), []).append(
            base + np.concatenate([np.arange(a, a + 6000),
                                   np.arange(a + 300000, a + 306000)]))
    return {k: np.concatenate(v) for k, v in out.items()}


def _setup(rows: dict) -> list:
    out = [("/index/i", {"options": {"trackExistence": True}}),
           ("/index/i/field/f", {}),
           ("/index/i/field/s", {"options": {"cacheType": "none"}}),
           ("/index/i/field/r", {"options": {"cacheType": "none"}}),
           ("/index/i/field/v", {"options": {"type": "int", "min": 0,
                                             "max": 1000}})]
    for (field, r), cols in rows.items():
        out.append((f"/index/i/field/{field}/import",
                    {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()}))
    return out


def _envelope(rng, pool: list) -> str:
    """Mostly Set/Clear on set fields, with columns from a small colliding
    pool and from anywhere in the 4 shards; now and then an int write,
    which sends the whole envelope down the per-bit path."""
    calls = []
    for _ in range(int(rng.integers(1, 40))):
        field, row = [("f", 0), ("f", 1), ("f", 3), ("s", 0), ("s", 1),
                      ("r", 0), ("f", 8)][int(rng.integers(7))]
        if rng.random() < 0.5:
            col = pool[int(rng.integers(len(pool)))]
        else:
            col = int(rng.integers(N_SHARDS * SW))
        op = "Set" if rng.random() < 0.7 else "Clear"
        calls.append(f"{op}({col}, {field}={row})")
    if rng.random() < 0.15:
        calls.insert(int(rng.integers(len(calls))),
                     f"Set({int(rng.integers(N_SHARDS * SW))}, "
                     f"v={int(rng.integers(1000))})")
    return " ".join(calls)


READS = ["Count(Row(f=0))", "Row(f=3)", "Count(Row(s=0))", "Row(s=1)",
         "Count(Row(r=0))", "Count(Intersect(Row(f=0), Row(f=1)))",
         "Count(Intersect(Row(s=0), Row(f=1)))",
         "Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))",
         "Count(Intersect(Row(r=0), Row(f=0)))", "Count(Not(Row(f=0)))",
         "TopN(f, n=5)", "TopN(f, Row(s=0), n=3)", "Row(f=8)",
         "Sum(Row(f=0), field=v)"]


def _leaf_gens(srv, field: str, row: int) -> tuple:
    view = srv.holder.index("i").field(field).view("standard")
    return tuple(view.fragment(s).row_generation(row)
                 for s in range(N_SHARDS))


def test_port_ingest_answers_like_the_jax_server(tmp_path):
    rng = np.random.default_rng(77)
    rows = _rows(rng)
    pool = [int(x) for x in rng.choice(N_SHARDS * SW, size=60,
                                       replace=False)]
    pool += [int(x) for x in rows[("s", 1)][:3]] + [SW - 1, 3 * SW]
    jax_srv = JaxServer(str(tmp_path / "jax"), port=0).open()
    try:
        port = Server(str(tmp_path / "torch"), port=0, device="cpu").open()
        try:
            for path, body in _setup(rows):
                want = _post(jax_srv.uri, path, body)
                assert want[0] == 200, want
                assert _post(port.uri, path, body) == want, path
            ex = port.executor
            for q in READS:  # every leaf resident before the writes
                want = _post(jax_srv.uri, "/index/i/query", q)
                assert want[0] == 200, (q, want)
                assert _post(port.uri, "/index/i/query", q) == want, q
            before = ex.hybrid_snapshot()
            assert before["residentRunLeaves"] >= 1
            assert before["residentSparseLeaves"] >= 2
            # one envelope moves s row 1 past 64 bits in shard 0 (a bucket
            # move) and touches every resident form
            s1_new = int(np.setdiff1d(np.arange(200), rows[("s", 1)])[0])
            first = (f"Set({s1_new}, s=1) "
                     f"Set(5, s=0) Clear({int(rows[('s', 0)][0])}, s=0) "
                     f"Set(7, f=0) Clear({int(rows[('f', 0)][1])}, f=0) "
                     f"Set({SW + 700000}, r=0) Set({3 * SW + 9}, f=1)")
            want = _post(jax_srv.uri, "/index/i/query", first)
            assert want[0] == 200, want
            assert _post(port.uri, "/index/i/query", first) == want
            snap = ex.ingest_snapshot()
            assert snap["patchedDense"] >= 2 and snap["patchedSparse"] >= 1
            # the run leaf, and the sparse leaf that changed bucket
            assert snap["patchDropped"] >= 2
            assert snap["patchDroppedDense"] == 0
            key = ("row", "i", "f", "standard", 0, tuple(range(N_SHARDS)),
                   _leaf_gens(port, "f", 0))
            assert ex.residency.peek(key) is not None, "not patched"
            for q in ["Count(Row(f=0))",
                      "Count(Intersect(Row(f=0), Row(f=1)))",
                      "Count(Intersect(Row(s=0), Row(f=1)))",
                      "Count(Row(r=0))", "Count(Not(Row(f=0)))",
                      "Row(s=1)", "TopN(f, n=5)"]:
                assert (_post(port.uri, "/index/i/query", q)
                        == _post(jax_srv.uri, "/index/i/query", q)), q
            after = ex.hybrid_snapshot()
            # the dense rows were served from their patched tensors; only
            # the existence row (never patched) was built again
            assert (after["denseBytesUploaded"] - before["denseBytesUploaded"]
                    == N_SHARDS * SW // 8)
            assert after["sparseUploads"] == before["sparseUploads"] + 1
            assert after["runUploads"] == before["runUploads"] + 1
            assert ex.hybrid.last(("i", "r", "standard", 0)) == "run"
            # then seeded rounds: envelopes and reads, identical JSON
            for rnd in range(6):
                for _ in range(3):
                    env = _envelope(rng, pool)
                    want = _post(jax_srv.uri, "/index/i/query", env)
                    assert want[0] == 200, (env, want)
                    assert _post(port.uri, "/index/i/query", env) == want, env
                for q in READS:
                    want = _post(jax_srv.uri, "/index/i/query", q)
                    assert _post(port.uri, "/index/i/query", q) == want, \
                        (rnd, q)
            snap = ex.ingest_snapshot()
            assert snap["mutations"] > 150
            assert snap["errors"] == snap["patchDroppedDense"] == 0
            assert ex.hybrid.last(("i", "r", "standard", 0)) == "run"
        finally:
            port.close()
    finally:
        jax_srv.close()
