"""Time, mutex and bool fields, ClearRow, Store, Options and the roaring
import end to end, against the JAX server.

Both servers run in-process with their defaults (planner, plan cache and
ingest on; the port on the CPU, through its kernels' plain versions) over
the same seeded Star Trace-shaped data at 4 shards (the reference's
getting-started schema, docs/getting-started.md): a time field stargazer
(quantum YMD, timestamps over 2019-01-01..2019-03-31, imported with
epoch numbers and ISO-8601 strings), a mutex field license (imported,
then 10 % of its columns reassigned), a bool field fork, and a set field
extra loaded through /import-roaring with a standard and a time view.
Every comparison is of HTTP status and JSON, at tolerance 0: time Range
windows, Intersects with mutex and bool rows, TopN, Rows and GroupBy over
the three field types, Options, ?explain=true of a time Range, the writes
(timestamped, mutex and bool Set, Clear, ClearRow, Store) and the reads
they change, the error texts, the plan cache over a time Range, and
mutex, bool and timestamped envelopes with ingest on against the per-bit
path.
"""

import base64
import io
from datetime import datetime, timezone

import numpy as np
import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage.roaring import Bitmap

from tests.test_torch_obs_slice import _call, _post

N_SHARDS = 4
SW = 1 << 20
USERS = 8
LICENSES = 6
T0 = int(datetime(2019, 1, 1, tzinfo=timezone.utc).timestamp())
SPAN = 90 * 86400  # through 2019-03-31
WINDOWS = (("2019-02-04T00:00", "2019-02-11T00:00"),  # 7 day views
           ("2019-02-01T00:00", "2019-03-01T00:00"),  # 1 month view
           ("2019-01-15T00:00", "2019-03-10T00:00"),  # days, month, days
           ("2019-01-01T00:00", "2020-01-01T00:00"))  # 1 year view


def _data(seed: int = 31) -> dict:
    rng = np.random.default_rng(seed)
    users, repos, secs = [], [], []
    for u in range(USERS):
        n = 3000 // (u + 1)
        users.append(np.full(n, u))
        repos.append(rng.integers(0, N_SHARDS * SW, n))
        secs.append(T0 + rng.integers(0, SPAN, n))
    users, repos, secs = map(np.concatenate, (users, repos, secs))
    starred = np.unique(repos)
    lic = rng.integers(0, LICENSES, starred.size)
    moved = rng.choice(starred.size, starred.size // 10, replace=False)
    return {"users": users, "repos": repos, "secs": secs,
            "starred": starred, "license": lic, "moved": moved,
            "moved_to": rng.integers(0, LICENSES, moved.size),
            "fork": (rng.random(starred.size) < 0.2).astype(int)}


def _roaring(pos) -> str:
    b = Bitmap()
    b.add_many(np.asarray(pos, dtype=np.uint64))
    buf = io.BytesIO()
    b.write_to(buf)
    return base64.b64encode(buf.getvalue()).decode()


def _iso(s: int) -> str:
    return datetime.fromtimestamp(int(s), tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def _setup(d: dict) -> list:
    half = d["users"].size // 2
    out = [("/index/st", {"options": {"trackExistence": True}}),
           ("/index/st/field/stargazer",
            {"options": {"type": "time", "timeQuantum": "YMD"}}),
           ("/index/st/field/license", {"options": {"type": "mutex"}}),
           ("/index/st/field/fork", {"options": {"type": "bool"}}),
           ("/index/st/field/extra", {}),
           # epoch numbers, then ISO-8601 strings with and without Z
           ("/index/st/field/stargazer/import",
            {"rowIDs": d["users"][:half].tolist(),
             "columnIDs": d["repos"][:half].tolist(),
             "timestamps": d["secs"][:half].tolist()}),
           ("/index/st/field/stargazer/import",
            {"rowIDs": d["users"][half:].tolist(),
             "columnIDs": d["repos"][half:].tolist(),
             "timestamps": [_iso(s)[:-1] if i % 2 else _iso(s)
                            for i, s in enumerate(d["secs"][half:])]}),
           ("/index/st/field/license/import",
            {"rowIDs": d["license"].tolist(),
             "columnIDs": d["starred"].tolist()}),
           ("/index/st/field/license/import",
            {"rowIDs": d["moved_to"].tolist(),
             "columnIDs": d["starred"][d["moved"]].tolist()}),
           ("/index/st/field/fork/import",
            {"rowIDs": d["fork"].tolist(),
             "columnIDs": d["starred"].tolist()})]
    # one shard of extra through the roaring route: rows 0-2 in the
    # standard view, row 0 also in a day view
    rng = np.random.default_rng(5)
    std = np.unique(rng.integers(0, 3, 900) * SW + rng.integers(0, SW, 900))
    day = std[std < SW][:100]
    out.append(("/index/st/field/extra/import-roaring/2",
                {"views": {"": _roaring(std),
                           "standard_20190203": _roaring(day)}}))
    return out


def _range(u: int, w) -> str:
    return f"Range(stargazer={u}, {w[0]}, {w[1]})"


READS = (
    [f"Count({_range(u, w)})" for u in (0, 3, 7) for w in WINDOWS]
    + [_range(5, WINDOWS[2]),
       "Count(Intersect(Range(stargazer=0, 2019-01-01T00:00, "
       "2019-03-01T00:00), Row(license=3)))",
       "Count(Intersect(Range(stargazer=0, 2019-01-01T00:00, "
       "2019-03-01T00:00), Row(license=3), Row(fork=true)))",
       "Count(Row(fork=true))", "Count(Row(fork=false))", "Row(fork=1)",
       "Count(Union(Row(license=1), Row(license=2)))",
       "TopN(stargazer, n=5)", "TopN(license, n=3)", "TopN(fork)",
       f"TopN(license, {_range(0, WINDOWS[2])}, n=4)",
       "Rows(field=license)", "Rows(field=fork)", "Rows(field=stargazer)",
       "GroupBy(Rows(field=license), Rows(field=fork))",
       f"GroupBy(Rows(field=license), filter={_range(1, WINDOWS[1])})",
       "Options(Row(license=3), shards=[0, 2])",
       "Options(Row(license=3), excludeColumns=true)",
       "Options(Count(Row(license=3)), shards=[1])",
       "Row(extra=0)", "Count(Row(extra=2))",
       "Range(extra=0, 2019-02-01T00:00, 2019-03-01T00:00)",
       "Count(Not(Row(fork=true)))",
       "Count(Range(license=3, 2019-01-01T00:00, 2019-02-01T00:00))",
       "Count(Range(stargazer=2, 2019-03-01T00:00, 2019-03-01T00:00))"])

WRITES = [
    "Set(9, stargazer=1, 2019-02-05T10:00)",
    f"Count({_range(1, WINDOWS[0])})",
    "Set(10, license=2) Set(10, license=5)",
    "Row(license=2)", "Row(license=5)",
    "Set(11, fork=true) Set(11, fork=false)", "Row(fork=false)",
    "Clear(9, stargazer=1)", f"Count({_range(1, WINDOWS[0])})",
    "ClearRow(stargazer=7)", f"Count({_range(7, WINDOWS[3])})",
    "ClearRow(stargazer=7)",
    "Store(Intersect(Range(stargazer=0, 2019-01-01T00:00, "
    "2019-03-01T00:00), Row(license=3)), saved=1)",
    "Count(Row(saved=1))", "Row(saved=1)",
    "Store(Row(fork=true), license=4)", "Count(Row(license=4))",
    "ClearRow(fork=true)", "Count(Row(fork=true))",
]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jax_srv = JaxServer(str(tmp_path_factory.mktemp("jax")), port=0).open()
    port_srv = Server(str(tmp_path_factory.mktemp("port")), port=0,
                      device="cpu").open()
    try:
        for path, body in _setup(_data()):
            want = _post(jax_srv.uri, path, body)
            assert want[0] == 200, (path, want)
            assert _post(port_srv.uri, path, body) == want, path
        yield jax_srv, port_srv
    finally:
        port_srv.close()
        jax_srv.close()


def _same(servers, pql: str, path: str = "/index/st/query"):
    jax_srv, port_srv = servers
    want = _post(jax_srv.uri, path, pql)
    got = _post(port_srv.uri, path, pql)
    assert got == want, pql
    return got


@pytest.mark.parametrize("pql", READS)
def test_reads_match_the_jax_server(servers, pql):
    status, _ = _same(servers, pql)
    assert status == 200


def test_time_range_explain_matches(servers):
    for w in WINDOWS:
        pql = f"Count(Intersect({_range(2, w)}, Row(license=1)))"
        _same(servers, pql)  # resident after this
        status, doc = _same(servers, pql, "/index/st/query?explain=true")
        leaf = doc["explain"][0]["tree"]["children"]
        assert status == 200 and any(c["kind"] == "timerange" for c in leaf)


def test_schema_matches(servers):
    status, schema = _call(servers[1].uri, "GET", "/schema")
    assert (status, schema) == _call(servers[0].uri, "GET", "/schema")
    types = {f["name"]: (f["options"]["type"], f["options"]["timeQuantum"])
             for f in schema["indexes"][0]["fields"]}
    assert types["stargazer"] == ("time", "YMD")
    assert types["license"][0] == "mutex" and types["fork"][0] == "bool"


@pytest.mark.parametrize("pql", [
    "Set(1, fork=2)", "Set(1, license=1, 2019-01-01T00:00)",
    "Range(stargazer=1, 2019-01-01T00:00)", "Options(Row(fork=1), Row(fork=0))",
    "Set(1, nope=1)", "ClearRow(nope=1)"])
def test_error_texts_match(servers, pql):
    status, _ = _same(servers, pql)
    assert status == 400


@pytest.mark.parametrize("body", [
    {"options": {"type": "time", "timeQuantum": "YX"}},
    {"options": {"type": "time"}},
    {"options": {"type": "boolean"}}])
def test_field_errors_match(servers, body):
    jax_srv, port_srv = servers
    want = _post(jax_srv.uri, "/index/st/field/bad", body)
    assert want[0] == 400
    assert _post(port_srv.uri, "/index/st/field/bad", body) == want


def test_import_timestamp_errors_match(servers):
    for ts in (["not-a-time"], [True], [{"a": 1}]):
        jax_srv, port_srv = servers
        body = {"rowIDs": [1], "columnIDs": [7], "timestamps": ts}
        want = _post(jax_srv.uri, "/index/st/field/stargazer/import", body)
        assert want[0] == 400
        assert _post(port_srv.uri, "/index/st/field/stargazer/import",
                     body) == want


def test_writes_and_the_reads_they_change(servers):
    for pql in WRITES:
        status, _ = _same(servers, pql)
        assert status == 200, pql
    # a timestamped import (epoch 0 and None: no timestamp) and an
    # import-roaring clear, then their reads
    for path, body in (
            ("/index/st/field/stargazer/import",
             {"rowIDs": [6, 6, 6], "columnIDs": [40, 41, 42],
              "timestamps": [T0 + 86400 * 40, 0, None]}),
            # strings and numbers in one list (the per-item path)
            ("/index/st/field/stargazer/import",
             {"rowIDs": [6, 6, 6, 6], "columnIDs": [43, 44, 45, 46],
              "timestamps": ["2019-02-10T00:00", T0 + 86400 * 41.5, None,
                             "1970-01-01T00:00:00Z"]}),
            ("/index/st/field/extra/import-roaring/2?clear=true",
             {"views": {"standard_20190203": _roaring(
                 np.arange(0, SW, 7))}})):
        want = _post(servers[0].uri, path, body)
        assert want[0] == 200
        assert _post(servers[1].uri, path, body) == want
    for pql in ("Range(stargazer=6, 2019-02-01T00:00, 2019-03-01T00:00)",
                "Row(stargazer=6)",
                "Count(Range(extra=0, 2019-02-01T00:00, 2019-03-01T00:00))"):
        _same(servers, pql)
    for pql in READS:
        _same(servers, pql)


def _plan_cache(srv) -> dict:
    status, doc = _call(srv.uri, "GET", "/debug/vars")
    assert status == 200
    return doc["planCache"]


def test_plan_cache_keeps_a_time_range_until_a_covered_write(servers):
    pql = ("Count(Intersect(Range(stargazer=4, 2019-02-04T00:00, "
           "2019-02-11T00:00), Row(fork=false)))")
    before = [_plan_cache(s)["hits"] for s in servers]
    _same(servers, pql)
    n = _same(servers, pql)[1]["results"][0]
    after = [_plan_cache(s)["hits"] for s in servers]
    assert after[0] - before[0] == after[1] - before[1] >= 1
    # a write into a covered day view changes the key
    col = 3 * SW + 12345
    _same(servers, f"Set({col}, stargazer=4, 2019-02-06T00:00) "
                   f"Set({col}, fork=false)")
    got = _same(servers, pql)[1]["results"][0]
    assert got == n + 1


@pytest.mark.parametrize("ingest", ["1", "0"])
def test_typed_envelopes_with_ingest_on_and_off(tmp_path, monkeypatch,
                                                ingest):
    """Mutex, bool and timestamped Set/Clear envelopes take the per-bit
    path whether ingest is on or off, and answer as the JAX server."""
    monkeypatch.setenv("PILOSA_TPU_TORCH_INGEST", ingest)
    jax_srv = JaxServer(str(tmp_path / "jax"), port=0).open()
    port_srv = Server(str(tmp_path / "port"), port=0, device="cpu").open()
    try:
        pair = (jax_srv, port_srv)
        for path, body in _setup(_data(7))[:5]:
            for srv in pair:
                assert _post(srv.uri, path, body)[0] == 200
        rng = np.random.default_rng(3)
        for _ in range(4):
            calls = []
            for _ in range(40):
                c = int(rng.integers(0, N_SHARDS * SW))
                kind = int(rng.integers(4))
                if kind == 0:
                    calls.append(f"Set({c}, license={int(rng.integers(4))})")
                elif kind == 1:
                    calls.append(f"Set({c}, fork={bool(rng.random() < .5)})"
                                 .replace("True", "true")
                                 .replace("False", "false"))
                elif kind == 2:
                    day = int(rng.integers(1, 28))
                    calls.append(f"Set({c}, stargazer={int(rng.integers(3))}"
                                 f", 2019-02-{day:02d}T00:00)")
                else:
                    calls.append(f"Clear({c}, license=1)")
            _same(pair, " ".join(calls))
            for pql in ("Rows(field=license)", "Count(Row(license=1))",
                        "GroupBy(Rows(field=license), Rows(field=fork))",
                        f"Count({_range(1, WINDOWS[1])})",
                        f"Count({_range(2, WINDOWS[2])})"):
                _same(pair, pql)
        assert port_srv.executor.ingest_snapshot()["mutations"] == 0
    finally:
        port_srv.close()
        jax_srv.close()
