"""String keys, row and column attributes, the last public routes and
protobuf bodies end to end, against the JAX server.

Both servers run in-process with their defaults (planner, plan cache and
ingest on; the port on the CPU, through its kernels' plain versions)
over the same seeded Star Trace-shaped data at 4 shards: a keyed index of
repository names whose keyed set field `language` holds 16 language names
(a Zipf share), an unkeyed set field `license`, a keyed time field
`stargazer` of user logins, a bool field `fork` and an int field
`followers`; beside it an unkeyed index with a keyed field. Imports go
over /import with rowKeys and columnKeys (one as a protobuf
ImportRequest, one as an ImportValueRequest), attributes through
SetRowAttrs and SetColumnAttrs. Every comparison is of HTTP status and
JSON at tolerance 0, on 100+ seeded reads (Row, Count, TopN with Src,
ids and the attribute filter, Rows with a previous key, GroupBy, Sum,
Min/Max, time Range, columnAttrs, the exclude flags, unknown keys), the
writes and the reads they change, the routes (GET /index[/{i}], /export,
/info, /version, DELETE of a field, /recalculate-caches), the error texts
and the protobuf /query and /import bodies; the translate logs the two
servers write are byte-identical, a read mints no key, and the JAX server
reopening the port's data dir answers the same.
"""

import http.client
import os
from datetime import datetime, timezone
from urllib.parse import urlparse

import numpy as np
import pytest

from pilosa_tpu.encoding.protobuf import Serializer as JaxSerializer
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.encoding.protobuf import CONTENT_TYPE, Serializer
from pilosa_tpu_torch.server import Server

from tests.test_torch_obs_slice import _call, _post

N_SHARDS = 4
SW = 1 << 20
LANGS = ["Go", "Rust", "Python", "C", "Java", "Haskell", "OCaml", "Lisp",
         "Erlang", "Elixir", "Ruby", "Perl", "Scala", "Kotlin", "Swift",
         "Zig"]
N_LANGS = 15  # Zig is left out of the data: an unknown key
USERS = [f"user{u}" for u in range(6)]
T0 = int(datetime(2019, 1, 1, tzinfo=timezone.utc).timestamp())
WINDOW = ("2019-02-04T00:00", "2019-02-11T00:00")
ATTRS = {"Go": ("imperative", 2009, True), "Rust": ("imperative", 2010, True),
         "Haskell": ("functional", 1990, True),
         "OCaml": ("functional", 1996, True),
         "Lisp": ("functional", 1958, False),
         "Erlang": ("functional", 1986, False),
         "Python": ("imperative", 1991, False)}


def _data(seed: int = 41) -> dict:
    rng = np.random.default_rng(seed)
    n = 6000
    cols = np.unique(rng.integers(0, N_SHARDS * SW, n))
    rng.shuffle(cols)
    share = 1.0 / (np.arange(N_LANGS) + 1)
    lang = rng.choice(N_LANGS, cols.size, p=share / share.sum())
    users = rng.integers(0, len(USERS), cols.size)
    return {"repos": [f"repo{c}" for c in cols], "lang": lang.tolist(),
            "license": rng.integers(0, 5, cols.size).tolist(),
            "fork": (rng.random(cols.size) < 0.2).astype(int).tolist(),
            "followers": rng.integers(0, 1000, cols.size).tolist(),
            "users": users.tolist(),
            "secs": (T0 + rng.integers(0, 90 * 86400, cols.size)).tolist()}


def _proto_post(uri: str, path: str, body: bytes, accept: bool = False):
    u = urlparse(uri)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    headers = {"Content-Type": CONTENT_TYPE}
    if accept:
        headers["Accept"] = CONTENT_TYPE
    try:
        conn.request("POST", path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _get_raw(uri: str, path: str):
    u = urlparse(uri)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _setup(d: dict) -> list:
    names = [LANGS[i] for i in d["lang"]]
    half = len(names) // 2
    out = [("/index/ks", {"options": {"keys": True,
                                      "trackExistence": True}}),
           ("/index/ks/field/language",
            {"options": {"keys": True, "cacheType": "ranked",
                         "cacheSize": 100}}),
           ("/index/ks/field/license", {}),
           ("/index/ks/field/stargazer",
            {"options": {"type": "time", "timeQuantum": "YMD",
                         "keys": True}}),
           ("/index/ks/field/fork", {"options": {"type": "bool"}}),
           ("/index/ks/field/followers",
            {"options": {"type": "int", "min": 0, "max": 1000}}),
           ("/index/ks/field/language/import",
            {"rowKeys": names[:half], "columnKeys": d["repos"][:half]}),
           ("/index/ks/field/license/import",
            {"rowIDs": d["license"], "columnKeys": d["repos"]}),
           ("/index/ks/field/stargazer/import",
            {"rowKeys": [USERS[u] for u in d["users"]],
             "columnKeys": d["repos"], "timestamps": d["secs"]}),
           ("/index/ks/field/fork/import",
            {"rowIDs": d["fork"], "columnKeys": d["repos"]}),
           # an unkeyed index with a keyed field
           ("/index/ku", {"options": {"trackExistence": True}}),
           ("/index/ku/field/tag", {"options": {"keys": True}}),
           ("/index/ku/field/plain", {}),
           ("/index/ku/field/tag/import",
            {"rowKeys": ["red", "green", "red", "blue", "red"],
             "columnIDs": [1, 2, 3, SW + 4, 3 * SW + 5]}),
           ("/index/ku/field/plain/import",
            {"rowIDs": [1, 1, 2], "columnIDs": [1, 3, SW + 4]})]
    return out


def _attr_writes(d: dict) -> list:
    """One request of SetRowAttrs calls, then one of SetColumnAttrs."""
    return [" ".join('SetRowAttrs(language, "%s", paradigm="%s", year=%d, '
                     'typed=%s)' % (k, p, y, "true" if t else "false")
                     for k, (p, y, t) in ATTRS.items()),
            " ".join(f'SetColumnAttrs("{r}", stars={i % 97}, '
                     f'owner="u{i % 7}")'
                     for i, r in enumerate(d["repos"][:40]))]


def _reads() -> list:
    out = []
    for k in LANGS:
        out += [f'Count(Row(language="{k}"))', f'Row(language="{k}")',
                f'Count(Intersect(Row(language="{k}"), Row(license=2)))']
    out += [f'Sum(Row(language="{k}"), field=followers)' for k in LANGS[:6]]
    out += ["TopN(language, n=5)", "TopN(language)",
            "TopN(language, Row(license=1), n=5)",
            "TopN(language, Row(fork=true), n=3)",
            'TopN(language, n=10, attrName="paradigm", '
            'attrValues=["functional"])',
            'TopN(language, n=10, attrName="typed", attrValues=[true])',
            'TopN(language, n=10, attrName="paradigm")',
            'TopN(language, Row(license=3), n=4, attrName="paradigm", '
            'attrValues=["imperative"])',
            "TopN(language, ids=[1, 2, 3, 9])",
            'TopN(language, ids=[1, 2, 6], attrName="paradigm", '
            'attrValues=["functional", "imperative"])',
            "TopN(stargazer, n=3)", "TopN(license, n=3)",
            "Rows(field=language)", "Rows(field=language, limit=4)",
            'Rows(field=language, previous="Go", limit=5)',
            'Rows(field=language, previous="Python")',
            "Rows(field=stargazer)", "Rows(field=license)",
            "GroupBy(Rows(field=language))",
            "GroupBy(Rows(field=language), Rows(field=license))",
            "GroupBy(Rows(field=language), Rows(field=fork), limit=7)",
            "GroupBy(Rows(field=license), Rows(field=stargazer))",
            'GroupBy(Rows(field=language), filter=Row(license=4))',
            "Count(Range(followers > 500))", "Range(followers < 3)",
            'Min(Row(language="Go"), field=followers)',
            'Max(Row(language="Rust"), field=followers)',
            f'Count(Range(stargazer="user1", {WINDOW[0]}, {WINDOW[1]}))',
            f'Count(Intersect(Row(language="Go"), Range(stargazer="user0", '
            f'2019-01-01T00:00, 2019-04-01T00:00)))',
            f'Range(stargazer="user2", {WINDOW[0]}, {WINDOW[1]})',
            'Count(Row(language="Zig"))', 'Row(language="Zig")',
            'Count(Union(Row(language="Zig"), Row(language="Go")))',
            'Count(Difference(Row(language="Go"), Row(language="Zig")))',
            'Count(Not(Row(language="Go")))',
            'Options(Row(language="Go"), excludeRowAttrs=true)',
            'Options(Row(language="Haskell"), excludeColumns=true)',
            'Options(TopN(language, n=3), shards=[0, 2])',
            'Options(Rows(field=language), shards=[1])',
            'Options(Count(Row(language="Go")), shards=[3])',
            'Row(fork=true)',
            f'Row(license=1)',
            f'Count(Intersect(Row(language="C"), Row(fork=false)))',
            "Row(tag=red)"]
    out += [f'Row(stargazer="{u}")' for u in USERS[:2]]
    return out


READS = _reads()
assert len(READS) >= 100


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax"))
    pdir = str(tmp_path_factory.mktemp("port"))
    jax_srv = JaxServer(jdir, port=0).open()
    port_srv = Server(pdir, port=0, device="cpu").open()
    try:
        d = _data()
        for path, body in _setup(d):
            if path.startswith("/index/ku"):
                continue
            want = _post(jax_srv.uri, path, body)
            assert want[0] == 200, (path, want)
            assert _post(port_srv.uri, path, body) == want, path
        # the second half of language as a protobuf ImportRequest, the
        # followers as an ImportValueRequest, sent to both servers
        names = [LANGS[i] for i in d["lang"]]
        half = len(names) // 2
        ser = Serializer()
        for path, body in (
                ("/index/ks/field/language/import",
                 ser.encode_import_request(
                     "ks", "language", row_keys=names[half:],
                     column_keys=d["repos"][half:])),
                ("/index/ks/field/followers/import",
                 ser.encode_import_value_request(
                     "ks", "followers", column_keys=d["repos"],
                     values=d["followers"]))):
            want = _proto_post(jax_srv.uri, path, body)
            assert want[0] == 200, want
            assert _proto_post(port_srv.uri, path, body) == want
        for path, body in _setup(d):
            if path.startswith("/index/ku"):
                want = _post(jax_srv.uri, path, body)
                assert want[0] == 200, (path, want)
                assert _post(port_srv.uri, path, body) == want, path
        for pql in _attr_writes(d):
            want = _post(jax_srv.uri, "/index/ks/query", pql)
            assert want[0] == 200, want
            assert _post(port_srv.uri, "/index/ks/query", pql) == want
        yield jax_srv, port_srv, jdir, pdir
    finally:
        port_srv.close()
        jax_srv.close()


def _same(servers, pql: str, path: str = "/index/ks/query"):
    want = _post(servers[0].uri, path, pql)
    got = _post(servers[1].uri, path, pql)
    assert got == want, pql
    return got


def _logs_equal(servers) -> bytes:
    with open(os.path.join(servers[2], ".keys"), "rb") as f:
        want = f.read()
    with open(os.path.join(servers[3], ".keys"), "rb") as f:
        assert f.read() == want
    return want


@pytest.mark.parametrize("pql", READS)
def test_keyed_reads_match_the_jax_server(servers, pql):
    path = "/index/ku/query" if "tag=" in pql else "/index/ks/query"
    status, _ = _same(servers, pql, path)
    assert status == 200


def test_reads_mint_no_key(servers):
    before = _logs_equal(servers)
    for pql in ('Count(Row(language="Zig"))', 'Row(language="nosuch")',
                'Clear("nope", language="Go")',
                'Clear("repo-none", language="nosuch")',
                'ClearRow(language="nosuch")',
                'Count(Intersect(Row(language="Zig"), Row(license=1)))'):
        status, _ = _same(servers, pql)
        assert status == 200, pql
    for srv in servers[:2]:
        assert srv.translate.log_size() == len(before)
    assert _logs_equal(servers) == before
    status, doc = _same(servers, 'Count(Row(language="Zig"))',
                        "/index/ks/query?explain=true")
    assert status == 200


def test_column_attrs_and_exclude_flags(servers):
    d = _data()
    row = 'Row(language="Haskell")'
    for q in ("?columnAttrs=true", "?excludeRowAttrs=true",
              "?excludeColumns=true", "?columnAttrs=true&excludeColumns=true"):
        status, doc = _same(servers, row, "/index/ks/query" + q)
        assert status == 200
    status, doc = _same(servers, 'Row(language="Go")',
                        "/index/ks/query?columnAttrs=true")
    assert doc["results"][0]["attrs"]["paradigm"] == "imperative"
    sets = doc["columnAttrSets"]
    assert sets and all("key" in s for s in sets)
    assert {s["key"] for s in sets} <= set(d["repos"][:40])
    # an unkeyed index: no key in the sets
    _same(servers, "SetColumnAttrs(3, city=\"ankh\")", "/index/ku/query")
    status, doc = _same(servers, "Row(tag=red)",
                        "/index/ku/query?columnAttrs=true")
    assert doc["columnAttrSets"] == [{"id": 3, "attrs": {"city": "ankh"}}]


def test_attr_merges_match(servers):
    for pql in ('SetRowAttrs(language, "Go", year=null, mascot="gopher")',
                'Row(language="Go")',
                'SetColumnAttrs("repo-new", x=1) SetColumnAttrs("repo-new", '
                'y=2.5, x=null)',
                'SetRowAttrs(language, "Brainfuck", esoteric=true)',
                'TopN(language, n=20, attrName="esoteric", '
                'attrValues=[true])'):
        status, _ = _same(servers, pql)
        assert status == 200, pql
    _logs_equal(servers)


KEYED_WRITES = [
    'Set("repo-a", language="Zig")', 'Count(Row(language="Zig"))',
    'Row(language="Zig")', 'TopN(language, n=20)',
    'Set("repo-a", language="Go") Set("repo-b", language="Zig") '
    'Clear("repo-a", language="Zig")',
    'Row(language="Zig")', 'Count(Row(language="Go"))',
    'Set("repo-c", followers=77)', 'Sum(Row(language="Zig"), field=followers)',
    'Set("repo-b", stargazer="user9", 2019-02-05T10:00)',
    f'Count(Range(stargazer="user9", {WINDOW[0]}, {WINDOW[1]}))',
    'Store(Row(language="Zig"), language="Zig2")', 'Row(language="Zig2")',
    'ClearRow(language="Zig2")', 'Row(language="Zig2")',
    'Rows(field=language)', 'GroupBy(Rows(field=language))',
    'Set("repo-b", fork=true)', 'Count(Row(fork=true))',
    'Clear("repo-b", followers=0)', 'Sum(field=followers)',
]


def test_keyed_writes_and_the_reads_they_change(servers):
    for pql in KEYED_WRITES:
        status, _ = _same(servers, pql)
        assert status == 200, pql
    _logs_equal(servers)


def test_plan_cache_drops_the_empty_answer_of_a_new_key(servers):
    q = 'Count(Intersect(Row(language="Brand-new"), Row(license=1)))'
    for pql in (q, q, 'Set("repo-z", language="Brand-new") '
                'Set("repo-z", license=1)', q):
        _same(servers, pql)
    assert _post(servers[1].uri, "/index/ks/query", q)[1]["results"] == [1]


def test_keyed_rows_paging_errors_match(servers):
    for pql in ('Rows(field=language, previous="nosuch")',
                'Rows(field=fork, previous="x")'):
        status, _ = _same(servers, pql)
        assert status == 400, pql


def test_routes_match(servers):
    jax_srv, port_srv = servers[:2]
    for path in ("/index", "/index/ks", "/index/ku", "/index/none",
                 "/version", "/schema"):
        assert _call(port_srv.uri, "GET", path) == \
            _call(jax_srv.uri, "GET", path), path
    want, got = (_call(s.uri, "GET", "/info") for s in (jax_srv, port_srv))
    assert want[0] == got[0] == 200
    for doc in (want[1], got[1]):
        doc.pop("cpuPhysicalCores")
    assert got == want
    for shard in range(N_SHARDS):
        for field in ("language", "stargazer", "license"):
            path = f"/export?index=ks&field={field}&shard={shard}"
            want = _get_raw(jax_srv.uri, path)
            assert want[0] == 200 and want[1] == "text/csv"
            assert _get_raw(port_srv.uri, path) == want, path
    for path in ("/export?index=ks&field=language",
                 "/export?index=ks&field=nope&shard=0",
                 "/export?index=ks&field=language&shard=0&x=1"):
        assert _get_raw(port_srv.uri, path)[0] == \
            _get_raw(jax_srv.uri, path)[0] == (
                404 if "nope" in path else 400), path
    assert _post(port_srv.uri, "/recalculate-caches", b"") == \
        _post(jax_srv.uri, "/recalculate-caches", b"")
    _same(servers, "TopN(language, n=6)")


def test_delete_field_matches(servers):
    jax_srv, port_srv = servers[:2]
    for path, body in (("/index/ku/field/gone", {}),
                       ("/index/ku/field/gone/import",
                        {"rowKeys": ["a", "b"], "columnIDs": [1, 2]})):
        assert _post(port_srv.uri, path, body) == \
            _post(jax_srv.uri, path, body)
    _same(servers, 'Count(Row(gone="a"))', "/index/ku/query")
    for path in ("/index/ku/field/gone", "/index/ku/field/gone",
                 "/index/none/field/gone"):
        assert _call(port_srv.uri, "DELETE", path) == \
            _call(jax_srv.uri, "DELETE", path), path
    _same(servers, 'Count(Row(gone="a"))', "/index/ku/query")
    assert _call(port_srv.uri, "GET", "/schema") == \
        _call(jax_srv.uri, "GET", "/schema")
    # a recreated field of the same name starts empty in both
    assert _post(port_srv.uri, "/index/ku/field/gone", {}) == \
        _post(jax_srv.uri, "/index/ku/field/gone", {})
    _same(servers, 'Count(Row(gone="a"))', "/index/ku/query")


@pytest.mark.parametrize("pql", [
    'Set("x", nope="a")', "Set(1, language=\"a\")",
    'SetRowAttrs(nope, "a", x=1)', 'TopN(nope, n=1)',
    'Row(language="a", "b")'])
def test_error_texts_match(servers, pql):
    path = "/index/ku/query" if pql.startswith("Set(1") else \
        "/index/ks/query"
    status, _ = _same(servers, pql, path)
    assert status == 400


def test_protobuf_query_responses_decode_the_same(servers):
    jax_srv, port_srv = servers[:2]
    jser, pser = JaxSerializer(), Serializer()
    for pql, kw in (('Row(language="Go") Count(Row(language="Rust"))', {}),
                    ('TopN(language, n=4) Rows(field=language)', {}),
                    ('GroupBy(Rows(field=language), Rows(field=fork))', {}),
                    ('Sum(Row(language="C"), field=followers) '
                     'Min(field=followers)', {}),
                    ('Row(language="Haskell")', {"column_attrs": True}),
                    ('Set("repo-p", language="Go") '
                     'Clear("repo-p", language="Go")', {}),
                    ('Row(tag=red) Rows(field=tag)', {"column_attrs": True}),
                    ('Row(tag=plain)', {"column_attrs": True})):
        path = "/index/ku/query" if "tag" in pql else "/index/ks/query"
        body = pser.encode_query_request(pql, **kw)
        want = _proto_post(jax_srv.uri, path, body, accept=True)
        got = _proto_post(port_srv.uri, path, body, accept=True)
        assert want[:2] == got[:2] == (200, CONTENT_TYPE), pql
        w = jser.decode_query_response(want[2])
        g = pser.decode_query_response(got[2])
        assert g["err"] == w["err"] == ""
        assert g["columnAttrSets"] == w["columnAttrSets"], pql
        assert len(g["results"]) == len(w["results"])
        for a, b in zip(g["results"], w["results"]):
            assert _plain(a) == _plain(b), pql
        # and each side's bytes decode under the other's codec
        assert _plain_resp(pser.decode_query_response(want[2])) == \
            _plain_resp(w)
    # a body that is no QueryRequest: the JAX server's parser raises a
    # 500, the port's codec a 400 that names the message
    bad = b"\xff\xff"
    assert _proto_post(jax_srv.uri, "/index/ks/query", bad)[0] == 500
    got = _proto_post(port_srv.uri, "/index/ks/query", bad)
    assert got[0] == 400 and b"invalid QueryRequest" in got[2]


def _plain(r):
    """A decoded result as plain data, whichever package decoded it."""
    name = type(r).__name__
    if name == "Row":
        return ("Row", r.columns().tolist(), dict(r.attrs), list(r.keys))
    if name == "Pairs":
        return ("Pairs", [tuple(map(int, p)) for p in r],
                getattr(r, "row_keys", None))
    if name == "RowIdentifiers":
        return ("Rows", [int(x) for x in r], getattr(r, "row_keys", None))
    if name == "ValCount":
        return ("ValCount", r.val, r.count)
    if name == "GroupCounts":
        return ("Groups", list(r))
    return r


def _plain_resp(resp: dict):
    return ([_plain(r) for r in resp["results"]], resp["columnAttrSets"],
            resp["err"])


def test_z_jax_server_reopens_the_port_data_dir(servers, tmp_path):
    """Last in the file: closes the port server and opens a JAX server on
    its data dir (translate log, sqlite index, attribute stores)."""
    jax_srv, port_srv, _, pdir = servers
    reads = READS[::3] + ['Row(language="Go")', "TopN(language, n=20)",
                          'TopN(language, n=10, attrName="paradigm", '
                          'attrValues=["functional"])']
    want = {q: _post(port_srv.uri, "/index/ks/query", q) for q in reads}
    cas = _post(port_srv.uri, "/index/ks/query?columnAttrs=true",
                'Row(language="Haskell")')
    port_srv.close()
    reopened = JaxServer(pdir, port=0).open()
    try:
        for q in reads:
            assert _post(reopened.uri, "/index/ks/query", q) == want[q], q
        assert _post(reopened.uri, "/index/ks/query?columnAttrs=true",
                     'Row(language="Haskell")') == cas
        # the JAX server goes on minting after the port's last id
        _post(reopened.uri, "/index/ks/query", 'Set("repo-late", '
              'language="Late")')
        assert _post(reopened.uri, "/index/ks/query",
                     'Rows(field=language, previous="Go")')[0] == 200
    finally:
        reopened.close()
