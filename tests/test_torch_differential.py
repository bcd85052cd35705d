"""Standing cross-slice differential test: the port's server against the
JAX server.

Both servers run in-process on the CPU over 4 shards with the same seeded
data: a set field f with dense, sparse and runny rows (runny rows stay far
above 4096 bits per shard), a ranked set field t of Zipf-like rows, and an
int field v; and a second index of typed fields, a time field tm
(quantum YMD), a mutex field mx and a bool field bo. Seeded rounds mix
reads of every served slice (dense, sparse and run
Count/Row/Intersect/Union/Difference/Not; Range, Sum, Min, Max; TopN with
a Src and with a Tanimoto threshold; Rows; GroupBy; time Range windows,
mutex and bool rows, Options) with Set/Clear envelopes between the
rounds, which the port applies through its coalesced write path, and
timestamped, mutex and bool Sets, ClearRow and Store on the typed index,
which take the per-bit path; and a keyed index (string column keys, a
keyed set field with row attributes and an unkeyed one) read through
keyed Count/Row/TopN/Rows/GroupBy and written by keyed Set/Clear
envelopes, which go through the coalesced write path too. Every answer
must be the same JSON, and both servers write the same translate log.
The same rounds run on a two-node cluster of each package (ids "a" and
"b", one replica: every query fans out, every write is routed to its
shard's owner, keys are minted by node "a"), the queries and writes
alternating between the nodes.
"""

import http.client
import json
from urllib.parse import urlparse

import numpy as np
import pytest

from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server

SW = 1 << 20
N_SHARDS = 4
F_FORMS = ["dense", "dense", "sparse", "sparse", "run"]  # f rows 0-4
T_ROWS = 6
TM_ROWS, MX_ROWS = 4, 4  # the typed index: users of tm, licenses of mx
TM_T0 = 1546300800  # 2019-01-01T00:00:00Z


def _post(uri: str, path: str, body) -> tuple:
    if not isinstance(body, str):
        body = json.dumps(body)
    u = urlparse(uri)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request("POST", path, body=body.encode())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _setup(seed: int) -> list:
    """(path, body) of the schema and imports."""
    rng = np.random.default_rng(seed)
    out = [("/index/d", {"options": {"trackExistence": True}}),
           ("/index/d/field/f", {}), ("/index/d/field/t", {}),
           ("/index/d/field/v", {"options": {"type": "int", "min": -50,
                                             "max": 1000}})]
    for r, form in enumerate(F_FORMS):
        cols = []
        for s in range(N_SHARDS):
            if form == "dense":
                c = rng.choice(SW, size=12000, replace=False)
            elif form == "sparse":
                c = rng.choice(SW, size=int(rng.integers(20, 300)),
                               replace=False)
            else:
                a = int(rng.integers(0, 60)) * 8192
                c = np.concatenate([np.arange(a, a + 6000),
                                    np.arange(a + 400000, a + 406000)])
            cols.append(c + s * SW)
        cols = np.concatenate(cols)
        out.append(("/index/d/field/f/import",
                    {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()}))
    for r in range(T_ROWS):
        cols = np.concatenate([
            s * SW + rng.choice(SW, size=3000 // (r + 1), replace=False)
            for s in range(N_SHARDS)])
        out.append(("/index/d/field/t/import",
                    {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()}))
    vcols = rng.choice(N_SHARDS * SW, size=2000 * N_SHARDS, replace=False)
    out.append(("/index/d/field/v/import",
                {"columnIDs": vcols.tolist(),
                 "values": rng.integers(-50, 1001, size=vcols.size).tolist()}))
    # the typed index: stars of 4 users over 60 days, a mutex license of
    # 4 rows on the starred columns (imported twice: the last write wins),
    # a bool fork flag
    out += [("/index/ty", {"options": {"trackExistence": True}}),
            ("/index/ty/field/tm",
             {"options": {"type": "time", "timeQuantum": "YMD"}}),
            ("/index/ty/field/mx", {"options": {"type": "mutex"}}),
            ("/index/ty/field/bo", {"options": {"type": "bool"}})]
    n = 3000
    cols = rng.integers(0, N_SHARDS * SW, n)
    out.append(("/index/ty/field/tm/import", {
        "rowIDs": rng.integers(0, TM_ROWS, n).tolist(),
        "columnIDs": cols.tolist(),
        "timestamps": (TM_T0 + rng.integers(0, 60 * 86400, n)).tolist()}))
    for _ in range(2):
        out.append(("/index/ty/field/mx/import",
                    {"rowIDs": rng.integers(0, MX_ROWS, n).tolist(),
                     "columnIDs": cols.tolist()}))
    out.append(("/index/ty/field/bo/import",
                {"rowIDs": (rng.random(n) < 0.3).astype(int).tolist(),
                 "columnIDs": cols.tolist()}))
    return out


KX_ROWS = ["alpha", "beta", "gamma", "delta", "eps"]


def _keyed_setup(seed: int) -> list:
    """A keyed index kx: column keys, a keyed field lk (row attributes on
    two rows) and an unkeyed field lu."""
    rng = np.random.default_rng(seed + 300)
    n = 2500
    cols = [f"c{int(c)}" for c in rng.integers(0, 4000, n)]
    return [("/index/kx", {"options": {"keys": True,
                                       "trackExistence": True}}),
            ("/index/kx/field/lk", {"options": {"keys": True}}),
            ("/index/kx/field/lu", {}),
            ("/index/kx/field/lk/import",
             {"rowKeys": [KX_ROWS[i] for i in
                          rng.integers(0, len(KX_ROWS) - 1, n)],
              "columnKeys": cols}),
            ("/index/kx/field/lu/import",
             {"rowIDs": rng.integers(0, 3, n).tolist(), "columnKeys": cols}),
            ("/index/kx/query",
             'SetRowAttrs(lk, "alpha", kind="a") '
             'SetRowAttrs(lk, "gamma", kind="a") '
             'SetRowAttrs(lk, "beta", kind="b")')]


def _keyed_reads(rng) -> list:
    k1, k2 = (KX_ROWS[int(i)] for i in rng.integers(0, len(KX_ROWS), 2))
    return [f'Count(Row(lk="{k1}"))', f'Row(lk="{k2}")',
            f'Count(Intersect(Row(lk="{k1}"), Row(lu=1)))',
            f'Count(Union(Row(lk="{k1}"), Row(lk="{k2}")))',
            "TopN(lk, n=3)", "TopN(lk, Row(lu=2), n=4)",
            'TopN(lk, attrName="kind", attrValues=["a"])',
            "Rows(field=lk)", f'Rows(field=lk, previous="{KX_ROWS[0]}")',
            "GroupBy(Rows(field=lk), Rows(field=lu))"]


def _keyed_envelope(rng) -> str:
    calls = []
    for _ in range(int(rng.integers(5, 40))):
        op = "Set" if rng.random() < 0.7 else "Clear"
        calls.append(f'{op}("c{int(rng.integers(0, 4100))}", '
                     f'lk="{KX_ROWS[int(rng.integers(len(KX_ROWS)))]}")')
    return " ".join(calls)


def _day(rng) -> str:
    return f"2019-0{int(rng.integers(1, 3))}-{int(rng.integers(1, 29)):02d}"


def _typed_reads(rng) -> list:
    """One round of seeded reads of the typed index."""
    u, lic = int(rng.integers(TM_ROWS)), int(rng.integers(MX_ROWS))
    a, b = sorted((_day(rng), _day(rng)))
    w = f"Range(tm={u}, {a}T00:00, {b}T00:00)"
    return [f"Count({w})", w, f"Count(Intersect({w}, Row(mx={lic})))",
            f"Count(Intersect({w}, Row(mx={lic}), Row(bo=true)))",
            f"Count(Range(tm={u}, 2019-01-01T00:00, 2020-01-01T00:00))",
            f"Count(Row(bo={'true' if rng.random() < .5 else 'false'}))",
            "Rows(field=mx)", "TopN(mx, n=2)", f"TopN(mx, {w}, n=3)",
            "GroupBy(Rows(field=mx), Rows(field=bo))",
            f"Options(Row(mx={lic}), shards=[1, 3])",
            f"Options(Count(Row(mx={lic})), shards=[0])"]


def _typed_writes(rng) -> str:
    calls = []
    for _ in range(int(rng.integers(5, 30))):
        c = int(rng.integers(N_SHARDS * SW))
        kind = int(rng.integers(5))
        if kind == 0:
            calls.append(f"Set({c}, tm={int(rng.integers(TM_ROWS))}, "
                         f"{_day(rng)}T{int(rng.integers(24)):02d}:00)")
        elif kind == 1:
            calls.append(f"Set({c}, mx={int(rng.integers(MX_ROWS))})")
        elif kind == 2:
            calls.append(f"Set({c}, bo={'true' if c % 2 else 'false'})")
        elif kind == 3:
            calls.append(f"Clear({c}, mx={int(rng.integers(MX_ROWS))})")
        else:
            calls.append(f"Clear({c}, tm={int(rng.integers(TM_ROWS))})")
    if rng.random() < 0.5:
        calls.append(f"ClearRow(mx={int(rng.integers(MX_ROWS))})")
    calls.append(f"Store(Intersect(Row(mx={int(rng.integers(MX_ROWS))}), "
                 f"Row(bo=true)), saved={int(rng.integers(2))})")
    return " ".join(calls)


def _reads(rng) -> list:
    """One round of seeded reads over every served slice."""
    def fr():
        return int(rng.integers(len(F_FORMS)))

    def tr():
        return int(rng.integers(T_ROWS))

    x = int(rng.integers(-60, 1010))
    y = x + int(rng.integers(0, 300))
    a, b, c = fr(), fr(), fr()
    return [
        f"Count(Row(f={a}))", f"Row(f={2 + a % 2})",
        f"Count(Intersect(Row(f={a}), Row(f={b})))",
        f"Count(Union(Row(f={a}), Row(f={b}), Row(t={tr()})))",
        f"Count(Difference(Row(f={a}), Row(f={b})))",
        f"Count(Xor(Row(f={b}), Row(f={c})))",
        f"Count(Not(Row(f={c})))",
        f"Count(Intersect(Row(f={a}), Row(f={b}), Row(f={c})))",
        f"Count(Range(v > {x}))", f"Count(Range(v >< [{x}, {y}]))",
        f"Count(Intersect(Row(f={a}), Range(v < {y})))",
        "Sum(field=v)", f"Sum(Row(f={a}), field=v)",
        f"Min(Row(f={b}), field=v)", "Max(field=v)",
        f"TopN(t, n={int(rng.integers(1, 5))})",
        f"TopN(t, Row(f={a}), n=3)",
        f"TopN(t, Row(f={b}), tanimotoThreshold={int(rng.integers(1, 40))})",
        "Rows(field=t, limit=4)",
        f"GroupBy(Rows(field=t), filter=Row(f={c}))",
    ]


def _envelope(rng) -> str:
    calls = []
    for _ in range(int(rng.integers(5, 60))):
        if rng.random() < 0.8:
            field, row = (("f", int(rng.integers(len(F_FORMS))))
                          if rng.random() < 0.6
                          else ("t", int(rng.integers(T_ROWS))))
            op = "Set" if rng.random() < 0.75 else "Clear"
            calls.append(f"{op}({int(rng.integers(N_SHARDS * SW))}, "
                         f"{field}={row})")
        else:
            # clears of imported bits hit real rows
            calls.append(f"Clear({int(rng.integers(4096))}, "
                         f"f={int(rng.integers(len(F_FORMS)))})")
    return " ".join(calls)


def _open(tmp_path, nodes: int) -> tuple:
    """(JAX servers, port servers): one each, or a cluster of `nodes` of
    each package with pinned ids."""
    if nodes == 1:
        return ([JaxServer(str(tmp_path / "jax"), port=0).open()],
                [Server(str(tmp_path / "torch"), port=0, device="cpu").open()])
    out = []
    for kind, make in (("jax", lambda d, i: JaxServer(
                            d, port=0, node_id=chr(97 + i)).open()),
                       ("torch", lambda d, i: Server(
                            d, port=0, device="cpu",
                            node_id=chr(97 + i)).open())):
        servers = [make(str(tmp_path / f"{kind}{i}"), i)
                   for i in range(nodes)]
        uris = [x.uri for x in servers]
        for x in servers:
            x.cluster_hosts = uris
            x.refresh_membership()
        out.append(servers)
    return tuple(out)


@pytest.mark.parametrize("seed", [3, 4])
def test_port_and_jax_servers_agree_across_slices(tmp_path, seed):
    _agree(tmp_path, seed, 1)


def test_two_node_clusters_agree_across_slices(tmp_path):
    _agree(tmp_path, 5, 2)


def _agree(tmp_path, seed: int, nodes: int) -> None:
    rng = np.random.default_rng(seed + 100)
    krng = np.random.default_rng(seed + 200)
    jax_servers, ports = _open(tmp_path, nodes)
    try:
        for path, body in _setup(seed) + _keyed_setup(seed):
            want = _post(jax_servers[0].uri, path, body)
            assert want[0] == 200, want
            assert _post(ports[0].uri, path, body) == want, path
        n = 0
        for rnd in range(3):
            queries = _reads(rng)
            if rnd == 2:
                queries.append("GroupBy(Rows(field=f), Rows(field=t), limit=7)")
            queries = ([("d", q) for q in queries]
                       + [("ty", q) for q in _typed_reads(rng)]
                       + [("kx", q) for q in _keyed_reads(krng)])
            for idx, q in queries:
                k = n % nodes
                want = _post(jax_servers[k].uri, f"/index/{idx}/query", q)
                assert want[0] == 200, (q, want)
                assert _post(ports[k].uri, f"/index/{idx}/query", q) == \
                    want, (rnd, q)
                n += 1
            for w, (idx, env) in enumerate((
                    ("d", _envelope(rng)), ("d", _envelope(rng)),
                    ("ty", _typed_writes(rng)),
                    ("kx", _keyed_envelope(krng)))):
                k = (rnd + w) % nodes
                want = _post(jax_servers[k].uri, f"/index/{idx}/query", env)
                assert want[0] == 200, want
                assert _post(ports[k].uri, f"/index/{idx}/query", env) == want
        assert n >= 90
        snaps = [p.executor.ingest_snapshot() for p in ports]
        assert sum(s["mutations"] for s in snaps) >= 30
        assert not any(s["errors"] for s in snaps)
        assert sum(s["patchedDense"] for s in snaps) >= 1
        with open(jax_servers[0].translate.path, "rb") as f:
            want = f.read()
        with open(ports[0].translate.path, "rb") as f:
            assert f.read() == want and want
    finally:
        for x in ports + jax_servers:
            x.close()
