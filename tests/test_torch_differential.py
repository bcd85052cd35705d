"""Standing cross-slice differential test: the port's server against the
JAX server.

Both servers run in-process on the CPU over 4 shards with the same seeded
data: a set field f with dense, sparse and runny rows (runny rows stay far
above 4096 bits per shard), a ranked set field t of Zipf-like rows, and an
int field v. Seeded rounds mix reads of every served slice (dense, sparse
and run Count/Row/Intersect/Union/Difference/Not; Range, Sum, Min, Max;
TopN with a Src and with a Tanimoto threshold; Rows; GroupBy) with
Set/Clear envelopes between the rounds, which the port applies through
its coalesced write path. Every answer must be the same JSON.
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
    return out


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


@pytest.mark.parametrize("seed", [3, 4])
def test_port_and_jax_servers_agree_across_slices(tmp_path, seed):
    rng = np.random.default_rng(seed + 100)
    jax_srv = JaxServer(str(tmp_path / "jax"), port=0).open()
    try:
        port = Server(str(tmp_path / "torch"), port=0, device="cpu").open()
        try:
            for path, body in _setup(seed):
                want = _post(jax_srv.uri, path, body)
                assert want[0] == 200, want
                assert _post(port.uri, path, body) == want, path
            n = 0
            for rnd in range(3):
                queries = _reads(rng)
                if rnd == 2:
                    queries.append("GroupBy(Rows(field=f), Rows(field=t), limit=7)")
                for q in queries:
                    want = _post(jax_srv.uri, "/index/d/query", q)
                    assert want[0] == 200, (q, want)
                    assert _post(port.uri, "/index/d/query", q) == want, \
                        (rnd, q)
                    n += 1
                for _ in range(2):
                    env = _envelope(rng)
                    want = _post(jax_srv.uri, "/index/d/query", env)
                    assert want[0] == 200, want
                    assert _post(port.uri, "/index/d/query", env) == want
            assert n >= 60
            snap = port.executor.ingest_snapshot()
            assert snap["mutations"] >= 30 and snap["errors"] == 0
            assert snap["patchedDense"] >= 1
        finally:
            port.close()
    finally:
        jax_srv.close()
