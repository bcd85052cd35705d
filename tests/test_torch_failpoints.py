"""The port's failpoints against the JAX package's.

The registry, the seeded chaos draws (every (seed, point, index) triple
gives the same kind and argument in both packages, so a printed seed
replays in either), the fired log, counters and snapshot of the same hit
sequence, arming from the environment in a subprocess, and the hooks of
the storage sites: a torn WAL append on a port fragment and on a JAX
fragment leaves byte-identical files and the same bits after a reopen,
WAL poisoning refuses with the JAX text, and a failed snapshot write or
replace leaves the old file as it was. The hooks of the other sites
(client, dispatch, fan-out, hints, scrub) are held here at unit level
and under load in tests/test_torch_chaos_slice.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pilosa_tpu.storage.fragment import Fragment as JaxFragment
from pilosa_tpu.utils import failpoints as jfp
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.utils import failpoints as fp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": (fp, Fragment), "jax": (jfp, JaxFragment)}


@pytest.fixture(autouse=True)
def _reset_port_failpoints():
    fp.reset()
    yield
    fp.reset()


# -- the framework ----------------------------------------------------------


def test_registry_equals_jax():
    assert list(fp.POINTS) == list(jfp.POINTS)
    assert {n: k for n, (k, _site) in fp.POINTS.items()} == \
        {n: k for n, (k, _site) in jfp.POINTS.items()}
    assert len(fp.POINTS) == 11
    assert (fp.RAISE, fp.DELAY, fp.TRUNCATE_WRITE, fp.PARTIAL_READ,
            fp.EXIT) == (jfp.RAISE, jfp.DELAY, jfp.TRUNCATE_WRITE,
                         jfp.PARTIAL_READ, jfp.EXIT)
    assert issubclass(fp.FailpointError, OSError)


@pytest.mark.parametrize("allow_exit", [False, True])
def test_chaos_draws_equal_jax(allow_exit):
    """5 seeds x 11 points x 200 evaluation indexes x 2 = 22,000 triples:
    the same None, or the same kind and argument."""
    fired = 0
    for seed in (0, 1, 20250804, 987654321, 2 ** 40 + 7):
        for rate in (0.08, 0.5):
            a = fp._Chaos(seed, rate, allow_exit=allow_exit)
            b = jfp._Chaos(seed, rate, allow_exit=allow_exit)
            for name in fp.POINTS:
                for idx in range(1, 101):
                    x, y = a.draw(name, idx), b.draw(name, idx)
                    assert (x is None) == (y is None), (seed, name, idx)
                    if x is not None:
                        fired += 1
                        assert (x.kind, x.arg) == (y.kind, y.arg)
    assert fired > 1000


def test_chaos_point_subset_equals_jax():
    pts = {"storage.wal.append", "net.client.read"}
    a = fp._Chaos(7, 0.9, points=pts)
    b = jfp._Chaos(7, 0.9, points=pts)
    for name in fp.POINTS:
        for idx in range(1, 50):
            x, y = a.draw(name, idx), b.draw(name, idx)
            assert (None if x is None else (x.kind, x.arg)) == \
                (None if y is None else (y.kind, y.arg))
            if name not in pts:
                assert x is None


def _drive(mod, steps: int = 300) -> tuple:
    """A fixed hit sequence under chaos and two explicit actions; the
    outcome of each hit, then the fired log, counters and snapshot."""
    mod.reset()
    mod.arm_chaos(424242, rate=0.3,
                  points={"executor.fanout", "storage.hints.append",
                          "net.client.read", "storage.wal.append"})
    mod.configure("storage.fragment.open", "raise", times=3)
    mod.configure("net.client.send", "raise", prob=0.5, seed=9)
    names = list(mod.POINTS)
    out = []
    for i in range(steps):
        name = names[(i * 7) % len(names)]
        try:
            if name in ("storage.wal.append", "storage.snapshot.write"):
                data, exc = mod.corrupt_write(name, b"0123456789")
                out.append(("write", data, exc is not None))
            elif name == "net.client.read":
                out.append(("read", mod.corrupt_read(name, b"abcdefghij")))
            else:
                act = mod.hit(name)
                out.append(("hit", None if act is None else act.kind))
        except mod.FailpointError as e:
            out.append(("raise", str(e)))
    snap = mod.snapshot()
    res = (out, mod.schedule_log(), mod.counters(), snap, mod.describe())
    mod.reset()
    return res


def test_hit_sequence_log_counters_snapshot_equal_jax():
    p, j = _drive(fp), _drive(jfp)
    assert p[0] == j[0]
    assert p[1] == j[1] and len(p[1]) > 30
    assert p[2] == j[2]
    assert p[3] == j[3]
    assert p[4] == j[4]
    assert p[3]["chaos"]["seed"] == 424242
    assert p[3]["firedTotal"] == len(p[1])


def test_actions_times_and_helpers():
    with fp.failpoint("storage.fragment.open", "raise", times=2):
        fired = 0
        for _ in range(4):
            try:
                fp.hit("storage.fragment.open")
            except fp.FailpointError:
                fired += 1
    assert fired == 2
    assert fp.counters()["storage.fragment.open"] == {"evaluations": 4,
                                                      "fired": 2}
    fp.hit("storage.fragment.open")  # nothing armed: not even counted
    assert fp.counters()["storage.fragment.open"]["evaluations"] == 4
    with pytest.raises(ValueError, match="does not support"):
        fp.configure("net.client.send", "truncate-write")
    with pytest.raises(KeyError):
        fp.configure("storage.wal.appendd", "raise")
    with fp.failpoint("executor.fanout", "raise", times=0):
        with pytest.raises(KeyError, match="unregistered"):
            fp.hit("storage.wal.appendd")
    with fp.failpoint("storage.wal.append", "truncate-write", arg=0.5):
        data, exc = fp.corrupt_write("storage.wal.append", b"0123456789")
        assert data == b"01234" and isinstance(exc, fp.FailpointError)
    with fp.failpoint("net.client.read", "partial-read", arg=0.3):
        assert fp.corrupt_read("net.client.read", b"0123456789") == b"012"

    class Boom(Exception):
        pass

    with fp.failpoint("executor.fanout", "raise"):
        with pytest.raises(Boom):
            fp.hit("executor.fanout", exc=Boom)
    w = []

    class W:
        def write(self, b):
            w.append(b)
            return len(b)

    assert fp.wrap_writer("storage.snapshot.write", W()).__class__ is W
    with fp.failpoint("storage.snapshot.write", "truncate-write", arg=0.5):
        ww = fp.wrap_writer("storage.snapshot.write", W())
        assert isinstance(ww, fp.FailpointWriter)
        with pytest.raises(fp.FailpointError, match="torn write"):
            ww.write(b"abcdef")
    assert w == [b"abc"]


ENV_SCRIPT = r"""
import json, sys
mod = __import__(sys.argv[1], fromlist=["x"])
out = []
for i in range(40):
    for name in ("net.client.send", "executor.fanout"):
        try:
            act = mod.hit(name)
            out.append([name, None if act is None else act.kind])
        except mod.FailpointError:
            out.append([name, "raise"])
snap = mod.snapshot()
print(json.dumps({"snap": snap, "out": out, "log": mod.schedule_log()}))
"""


def test_arming_from_the_environment_in_a_subprocess(tmp_path):
    env = dict(os.environ, PILOSA_TPU_CHAOS_SEED="77",
               PILOSA_TPU_CHAOS_RATE="0.6",
               PILOSA_TPU_CHAOS_POINTS="net.client.send",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    docs = {}
    for mod in ("pilosa_tpu_torch.utils.failpoints",
                "pilosa_tpu.utils.failpoints"):
        out = subprocess.run([sys.executable, "-c", ENV_SCRIPT, mod],
                             env=env, capture_output=True, text=True,
                             timeout=60, check=True)
        docs[mod] = json.loads(out.stdout.strip().splitlines()[-1])
    p, j = docs.values()
    assert p == j
    snap = p["snap"]
    assert snap["armed"] and snap["chaos"] == {
        "seed": 77, "rate": 0.6, "points": ["net.client.send"],
        "allowExit": False}
    assert snap["points"]["net.client.send"]["fired"] > 0
    assert snap["points"]["executor.fanout"]["fired"] == 0


# -- the WAL append ---------------------------------------------------------


def _bits(frag, rows=(1, 2, 3)) -> dict:
    return {r: [int(c) for c in frag.row_columns(r)] for r in rows}


def _torn_sequence(Frag, mod, path) -> None:
    f = Frag(path, "i", "f", "standard", 0).open()
    for col in range(10):
        f.set_bit(1, col)
    with mod.failpoint("storage.wal.append", "truncate-write", arg=0.4,
                       times=1):
        with pytest.raises(mod.FailpointError):
            f.set_bit(2, 999)
    f.set_bit(3, 5)  # acknowledged after the tear
    with mod.failpoint("storage.wal.append", "truncate-write", arg=0.55,
                       times=1):
        with pytest.raises(mod.FailpointError):
            f.storage.append_ops(np.arange(10, 20, dtype=np.uint64),
                                 np.empty(0, dtype=np.uint64))
    f.set_bit(3, 6)
    f.close()


def test_torn_wal_append_leaves_the_jax_bytes(tmp_path):
    paths = {}
    for name, (mod, Frag) in PKGS.items():
        paths[name] = str(tmp_path / name / "0")
        os.makedirs(os.path.dirname(paths[name]))
        _torn_sequence(Frag, mod, paths[name])
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    want = {1: list(range(10)), 2: [], 3: [5, 6]}
    for path in paths.values():
        for Frag in (Fragment, JaxFragment):
            g = Frag(path, "i", "f", "standard", 0).open()
            assert g.wal_truncated_bytes == 0
            assert _bits(g) == want
            assert g.row_columns(0).size == 0  # no adoption survived
            g.close()


def test_wal_poisoning_refuses_with_the_jax_text(tmp_path, monkeypatch):
    msgs = {}
    for name, (mod, Frag) in PKGS.items():
        f = Frag(str(tmp_path / name), "i", "f", "standard", 0).open()
        f.set_bit(1, 1)

        def boom(*_a, **_k):
            raise OSError("disk gone")

        with monkeypatch.context() as m:
            m.setattr(os, "ftruncate", boom)
            m.setattr(os, "truncate", boom)
            with mod.failpoint("storage.wal.append", "truncate-write",
                               arg=0.5, times=1):
                with pytest.raises(mod.FailpointError):
                    f.set_bit(1, 2)
        assert f.storage.wal_poisoned
        with pytest.raises(OSError) as e:
            f.set_bit(1, 3)
        msgs[name] = str(e.value)
        with pytest.raises(OSError):
            f.storage.append_ops(np.array([7], dtype=np.uint64),
                                 np.empty(0, dtype=np.uint64))
        if name == "port":
            f.snapshot()  # rewrites the file: durable again
            assert not f.storage.wal_poisoned
            f.set_bit(1, 4)
            f.close()
            g = Fragment(str(tmp_path / name), "i", "f", "standard",
                         0).open()
            assert 4 in g.row_columns(1).tolist()
            g.close()
        else:
            f.close()
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"].startswith("WAL poisoned by an earlier failed "
                                   "append")


@pytest.mark.parametrize("point,kind", [
    ("storage.snapshot.write", "truncate-write"),
    ("storage.snapshot.write", "raise"),
    ("storage.snapshot.replace", "raise")])
def test_failed_snapshot_leaves_the_old_file(tmp_path, point, kind):
    for name, (mod, Frag) in PKGS.items():
        path = str(tmp_path / name)
        f = Frag(path, "i", "f", "standard", 0).open()
        for col in range(8):
            f.set_bit(1, col)
        with open(path, "rb") as fh:
            before = fh.read()
        with mod.failpoint(point, kind, arg=0.5, times=1):
            with pytest.raises(mod.FailpointError):
                f.snapshot()
        with open(path, "rb") as fh:
            assert fh.read() == before, name
        assert not os.path.exists(path + ".snapshotting")
        f.set_bit(1, 100)  # the WAL is still attached
        f.close()
        g = Frag(path, "i", "f", "standard", 0).open()
        assert g.row_columns(1).tolist() == list(range(8)) + [100]
        g.snapshot()
        g.close()


def test_fragment_open_failpoint_raises_like_jax(tmp_path):
    for name, (mod, Frag) in PKGS.items():
        f = Frag(str(tmp_path / name), "i", "f", "standard", 0)
        with mod.failpoint("storage.fragment.open", "raise", times=1):
            with pytest.raises(mod.FailpointError, match="injected fault"):
                f.open()
        f.open()  # the next open succeeds
        f.close()
        assert mod.counters()["storage.fragment.open"]["fired"] == 1


def test_wal_fsync_environment_overrides_the_argument(tmp_path, monkeypatch):
    assert Fragment(str(tmp_path / "a"), "i", "f", "standard", 0,
                    wal_fsync=True).wal_fsync is True
    monkeypatch.setenv("PILOSA_TPU_WAL_FSYNC", "off")
    assert Fragment(str(tmp_path / "b"), "i", "f", "standard", 0,
                    wal_fsync=True).wal_fsync is False
    monkeypatch.setenv("PILOSA_TPU_WAL_FSYNC", "always")
    f = Fragment(str(tmp_path / "c"), "i", "f", "standard", 0)
    assert f.wal_fsync is True and f._wal.sync is True
    assert JaxFragment(str(tmp_path / "d"), "i", "f", "standard",
                       0).wal_fsync is True
    monkeypatch.delenv("PILOSA_TPU_WAL_FSYNC")
    assert Fragment(str(tmp_path / "e"), "i", "f", "standard",
                    0).wal_fsync is False


# -- the other storage and network sites -------------------------------------


def test_hint_failpoints_drop_and_keep_like_jax(tmp_path):
    from pilosa_tpu.storage.hints import HintStore as JaxHints
    from pilosa_tpu_torch.storage.hints import HintStore

    for name, mod, Store in (("port", fp, HintStore),
                             ("jax", jfp, JaxHints)):
        hs = Store(str(tmp_path / name))
        with mod.failpoint("storage.hints.append", "raise", times=1):
            assert hs.append("n1", "i", "Set(1, f=1)") is False
        assert hs.append("n1", "i", "Set(2, f=1)") is True
        assert hs.append("n1", "i", "Set(3, f=1)") is True
        applied = []
        with mod.failpoint("storage.hints.replay", "raise", times=1):
            assert hs.replay("n1", applied.append)[2] is False
        assert applied == [] and hs.pending("n1") > 0
        replayed, dropped, complete = hs.replay("n1", applied.append)
        assert (replayed, complete) == (2, True)
        assert [d["pql"] for d in applied] == ["Set(2, f=1)", "Set(3, f=1)"]


def test_client_failpoints_are_clean_client_errors(tmp_path):
    from pilosa_tpu_torch.net.client import ClientError, InternalClient
    from pilosa_tpu_torch.server import Server

    s = Server(str(tmp_path / "n"), port=0, device="cpu").open()
    try:
        c = InternalClient(timeout=5)
        assert c.status(s.uri)
        with fp.failpoint("net.client.send", "raise", times=1):
            with pytest.raises(ClientError, match="injected fault"):
                c.status(s.uri)
        with fp.failpoint("net.client.read", "partial-read", arg=0.5,
                          times=1):
            with pytest.raises(ClientError, match="short body"):
                c.status(s.uri)
        with fp.failpoint("net.client.read", "raise", times=1):
            with pytest.raises(ClientError, match="FailpointError"):
                c.status(s.uri)
        assert c.status(s.uri)
        # the dispatch point answers a clean JSON 500
        with fp.failpoint("http.server.dispatch", "raise", times=1):
            with pytest.raises(ClientError) as e:
                c.status(s.uri)
        assert e.value.status == 500
        assert "injected fault" in json.loads(
            str(e.value).split(": 500: ", 1)[1])["error"]
    finally:
        s.close()
