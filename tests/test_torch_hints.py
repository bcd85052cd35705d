"""The port's hint logs against the JAX package's.

storage/hints.py of both packages on the same appends, at a pinned clock:
the logs are byte-identical, each package parses and replays the other's,
and the torn tail, the corrupt record, the byte cap with its durable drop
marker and the age cap (tests/test_drain.py:77-168) give the same
(replayed, dropped, complete) and the same applied hints in both.
"""

import json
import os
import shutil
import time

import pytest

from pilosa_tpu.storage import hints as jax_hints
from pilosa_tpu_torch.storage import hints as port_hints

MODS = {"jax": jax_hints, "port": port_hints}
WRITES = [("i", "Set(5, f=1)", None), ("i", "ClearRow(f=2)", [0, 3]),
          ("j", 'Set(7, lang="Go")', None), ("i", "Store(Row(f=1), g=2)",
                                             [1])]


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25)


def _fill(mod, directory: str, max_bytes: int = 64 << 20) -> object:
    hs = mod.HintStore(directory, max_bytes=max_bytes)
    for index, pql, shards in WRITES:
        hs.append("node-1", index, pql, shards=shards)
    return hs


def test_logs_are_byte_identical(tmp_path, pinned_clock):
    logs = {}
    for name, mod in MODS.items():
        hs = _fill(mod, str(tmp_path / name), max_bytes=160)
        with open(hs._path("node-1"), "rb") as f:
            logs[name] = f.read()
        assert hs.snapshot()["queued"] == 2 and hs.dropped == 2
    assert logs["port"] == logs["jax"]
    assert logs["port"][0] == port_hints.HINT_MAGIC == jax_hints.HINT_MAGIC
    assert port_hints.parse_hint_log(logs["jax"]) == \
        jax_hints.parse_hint_log(logs["port"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_replays_the_other(tmp_path, writer, reader):
    _fill(MODS[writer], str(tmp_path / "h"))
    hs = MODS[reader].HintStore(str(tmp_path / "h"))
    assert hs.pending_targets() == {"node-1": hs.pending("node-1")}
    applied = []
    assert hs.replay("node-1", applied.append) == (len(WRITES), 0, True)
    want = []
    for index, pql, shards in WRITES:
        doc = {"index": index, "pql": pql}
        if shards is not None:
            doc["shards"] = shards
        want.append(doc)
    assert applied == want
    assert hs.pending("node-1") == 0
    assert hs.replay("node-1", applied.append) == (0, 0, True)


def _torn(mod, d):
    hs = _fill(mod, d)
    with open(hs._path("node-1"), "ab") as f:
        f.write(b"\xfb\x01torn-mid-record")
    return hs


def _corrupt(mod, d):
    hs = _fill(mod, d)
    path = hs._path("node-1")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:  # a byte of the last record
        f.seek(size - 3)
        b = f.read(1)
        f.seek(size - 3)
        f.write(bytes([b[0] ^ 0xFF]))
    return hs


def _capped(mod, d):
    hs = mod.HintStore(d, max_bytes=200)
    assert hs.append("node-1", "i", "Set(1, f=1)")
    while hs.append("node-1", "i", "Set(2, f=1)"):
        pass
    assert hs.dropped == 1
    return mod.HintStore(d)  # a restarted store still knows


def _aged(mod, d):
    hs = mod.HintStore(d, max_age=3600.0)
    hs.append("node-1", "i", "Set(1, f=1)")
    path = hs._path("node-1")
    with open(path, "rb") as f:
        records, _, _ = mod.parse_hint_log(f.read())
    old = mod._frame(json.dumps(records[0][1],
                                separators=(",", ":")).encode(),
                     time.time() - 7200)
    with open(path, "wb") as f:
        f.write(old)
    hs.append("node-1", "i", "Set(2, f=1)")
    return hs


@pytest.mark.parametrize("damage", [_torn, _corrupt, _capped, _aged],
                         ids=["torn_tail", "corrupt_record", "byte_cap",
                              "age_cap"])
def test_damage_replays_alike(tmp_path, damage):
    got = {}
    for name, mod in MODS.items():
        hs = damage(mod, str(tmp_path / name))
        rep = mod.verify_hint_log(hs._path("node-1"))
        applied = []
        out = hs.replay("node-1", applied.append)
        got[name] = (rep, out, applied)
    assert got["port"] == got["jax"]
    rep, (replayed, dropped, complete), applied = got["port"]
    assert replayed >= 1 and not complete
    if damage in (_torn, _corrupt):
        assert rep["error"]
    else:
        assert dropped == 1


def test_replay_failure_keeps_the_log(tmp_path):
    for name, mod in MODS.items():
        d = str(tmp_path / name)
        hs = _fill(mod, d)
        before = hs.pending("node-1")
        seen = []

        def flaky(doc, seen=seen):
            seen.append(doc)
            if len(seen) == 2:
                raise ConnectionError("peer went away")

        assert hs.replay("node-1", flaky) == (1, 0, False)
        assert hs.pending("node-1") == before and hs.replay_failures == 1
        assert hs.replay("node-1", lambda doc: None) == (len(WRITES), 0,
                                                          True)
        shutil.rmtree(d)


def test_drop_target_counts_its_hints(tmp_path):
    for name, mod in MODS.items():
        hs = _fill(mod, str(tmp_path / name))
        hs.drop_target("node-1")
        assert hs.pending("node-1") == 0 and hs.dropped == len(WRITES)
