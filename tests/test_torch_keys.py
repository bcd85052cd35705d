"""The port's key translation, attribute stores, protobuf codec and
official roaring reader against the JAX package's, without a server.

* TranslateStore: the same seeded stream of column and row keys (single
  and batched, repeats included) gives byte-identical logs; each package
  opens the other's log and sqlite sidecar and answers every key both
  ways; a tail appended past the sidecar's absorbed offset is replayed.
* AttrStore: the same merges (None deletes) give the same attributes,
  ids, blocks and block data, and each package opens the other's file.
* The hand-written proto3 codec: for every public message its bytes
  decode under the JAX Serializer (google.protobuf) to the same values,
  and the JAX bytes decode under the port's; the bytes themselves are
  identical where both write the same fields.
* Bitmap.from_bytes of the official RoaringFormatSpec (cookies 12346 and
  12347, run containers, 1-3 and 4+ containers) matches the JAX reader.
"""

import os
import struct

import numpy as np
import pytest

from pilosa_tpu.encoding import protobuf as jpb
from pilosa_tpu.executor import GroupCounts as JGroupCounts
from pilosa_tpu.executor import Pairs as JPairs
from pilosa_tpu.executor import RowIdentifiers as JRowIdentifiers
from pilosa_tpu.executor import ValCount as JValCount
from pilosa_tpu.models.row import Row as JRow
from pilosa_tpu.proto import pilosa_pb2 as pb
from pilosa_tpu.storage.roaring import Bitmap as JBitmap
from pilosa_tpu.utils import attrstore as jattr
from pilosa_tpu.utils import translate as jtr
from pilosa_tpu_torch.encoding import protobuf as ppb
from pilosa_tpu_torch.executor import GroupCounts, Pairs, RowIdentifiers
from pilosa_tpu_torch.executor import ValCount
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.storage.roaring import Bitmap
from pilosa_tpu_torch.utils import attrstore as pattr
from pilosa_tpu_torch.utils import translate as ptr

SW = 1 << 20

# -- translate -----------------------------------------------------------------


def _key_stream(seed: int) -> list:
    """(op, args) steps: single and batched mints and lookups of column
    keys and of row keys of two fields, with repeats and unicode."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(40):
        kind = rng.integers(0, 4)
        keys = [f"k{int(x)}" if x % 5 else f"ключ-{int(x)}"
                for x in rng.integers(0, 300, rng.integers(1, 60))]
        if kind == 0:
            steps.append(("translate_columns", ("i", keys)))
        elif kind == 1:
            steps.append(("translate_rows", ("i", "f" if i % 2 else "g",
                                             keys)))
        elif kind == 2:
            steps.append(("translate_column", ("i", keys[0])))
        else:
            steps.append(("translate_row", ("j", "f", keys[0])))
        if i % 7 == 0:
            steps.append(("translate_columns", ("i", keys + ["nope"],
                                                False)))
    return steps


def _run(store, steps) -> list:
    return [getattr(store, op)(*args) for op, args in steps]


@pytest.mark.parametrize("seed", [1, 2])
def test_translate_logs_are_byte_identical(tmp_path, seed):
    steps = _key_stream(seed)
    j = jtr.TranslateStore(str(tmp_path / "j.keys")).open()
    p = ptr.TranslateStore(str(tmp_path / "p.keys")).open()
    assert _run(p, steps) == _run(j, steps)
    j.close()
    p.close()
    assert (tmp_path / "p.keys").read_bytes() == \
        (tmp_path / "j.keys").read_bytes()
    assert p.log_size() == j.log_size() > 0


def _answers(store) -> tuple:
    cols = sorted(store.column_items("i"))
    rows = [(f, [store.translate_row_to_string("i", f, n)
                 for n in range(1, 40)]) for f in ("f", "g")]
    back = [store.translate_column_to_string("i", i) for _, i in cols]
    return cols, rows, back, store.translate_row("j", "f", "k1",
                                                 create=False)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_opens_the_others_log_and_sidecar(tmp_path, writer,
                                                       reader):
    mod = {"jax": jtr, "port": ptr}
    path = str(tmp_path / ".keys")
    w = mod[writer].TranslateStore(path).open()
    _run(w, _key_stream(3))
    want = _answers(w)
    w.close()
    assert os.path.exists(path + ".idx")
    r = mod[reader].TranslateStore(path).open()
    try:
        assert r._idx.log_pos() == os.path.getsize(path)  # nothing to replay
        assert _answers(r) == want
        # the reader mints after the writer's last id, in both directions
        nxt = r.translate_columns("i", ["fresh-a", "fresh-b"])
        assert nxt[1] == nxt[0] + 1 == len(want[0]) + 2
    finally:
        r.close()


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_only_the_unabsorbed_tail_is_replayed(tmp_path, reader):
    """A dict-indexed store appends to the log without touching the
    sqlite sidecar; the next sqlite open replays just that tail."""
    path = str(tmp_path / ".keys")
    p = ptr.TranslateStore(path).open()
    p.translate_columns("i", [f"a{i}" for i in range(50)])
    p.close()
    absorbed = os.path.getsize(path)
    d = jtr.TranslateStore(path, index_kind="dict").open()
    d.translate_columns("i", [f"b{i}" for i in range(20)])
    d.close()
    mod = {"jax": jtr, "port": ptr}[reader]
    r = mod.TranslateStore(path).open()
    try:
        assert os.path.getsize(path) > absorbed
        assert r._idx.log_pos() == os.path.getsize(path)
        assert r.translate_column("i", "b19", create=False) == 70
        assert r.translate_column_to_string("i", 51) == "b0"
    finally:
        r.close()


def test_translate_batch_lookups_match_one_by_one(tmp_path):
    """The port's batched lookups (cache, then IN queries) answer as
    key-by-key lookups do, across a reopen that empties the cache."""
    path = str(tmp_path / ".keys")
    p = ptr.TranslateStore(path).open()
    keys = [f"user{i}" for i in range(3000)]
    ids = p.translate_columns("i", keys)
    p.close()
    p = ptr.TranslateStore(path).open()
    try:
        mixed = keys[::-7] + ["missing", keys[5]]
        got = p.translate_columns("i", mixed, create=False)
        assert got == [p.translate_column("i", k, create=False)
                       for k in mixed]
        assert got[-2] is None and got[-1] == ids[5]
        assert p.translate_columns_to_strings("i", [1, 2, 3000, 4000]) == \
            ["user0", "user1", "user2999", None]
    finally:
        p.close()


def test_corrupt_logs_raise_in_both_packages(tmp_path):
    for store in (jtr.TranslateStore(str(tmp_path / "j.keys")),
                  ptr.TranslateStore(str(tmp_path / "p.keys"))):
        with open(store.path, "wb") as f:
            f.write(b"\x00\x01")
        with pytest.raises(ValueError, match="corrupt translate log"):
            store.open()


# -- attributes ----------------------------------------------------------------


ATTR_OPS = [(5, {"a": 1, "b": "x"}), (5, {"a": None, "c": True}),
            (250, {"f": 1.5}), (7, {}), (5, {"b": None}),
            (101, {"z": [1, 2]}), (250, {"f": None, "g": "y"})]


def test_attr_stores_agree_on_merges_and_blocks(tmp_path):
    j = jattr.AttrStore(str(tmp_path / "j" / "a.db")).open()
    p = pattr.AttrStore(str(tmp_path / "p" / "a.db")).open()
    for id_, m in ATTR_OPS:
        assert p.set_attrs(id_, m) == j.set_attrs(id_, m)
    j.set_bulk_attrs([(300, {"q": 1}), (300, {"r": 2, "q": None}),
                      (5, {"d": 4})])
    p.set_bulk_attrs([(300, {"q": 1}), (300, {"r": 2, "q": None}),
                      (5, {"d": 4})])
    assert p.ids() == j.ids()
    assert [p.attrs(i) for i in range(0, 400)] == \
        [j.attrs(i) for i in range(0, 400)]
    assert p.attrs_many(range(400)) == {i: j.attrs(i) for i in j.ids()}
    assert p.blocks() == j.blocks()
    for blk, _ in j.blocks():
        assert p.block_data(blk) == j.block_data(blk)
    j.close()
    p.close()
    # each opens the other's file
    pj = pattr.AttrStore(str(tmp_path / "j" / "a.db")).open()
    jp = jattr.AttrStore(str(tmp_path / "p" / "a.db")).open()
    assert pj.blocks() == jp.blocks()
    pj.close()
    jp.close()


def test_attr_store_serves_concurrent_readers_and_writers(tmp_path):
    """Request threads share one store: reads under writes never trip
    sqlite's "bad parameter or other API misuse" (the attribute-filtered
    TopN pass of chip_smoke.py phase 5f once answered a 500 and an empty
    list) and every read sees whole attribute sets."""
    import sys
    import threading

    st = pattr.AttrStore(str(tmp_path / "a.db")).open()
    for i in range(64):
        st.set_attrs(i, {"paradigm": "functional", "year": 1990 + i})
    errors = []

    def go(k):
        try:
            for n in range(200):
                got = st.attrs_many(range(64))
                assert len(got) == 64 and got[k]["paradigm"] == "functional"
                assert st.attrs(k)["year"] == 1990 + k
                if n % 20 == 0:
                    st.set_attrs(k, {"seen": n})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=go, args=(k,)) for k in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        st.close()
    assert errors == []


def test_nop_attr_stores_agree():
    j, p = jattr.NopAttrStore().open(), pattr.NopAttrStore().open()
    for name in ("ids", "blocks"):
        assert getattr(p, name)() == getattr(j, name)()
    assert p.set_attrs(1, {"a": 1}) == j.set_attrs(1, {"a": 1})
    assert p.attrs(1) == j.attrs(1) and p.block_data(0) == j.block_data(0)


# -- protobuf ------------------------------------------------------------------


def _jax_results():
    row = JRow(np.array([1, 5, SW + 3, 3 * SW], dtype=np.uint64))
    row.attrs = {"s": "x", "i": -7, "b": True, "f": 2.5}
    keyed_row = JRow(np.array([2], dtype=np.uint64))
    keyed_row.keys = ["only"]
    pairs = JPairs([(3, 10), (1, 2)])
    kpairs = JPairs([(3, 10), (0, 2)])
    kpairs.row_keys = ["Go", "Rust"]
    rows = JRowIdentifiers([1, 4, 9])
    krows = JRowIdentifiers()
    krows.row_keys = ["a", "b"]
    groups = JGroupCounts([
        {"group": [{"field": "f", "rowID": 0}, {"field": "g", "rowKey": "k"}],
         "count": 3},
        {"group": [{"field": "f", "rowID": 2}], "count": 1}])
    return [row, keyed_row, JRow(), pairs, kpairs, JPairs(),
            JValCount(-5, 2), JValCount(0, 0), rows, krows,
            JRowIdentifiers(), groups, JGroupCounts([]), 17, 0, True, False,
            None]


def _port_results():
    row = Row.from_columns([1, 5, SW + 3, 3 * SW])
    row.attrs = {"s": "x", "i": -7, "b": True, "f": 2.5}
    keyed_row = Row.from_columns([2])
    keyed_row.keys = ["only"]
    pairs = Pairs([(3, 10), (1, 2)])
    kpairs = Pairs([(3, 10), (0, 2)])
    kpairs.row_keys = ["Go", "Rust"]
    rows = RowIdentifiers([1, 4, 9])
    krows = RowIdentifiers()
    krows.row_keys = ["a", "b"]
    groups = GroupCounts([
        {"group": [{"field": "f", "rowID": 0}, {"field": "g", "rowKey": "k"}],
         "count": 3},
        {"group": [{"field": "f", "rowID": 2}], "count": 1}])
    return [row, keyed_row, Row(), pairs, kpairs, Pairs(),
            ValCount(-5, 2), ValCount(0, 0), rows, krows, RowIdentifiers(),
            groups, GroupCounts([]), 17, 0, True, False, None]


def _plain(r):
    """A result as plain data, whichever package built it."""
    name = type(r).__name__
    if name == "Row":
        return ("Row", [int(c) for c in r.columns()], dict(r.attrs),
                list(r.keys))
    if name == "Pairs":
        return ("Pairs", [tuple(map(int, p)) for p in r],
                getattr(r, "row_keys", None))
    if name == "RowIdentifiers":
        return ("Rows", [int(x) for x in r], getattr(r, "row_keys", None))
    if name == "ValCount":
        return ("ValCount", int(r.val), int(r.count))
    if name == "GroupCounts":
        return ("Groups", [dict(g) for g in r])
    return r


CAS = [{"id": 5, "attrs": {"city": "ankh", "n": 3}, "key": "repo5"},
       {"id": 9, "attrs": {"ok": False, "w": -1.25}}]


def test_query_response_both_directions():
    j, p = jpb.Serializer(), ppb.Serializer()
    prof = {"traceId": "t", "ms": 1.5}
    pbytes = p.encode_query_response(_port_results(), column_attr_sets=CAS,
                                     profile=prof)
    jbytes = j.encode_query_response(_jax_results(), column_attr_sets=CAS,
                                     profile=prof)
    for data in (pbytes, jbytes):
        jd, pd = j.decode_query_response(data), p.decode_query_response(data)
        assert [_plain(r) for r in pd["results"]] == \
            [_plain(r) for r in jd["results"]]
        assert pd["columnAttrSets"] == jd["columnAttrSets"] == [
            {"id": 5, "attrs": {"city": "ankh", "n": 3}, "key": "repo5"},
            {"id": 9, "attrs": {"ok": False, "w": -1.25}}]
        assert pd["profile"] == jd["profile"] == prof
        assert pd["err"] == jd["err"] == ""
    assert [_plain(r) for r in
            p.decode_query_response(pbytes)["results"]] == \
        [_plain(r) for r in p.decode_query_response(jbytes)["results"]]
    err = p.encode_query_response([], err="boom")
    assert j.decode_query_response(err)["err"] == "boom"


def test_query_request_both_directions():
    j, p = jpb.Serializer(), ppb.Serializer()
    for args in (("Count(Row(f=1))", [0, 3, 1 << 40], False, True, True),
                 ("", None, True, False, False)):
        pb_bytes = p.encode_query_request(*args)
        jb_bytes = j.encode_query_request(*args)
        assert pb_bytes == jb_bytes
        assert p.decode_query_request(jb_bytes) == \
            j.decode_query_request(pb_bytes)
    m = pb.QueryRequest(Query="x", ExcludeRowAttrs=True, ExcludeColumns=True)
    assert p.decode_query_request(m.SerializeToString()) == \
        j.decode_query_request(m.SerializeToString())
    assert ppb.encode(ppb.QUERY_REQUEST, ppb.decode(
        ppb.QUERY_REQUEST, m.SerializeToString())) == m.SerializeToString()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_import_requests_both_directions(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 300))
    rows = rng.integers(0, 1 << 40, n).tolist()
    cols = rng.integers(0, 1 << 63, n, dtype=np.uint64).tolist()
    ts = rng.integers(-(1 << 62), 1 << 62, n).tolist()
    vals = rng.integers(-(1 << 62), 1 << 62, n).tolist()
    rkeys = [f"r{x}" for x in rng.integers(0, 9, n)]
    ckeys = [f"c{x}" if x else "" for x in rng.integers(0, 9, n)]
    j, p = jpb.Serializer(), ppb.Serializer()
    for enc, dec, args in (
            ("encode_import_request", "decode_import_request",
             ("i", "f", 3, rows, cols, ts, rkeys, ckeys)),
            ("encode_import_request", "decode_import_request",
             ("i", "f", 0, None, None, None, None, None)),
            ("encode_import_value_request", "decode_import_value_request",
             ("i", "v", 7, cols, vals, ckeys))):
        pbytes, jbytes = (getattr(s, enc)(*args) for s in (p, j))
        assert pbytes == jbytes
        assert getattr(p, dec)(jbytes) == getattr(j, dec)(pbytes)


def test_import_roaring_request_both_directions():
    j, p = jpb.Serializer(), ppb.Serializer()
    views = {"": b"\x3c\x30\x00\x00", "standard_2019": bytes(range(200))}
    for clear in (False, True):
        pbytes = p.encode_import_roaring_request(views, clear=clear)
        jbytes = j.encode_import_roaring_request(views, clear=clear)
        assert pbytes == jbytes
        assert p.decode_import_roaring_request(jbytes) == \
            j.decode_import_roaring_request(pbytes) == \
            {"clear": clear, "views": views}


@pytest.mark.parametrize("msg", [
    pb.Attr(Key="a", Type=1, StringValue="x"),
    pb.Attr(Key="b", Type=2, IntValue=-(1 << 62)),
    pb.Attr(Key="c", Type=3, BoolValue=True),
    pb.Attr(Key="d", Type=4, FloatValue=-0.125),
    pb.ColumnAttrSet(ID=1 << 50, Key="k", Attrs=[pb.Attr(Key="z", Type=2,
                                                         IntValue=3)]),
    pb.Row(Columns=[1, 1 << 63], Keys=["x", ""],
           Attrs=[pb.Attr(Key="a", Type=3, BoolValue=False)]),
    pb.Pair(ID=4, Count=1 << 33, Key="go"),
    pb.ValCount(Val=-1, Count=-2),
    pb.RowIdentifiers(Rows=[0, 7]),
    pb.GroupCount(Count=4, Group=[pb.FieldRow(Field="f", RowID=2),
                                  pb.FieldRow(Field="g", RowKey="k")]),
    pb.QueryResult(Type=8, RowIdentifiers=pb.RowIdentifiers(Keys=["a"])),
], ids=lambda m: type(m).__name__)
def test_messages_round_trip_through_google_protobuf(msg):
    schema = {"Attr": ppb.ATTR, "ColumnAttrSet": ppb.COLUMN_ATTR_SET,
              "Row": ppb.ROW, "Pair": ppb.PAIR, "ValCount": ppb.VAL_COUNT,
              "RowIdentifiers": ppb.ROW_IDENTIFIERS,
              "GroupCount": ppb.GROUP_COUNT,
              "QueryResult": ppb.QUERY_RESULT}[type(msg).__name__]
    data = msg.SerializeToString()
    decoded = ppb.decode(schema, data)
    assert ppb.encode(schema, decoded) == data
    back = type(msg)()
    back.ParseFromString(ppb.encode(schema, decoded))
    assert back == msg


def test_unpacked_repeated_numbers_decode():
    """proto2-style unpacked repeated varints are read too."""
    data = b"".join(struct.pack("<BB", 4 << 3, v) for v in (1, 2, 3))
    assert ppb.Serializer().decode_import_request(data)["rowIDs"] == \
        [1, 2, 3]


@pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x80", b"\x0b"])
def test_malformed_bytes_raise_value_error(data):
    with pytest.raises(ValueError):
        ppb.Serializer().decode_query_request(data)


# -- official roaring ----------------------------------------------------------


def _official(values: np.ndarray, runs: set, with_run_cookie: bool) -> bytes:
    """The official 32-bit RoaringFormatSpec bytes of `values`; the
    container keys in `runs` are written as run containers."""
    values = np.unique(values.astype(np.uint32))
    keys = np.unique(values >> 16)
    size = len(keys)
    descs, payloads = [], []
    for k in keys:
        lows = (values[(values >> 16) == k] & 0xFFFF).astype(np.int64)
        descs.append(struct.pack("<HH", int(k), lows.size - 1))
        if int(k) in runs:
            brk = np.nonzero(np.diff(lows) != 1)[0]
            starts = np.concatenate([[lows[0]], lows[brk + 1]])
            ends = np.concatenate([lows[brk], [lows[-1]]])
            iv = np.stack([starts, ends - starts], axis=1).astype("<u2")
            payloads.append(struct.pack("<H", len(iv)) + iv.tobytes())
        elif lows.size <= 4096:
            payloads.append(lows.astype("<u2").tobytes())
        else:
            words = np.zeros(1024, dtype="<u8")
            np.bitwise_or.at(words, lows >> 6,
                             np.left_shift(np.uint64(1),
                                           (lows & 63).astype(np.uint64)))
            payloads.append(words.tobytes())
    if with_run_cookie:
        flags = np.zeros((size + 7) // 8, dtype=np.uint8)
        for i, k in enumerate(keys):
            if int(k) in runs:
                flags[i // 8] |= 1 << (i % 8)
        head = struct.pack("<I", 12347 | (size - 1) << 16) + flags.tobytes()
    else:
        head = struct.pack("<II", 12346, size)
    head += b"".join(descs)
    with_offsets = not with_run_cookie or size >= 4
    start = len(head) + (4 * size if with_offsets else 0)
    offsets = []
    for pl in payloads:
        offsets.append(start)
        start += len(pl)
    if with_offsets:
        head += struct.pack(f"<{size}I", *offsets)
    return head + b"".join(payloads)


@pytest.mark.parametrize("n_containers", [1, 3, 4, 9])
@pytest.mark.parametrize("with_run_cookie", [False, True])
def test_official_roaring_matches_the_jax_reader(n_containers,
                                                 with_run_cookie):
    rng = np.random.default_rng(n_containers)
    parts, runs = [], set()
    for c in range(n_containers):
        base = (c * 3) << 16
        if c % 3 == 0:  # array
            parts.append(base + rng.choice(65536, 100 + c, replace=False))
        elif c % 3 == 1:  # bitmap
            parts.append(base + rng.choice(65536, 5000 + c, replace=False))
        else:  # runs
            parts.append(base + np.concatenate([np.arange(10, 400),
                                                np.arange(9000, 9100)]))
            if with_run_cookie:
                runs.add(c * 3)
    values = np.concatenate(parts)
    data = _official(values, runs, with_run_cookie)
    want = JBitmap.from_bytes(data)
    got = Bitmap.from_bytes(data)
    assert got.count() == want.count() == np.unique(values).size
    np.testing.assert_array_equal(got.slice(), want.slice())
    if runs:
        assert any(c.kind == "run" for c in got.containers.values())


@pytest.mark.parametrize("data", [b"\x3b\x30\x00\x00" + b"\x00" * 4,
                                  b"\x3a\x30\x00\x00\x05\x00\x00\x00"])
def test_official_roaring_errors(data):
    for cls in (JBitmap, Bitmap):
        with pytest.raises(Exception):
            cls.from_bytes(data)
