"""The port's time, mutex and bool fields, whole-row writes and the roaring
import against the JAX package.

The same seeded inputs go through pilosa_tpu and pilosa_tpu_torch: the
time quantum's views and range covers, field validation and its error
texts, mutex and bool set/clear, the mutex bulk import over dict and
frozen stores, set_row and clear_row, import_roaring's union and clear
(the in-place clear over a frozen store and its volatile count), time
imports (the view names and every fragment's bytes), holders written by
one package and opened by the other, and the port's durable Store and
ClearRow. Everything compared is an integer, a string or a byte: the
tolerance is 0.
"""

import io
import os
from datetime import datetime, timedelta

import numpy as np
import pytest

from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.models import FieldOptions as JFieldOptions
from pilosa_tpu.models import Holder as JHolder
from pilosa_tpu.models import timequantum as jtq
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models import timequantum as ttq
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.roaring import Bitmap

QUANTA = ("Y", "YM", "YMD", "YMDH", "MD", "DH")


# -- time quantum ---------------------------------------------------------


def _range_sweep(seed: int) -> list:
    """(start, end) pairs: year, month and day rollovers, leap days, empty
    and reversed ranges, and random spans of minutes to years."""
    edges = [
        (datetime(2019, 12, 31, 23), datetime(2020, 1, 1, 1)),
        (datetime(2019, 1, 31, 22), datetime(2019, 2, 1, 3)),
        (datetime(2020, 2, 28), datetime(2020, 3, 2)),  # leap day
        (datetime(2019, 2, 28), datetime(2019, 3, 1)),
        (datetime(2016, 2, 29, 5), datetime(2024, 2, 29, 7)),
        (datetime(2019, 1, 15), datetime(2019, 3, 10)),
        (datetime(2019, 1, 1), datetime(2020, 1, 1)),
        (datetime(2019, 3, 1), datetime(2019, 3, 1)),  # empty
        (datetime(2019, 3, 8), datetime(2019, 3, 1)),  # reversed
        (datetime(2018, 12, 31, 23, 30), datetime(2019, 1, 1, 0, 30)),
    ]
    rng = np.random.default_rng(seed)
    base = datetime(2015, 1, 1)
    for _ in range(60):
        a = base + timedelta(minutes=int(rng.integers(0, 6 * 365 * 1440)))
        span = int(rng.choice([30, 1440, 40 * 1440, 500 * 1440]))
        edges.append((a, a + timedelta(minutes=int(rng.integers(0, span)))))
    return edges


@pytest.mark.parametrize("quantum", QUANTA)
def test_views_by_time_and_range_match_jax(quantum):
    for start, end in _range_sweep(len(quantum)):
        assert (ttq.views_by_time_range("standard", start, end, quantum)
                == jtq.views_by_time_range("standard", start, end, quantum))
        assert (ttq.views_by_time("standard", start, quantum)
                == jtq.views_by_time("standard", start, quantum))


@pytest.mark.parametrize("bad", ["X", "DM", "YY", "HY", "ymd"])
def test_invalid_quantum_raises_the_same_text(bad):
    with pytest.raises(ValueError) as je:
        jtq.views_by_time_range("standard", datetime(2019, 1, 1),
                                datetime(2019, 2, 1), bad)
    with pytest.raises(ValueError) as te:
        ttq.views_by_time_range("standard", datetime(2019, 1, 1),
                                datetime(2019, 2, 1), bad)
    assert str(te.value) == str(je.value)


# -- validation -----------------------------------------------------------


@pytest.mark.parametrize("opts", [
    dict(type="bogus"), dict(type="time"), dict(type="time", time_quantum="DY"),
    dict(type="int", min=5, max=1), dict(type="mutex", cache_type="huge"),
    dict(type="time", time_quantum="YMD"), dict(type="mutex"),
    dict(type="bool"), dict(type="set", time_quantum="XQ"),
])
def test_field_validation_matches_jax(opts):
    def outcome(options):
        try:
            options.validate()
        except ValueError as e:
            return str(e)
        return None

    assert outcome(FieldOptions(**opts)) == outcome(JFieldOptions(**opts))


# -- fields: mutex, bool, time --------------------------------------------


def _twin_fields(tmp_path, **opts):
    th = Holder(str(tmp_path / "t")).open()
    jh = JHolder(str(tmp_path / "j")).open()
    tf = th.create_index("i", track_existence=False).create_field(
        "f", FieldOptions(**opts))
    jf = jh.create_index("i", track_existence=False).create_field(
        "f", JFieldOptions(**opts))
    return th, jh, tf, jf


def _frag_bytes(frag) -> bytes:
    frag.snapshot()
    with open(frag.path, "rb") as f:
        return f.read()


def _same_field(tf, jf) -> None:
    """The same views, shards, bits and snapshot bytes."""
    assert sorted(tf.views) == sorted(jf.views)
    assert tf.shards() == jf.shards()
    for name, tv in tf.views.items():
        jv = jf.views[name]
        assert sorted(tv.fragments) == sorted(jv.fragments), name
        for s, tfr in tv.fragments.items():
            jfr = jv.fragments[s]
            np.testing.assert_array_equal(tfr.storage.positions(),
                                          jfr.storage.positions())
            assert _frag_bytes(tfr) == _frag_bytes(jfr), (name, s)


def _bit_ops(seed: int, n: int, rows: int, cols: int) -> list:
    rng = np.random.default_rng(seed)
    return [(bool(rng.random() < 0.8), int(rng.integers(0, rows)),
             int(rng.integers(0, cols))) for _ in range(n)]


@pytest.mark.parametrize("kind", ["mutex", "bool"])
def test_mutex_and_bool_set_clear_match_jax(tmp_path, kind):
    th, jh, tf, jf = _twin_fields(tmp_path, type=kind)
    try:
        rows = 2 if kind == "bool" else 6
        for is_set, r, c in _bit_ops(7, 400, rows, 3 * SHARD_WIDTH):
            c = c % 300 + (c // SHARD_WIDTH) * SHARD_WIDTH  # collisions
            if is_set:
                assert tf.set_bit(r, c) == jf.set_bit(r, c)
            else:
                assert tf.clear_bit(r, c) == jf.clear_bit(r, c)
        for r in range(rows):
            tv, jv = tf.views["standard"], jf.views["standard"]
            for s in jv.fragments:
                assert (tv.fragments[s].row_columns(r).tolist()
                        == jf.row(r).segments.get(s, np.empty(0)).astype(
                            np.int64).__mod__(SHARD_WIDTH).tolist())
        _same_field(tf, jf)
        # at most one row per column
        for s, frag in tf.views["standard"].fragments.items():
            for c in range(300):
                assert len(frag.rows_for_column(c)) <= 1
    finally:
        th.close()
        jh.close()


def test_bool_row_two_and_int_set_bit_raise_the_same_text(tmp_path):
    th, jh, tf, jf = _twin_fields(tmp_path, type="bool")
    ti = th.index("i").create_field("v", FieldOptions(type="int", max=9))
    ji = jh.index("i").create_field("v", JFieldOptions(type="int", max=9))
    try:
        for t_call, j_call in ((lambda: tf.set_bit(2, 9),
                                lambda: jf.set_bit(2, 9)),
                               (lambda: ti.set_bit(1, 9),
                                lambda: ji.set_bit(1, 9)),
                               (lambda: th.index("i").create_field(
                                   "s").set_bit(1, 2, datetime(2019, 1, 1)),
                                lambda: jh.index("i").create_field(
                                    "s").set_bit(1, 2, datetime(2019, 1, 1)))):
            with pytest.raises(ValueError) as te:
                t_call()
            with pytest.raises(ValueError) as je:
                j_call()
            assert str(te.value) == str(je.value)
    finally:
        th.close()
        jh.close()


@pytest.mark.parametrize("quantum", ["YMD", "YMDH", "MD"])
def test_time_set_bit_and_row_time_match_jax(tmp_path, quantum):
    th, jh, tf, jf = _twin_fields(tmp_path, type="time", time_quantum=quantum)
    try:
        rng = np.random.default_rng(11)
        base = datetime(2019, 1, 1)
        for _ in range(300):
            r, c = int(rng.integers(0, 4)), int(rng.integers(0, 2 * SHARD_WIDTH))
            ts = (None if rng.random() < 0.1 else base + timedelta(
                minutes=int(rng.integers(0, 120 * 1440))))
            assert tf.set_bit(r, c, ts) == jf.set_bit(r, c, ts)
            if rng.random() < 0.1:
                assert tf.clear_bit(r, c) == jf.clear_bit(r, c)
        _same_field(tf, jf)
        for start, end in _range_sweep(3)[:20]:
            for r in range(4):
                assert (tf.row_time(r, start, end).columns().tolist()
                        == jf.row_time(r, start, end).columns().tolist())
    finally:
        th.close()
        jh.close()


@pytest.mark.parametrize("kind", ["time", "mutex", "bool", "set"])
@pytest.mark.parametrize("clear", [False, True])
def test_import_bits_matches_jax(tmp_path, kind, clear):
    """Field.import_bits: the same views, bits and fragment bytes; time
    imports with timestamps (and bits without), mutex and bool imports
    with duplicate columns (the last write wins)."""
    opts = dict(type=kind)
    if kind == "time":
        opts["time_quantum"] = "YMDH"
    th, jh, tf, jf = _twin_fields(tmp_path, **opts)
    try:
        rng = np.random.default_rng(5)
        for round_ in range(3):
            n = 3000
            rows = rng.integers(0, 2 if kind == "bool" else 12, n)
            cols = rng.integers(0, 3 * SHARD_WIDTH, n) % (
                3 * SHARD_WIDTH if kind == "time" else 2000)
            # 3 days of hours: about 80 views over 3 shards
            secs = rng.integers(0, 3 * 86400, n)
            ts = [None if x % 7 == 0 else
                  datetime(2019, 1, 1) + timedelta(seconds=int(x))
                  for x in secs]
            jf.import_bits(rows.tolist(), cols.tolist(), ts,
                           clear=clear and round_ == 2)
            tf.import_bits(rows, cols, ts, clear=clear and round_ == 2)
        _same_field(tf, jf)
    finally:
        th.close()
        jh.close()


def test_import_bits_datetime64_timestamps_equal_datetimes(tmp_path):
    th, jh, tf, jf = _twin_fields(tmp_path, type="time", time_quantum="YMD")
    try:
        rng = np.random.default_rng(9)
        rows = rng.integers(0, 4, 500)
        cols = rng.integers(0, 2 * SHARD_WIDTH, 500)
        secs = rng.integers(0, 400 * 86400, 500)
        dts = [datetime(2019, 6, 1) + timedelta(seconds=int(x)) for x in secs]
        jf.import_bits(rows.tolist(), cols.tolist(), dts)
        tf.import_bits(rows, cols, np.array(dts, dtype="datetime64[us]"))
        _same_field(tf, jf)
    finally:
        th.close()
        jh.close()


def test_mutex_bulk_import_keeps_one_row_per_column(tmp_path):
    """Field-level mutex import after single-bit sets: the last write of a
    column wins and the column's earlier rows lose their bits."""
    th, jh, tf, jf = _twin_fields(tmp_path, type="mutex")
    try:
        for f in (tf, jf):
            f.set_bit(1, 5)
            f.set_bit(2, 6)
            f.import_bits([3, 2, 1, 2], [5, 6, 7, 7])
            assert f.row(1).columns().tolist() == []
            assert f.row(2).columns().tolist() == [6, 7]
            assert f.row(3).columns().tolist() == [5]
        _same_field(tf, jf)
    finally:
        th.close()
        jh.close()


# -- fragments: mutex bulk import, rows, roaring --------------------------


def _twin_frags(tmp_path, frozen_pos=None):
    t = Fragment(str(tmp_path / "t0"), "i", "f", "standard", 0).open()
    j = JFragment(str(tmp_path / "j0"), "i", "f", "standard", 0).open()
    if frozen_pos is not None:
        t.import_frozen(frozen_pos)
        j.import_frozen(frozen_pos)
    return t, j


def _mutex_base(seed: int) -> np.ndarray:
    """One bit per column: 5000 columns over 40 rows."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(SHARD_WIDTH, 5000, replace=False))
    rows = rng.integers(0, 40, cols.size)
    return np.sort(rows.astype(np.uint64) * np.uint64(SHARD_WIDTH)
                   + cols.astype(np.uint64))


@pytest.mark.parametrize("store", ["dict", "frozen"])
def test_bulk_import_mutex_matches_jax(tmp_path, store):
    base = _mutex_base(1)
    t, j = _twin_frags(tmp_path, base if store == "frozen" else None)
    try:
        if store == "dict":
            rows, cols = base // SHARD_WIDTH, base % SHARD_WIDTH
            t.bulk_import_mutex(rows, cols)
            j.bulk_import_mutex(rows.tolist(), cols.tolist())
        rng = np.random.default_rng(2)
        known = (base % SHARD_WIDTH).astype(np.int64)
        for _ in range(3):
            cols = np.concatenate([rng.choice(known, 800),
                                   rng.integers(0, SHARD_WIDTH, 200)])
            rows = rng.integers(0, 50, cols.size)
            t.bulk_import_mutex(rows, cols)
            j.bulk_import_mutex(rows.tolist(), cols.tolist())
        assert t.frozen == (store == "frozen")
        np.testing.assert_array_equal(t.storage.positions(),
                                      j.storage.positions())
        for c in rng.choice(known, 50).tolist():
            assert t.rows_for_column(c) == j.rows_for_column(c)
            assert len(t.rows_for_column(c)) == 1
        assert t.volatile_mutations == j.volatile_mutations
        assert _frag_bytes(t) == _frag_bytes(j)
    finally:
        t.close()
        j.close()


def test_bulk_import_mutex_last_write_wins(tmp_path):
    t, j = _twin_frags(tmp_path)
    try:
        for frag in (t, j):
            frag.bulk_import_mutex([1, 2, 3], [10, 10, 10])
            assert frag.rows_for_column(10) == [3]
            frag.bulk_import_mutex([7, 8], [10, 11])
            assert frag.rows_for_column(10) == [7]
            assert frag.rows_for_column(11) == [8]
            assert frag.bit_count() == 2
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("store", ["dict", "frozen"])
def test_set_row_and_clear_row_match_jax(tmp_path, store):
    base = _mutex_base(3)
    t, j = _twin_frags(tmp_path, base if store == "frozen" else None)
    try:
        if store == "dict":
            for frag in (t, j):
                frag.bulk_import(list(base // SHARD_WIDTH),
                                 list(base % SHARD_WIDTH))
        rng = np.random.default_rng(4)
        for r in range(8):
            cols = rng.integers(0, SHARD_WIDTH, int(rng.integers(0, 3000)))
            g_t, g_j = t.row_generation(r), j.row_generation(r)
            t.set_row(r, cols)
            j.set_row(r, cols.astype(np.uint64))
            assert t.row_generation(r) > g_t and j.row_generation(r) > g_j
        for r in (3, 9, 41, 5):
            assert t.clear_row(r) == j.clear_row(r)
        np.testing.assert_array_equal(t.storage.positions(),
                                      j.storage.positions())
        np.testing.assert_array_equal(t.row_counts(range(45)),
                                      [j.row_count(r) for r in range(45)])
        assert t.volatile_mutations == j.volatile_mutations
        assert _frag_bytes(t) == _frag_bytes(j)
    finally:
        t.close()
        j.close()


def _roaring(pos: np.ndarray) -> bytes:
    b = Bitmap()
    b.add_many(np.asarray(pos, dtype=np.uint64))
    buf = io.BytesIO()
    b.write_to(buf)
    return buf.getvalue()


@pytest.mark.parametrize("store", ["dict", "frozen"])
def test_import_roaring_union_and_clear_match_jax(tmp_path, store):
    # bitmap containers (10,000 bits in each of 24 over 8 rows): the JAX
    # package's frozen clear raises KeyError over two array containers
    # and computes a xor otherwise (ROADMAP Queue C 6), which agrees with
    # a difference for a clear of present bits only
    rng = np.random.default_rng(6)
    keys = rng.choice(8 * 16, 24, replace=False).astype(np.uint64)
    base = np.unique((keys[:, None] << np.uint64(16)) | rng.integers(
        0, 1 << 16, (24, 10_000)).astype(np.uint64))
    t, j = _twin_frags(tmp_path, base if store == "frozen" else None)
    try:
        if store == "dict":
            for frag in (t, j):
                frag.bulk_import(list(base // SHARD_WIDTH),
                                 list(base % SHARD_WIDTH))
        store_obj = t.storage.containers
        add = (rng.choice(keys, 20_000) << np.uint64(16)) | rng.integers(
            0, 1 << 16, 20_000).astype(np.uint64)
        data = _roaring(add)
        t.import_roaring(data)
        j.import_roaring(data)
        cur = t.storage.positions()
        gone = rng.choice(cur, 5000, replace=False)
        data = _roaring(gone)
        t.import_roaring(data, clear=True)
        j.import_roaring(data, clear=True)
        if store == "frozen":
            assert t.storage.containers is store_obj  # in place
            assert t.frozen and t._volatile
        np.testing.assert_array_equal(t.storage.positions(),
                                      j.storage.positions())
        assert t.volatile_mutations == j.volatile_mutations
        assert t.row_generation(3) > 0
        assert _frag_bytes(t) == _frag_bytes(j)
    finally:
        t.close()
        j.close()


def test_import_roaring_clear_of_absent_bits_is_a_difference(tmp_path):
    """The port's frozen in-place clear removes only bits that are set."""
    base = np.arange(0, 200_000, 2, dtype=np.uint64)
    t = Fragment(str(tmp_path / "t0"), "i", "f", "standard", 0).open()
    try:
        t.import_frozen(base)
        t.import_roaring(_roaring(np.arange(0, 1000, dtype=np.uint64)),
                         clear=True)
        assert t.bit_count() == base.size - 500
        assert not t.storage.contains(1) and t.storage.contains(1000)
    finally:
        t.close()


# -- durability of whole-row writes ---------------------------------------


def test_store_and_clear_row_survive_a_reopen(tmp_path):
    """Acknowledged Store and ClearRow read back after a clean close and
    reopen (the JAX package loses both: ROADMAP Queue C 5)."""
    path = str(tmp_path / "d")
    h = Holder(path).open()
    h.create_index("i").create_field("f")
    ex = Executor(h, device="cpu")
    assert ex.execute("i", "Set(1, f=1) Set(2, f=1) Set(7, f=3) "
                      "Set(2000000, f=3)") == [True] * 4
    assert ex.execute("i", "Store(Row(f=1), f=9) ClearRow(f=3)") == [True,
                                                                      True]
    h.close()
    h = Holder(path).open()
    try:
        ex = Executor(h, device="cpu")
        assert ex.execute("i", "Row(f=9)")[0].columns().tolist() == [1, 2]
        assert ex.execute("i", "Row(f=3)")[0].columns().tolist() == []
        # the JAX package opens the port's files the same way
        h.close()
        jh = JHolder(path).open()
        try:
            jex = JExecutor(jh)
            assert jex.execute("i", "Row(f=9)")[0].columns().tolist() == [1, 2]
            assert jex.execute("i", "Row(f=3)")[0].columns().tolist() == []
        finally:
            jh.close()
        h = Holder(path).open()
    finally:
        h.close()


def test_whole_row_writes_on_a_frozen_fragment_are_volatile(tmp_path):
    """On a frozen fragment set_row and clear_row count as volatile
    mutations and become durable at snapshot()."""
    path = str(tmp_path / "v0")
    pos = _mutex_base(8)
    frag = Fragment(path, "i", "f", "standard", 0).open()
    frag.import_frozen(pos)
    frag.set_row(45, [5, 6, 7])
    n = frag.clear_row(int(pos[0] // SHARD_WIDTH))
    assert n > 0 and frag.volatile_mutations == 2 and frag._volatile
    frag.snapshot()
    assert not frag._volatile and frag.volatile_mutations == 0
    want = frag.storage.positions()
    frag.set_row(46, [9])  # WAL attached again: logged
    frag.close()
    again = Fragment(path, "i", "f", "standard", 0).open()
    try:
        np.testing.assert_array_equal(
            again.storage.positions(),
            np.union1d(want, [46 * SHARD_WIDTH + 9]).astype(np.uint64))
    finally:
        again.close()


@pytest.mark.parametrize("cap", [0, 2, 8192])
def test_wal_descriptor_budget(tmp_path, monkeypatch, cap):
    """Fragments past the WAL descriptor budget append by open and close;
    a kept descriptor is released by snapshot() (which replaces the file)
    and close(). Every op reads back after a reopen either way."""
    from pilosa_tpu_torch.storage import fragment as tfrag

    budget = tfrag._FdBudget(cap)
    monkeypatch.setattr(tfrag, "WAL_FDS", budget)
    frags = [Fragment(str(tmp_path / str(i)), "i", "f", "standard",
                      0).open() for i in range(5)]
    for i, frag in enumerate(frags):
        frag.set_bit(1, i)
    assert budget.used == min(cap, 5)
    for frag in frags:
        frag.snapshot()
        frag.set_bit(2, 7)  # after the file was replaced
        frag.set_row(3, [1, 2])
    assert budget.used == min(cap, 5)
    for frag in frags:
        frag.close()
    assert budget.used == 0
    for i in range(5):
        again = Fragment(str(tmp_path / str(i)), "i", "f", "standard",
                         0).open()
        assert again.storage.positions().tolist() == [
            SHARD_WIDTH + i, 2 * SHARD_WIDTH + 7, 3 * SHARD_WIDTH + 1,
            3 * SHARD_WIDTH + 2]
        again.close()


# -- holders across packages ----------------------------------------------


def _typed_writes(h, opts_cls) -> None:
    idx = h.create_index("i", track_existence=True)
    t = idx.create_field("t", opts_cls(type="time", time_quantum="YMD"))
    m = idx.create_field("m", opts_cls(type="mutex"))
    b = idx.create_field("b", opts_cls(type="bool"))
    rng = np.random.default_rng(13)
    n = 2000
    cols = rng.integers(0, 2 * SHARD_WIDTH, n)
    ts = [datetime(2019, 1, 1) + timedelta(hours=int(x))
          for x in rng.integers(0, 24 * 90, n)]
    t.import_bits(rng.integers(0, 8, n).tolist(), cols.tolist(), ts)
    m.import_bits(rng.integers(0, 5, n).tolist(), cols.tolist())
    b.import_bits(rng.integers(0, 2, n).tolist(), cols.tolist())
    for c in cols[:50].tolist():
        m.set_bit(4, c)
        b.set_bit(1, c)


QUERIES = (
    "Count(Range(t=3, 2019-01-15T00:00, 2019-03-10T00:00))",
    "Range(t=1, 2019-02-01T00:00, 2019-03-01T00:00)",
    "Count(Intersect(Row(m=2), Row(b=true)))",
    "Rows(field=m)",
    "TopN(t, n=3)",
    "Count(Intersect(Range(t=0, 2019-01-01T00:00, 2019-04-01T00:00), "
    "Row(m=1), Row(b=false)))",
)


def _answers(ex, idx: str = "i") -> list:
    out = []
    for q in QUERIES:
        r = ex.execute(idx, q)[0]
        if hasattr(r, "columns"):
            r = r.columns().tolist()
        elif isinstance(r, list):  # Pairs, RowIdentifiers
            r = [tuple(x) if isinstance(x, (tuple, list)) else x for x in r]
        out.append(r)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_holders_open_in_either_package(tmp_path, writer):
    path = str(tmp_path / "d")
    w = (JHolder if writer == "jax" else Holder)(path).open()
    _typed_writes(w, JFieldOptions if writer == "jax" else FieldOptions)
    w.close()
    jh = JHolder(path).open()
    j_ans = _answers(JExecutor(jh))
    jh.close()
    th = Holder(path).open()
    try:
        t_ans = _answers(Executor(th, device="cpu"))
        assert t_ans == j_ans
        f = th.index("i").field("t")
        assert f.options.type == "time" and f.options.time_quantum == "YMD"
        assert "standard_201902" in f.views and "standard_20190115" in f.views
        assert th.index("i").field("m").options.type == "mutex"
        assert th.index("i").field("b").options.type == "bool"
        assert sorted(os.listdir(os.path.join(path, "i", "t", "views")))[0] \
            == "standard"
    finally:
        th.close()
