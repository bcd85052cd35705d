"""The port's frozen store and frozen bulk loads against the JAX package.

The same seeded numpy positions go through pilosa_tpu/storage/frozen.py and
pilosa_tpu_torch/storage/frozen.py (and the fragments, views and fields
above them): the flat arrays, the materialized containers and their kinds,
the copy-on-write overlay under a mutation fuzz, the snapshot bytes, the
frozen parse in both directions, the loads' row counts, row ids, rank
caches and values, the volatility contract, and rows_intersection_counts.
Everything compared is an integer or a byte: the tolerance is 0.
"""

import io

import numpy as np
import pytest

import pilosa_tpu.storage.frozen as jfz
import pilosa_tpu_torch.storage.frozen as tfz
from pilosa_tpu.models import FieldOptions as JFieldOptions
from pilosa_tpu.models import Holder as JHolder
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu.storage.roaring import Bitmap as JBitmap
from pilosa_tpu.storage.roaring import Container as JContainer
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.roaring import Bitmap, Container


def _positions(shape: str, seed: int = 3) -> np.ndarray:
    """Sorted unique uint64 positions of one of four shapes."""
    rng = np.random.default_rng(seed)
    if shape == "empty":
        return np.empty(0, np.uint64)
    if shape == "sparse":  # array containers
        return np.unique(rng.integers(0, 50 << 16, 5000).astype(np.uint64))
    if shape == "dense":  # bitmap containers among array ones
        a = rng.integers(0, 30 << 16, 20_000).astype(np.uint64)
        b = (np.uint64(31 << 16)
             + rng.integers(0, 30_000, 20_000).astype(np.uint64))
        return np.unique(np.concatenate([a, b]))
    # runny: a full container, a sequential stretch, a sparse tail, and
    # one container that is big, runny and broken in a few places
    full = np.arange(65536, dtype=np.uint64)
    seq = np.arange(65536, 65536 + 5000, dtype=np.uint64)
    sparse = np.uint64(2) << np.uint64(16) | np.arange(0, 60000, 13,
                                                       dtype=np.uint64)
    broken = np.setdiff1d(np.arange(5 << 16, 6 << 16, dtype=np.uint64),
                          rng.integers(5 << 16, 6 << 16, 20).astype(np.uint64))
    return np.unique(np.concatenate([full, seq, sparse, broken]))


SHAPES = ("empty", "sparse", "dense", "runny")


def _same_container(a, b, where) -> None:
    assert a.kind == b.kind, where
    np.testing.assert_array_equal(a.data, b.data, err_msg=str(where))


def _same_store(t, j) -> None:
    """Flat arrays, overlay, deletions, and every materialized container."""
    for name in ("_keys", "_starts", "_ends"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_array_equal(t._lows[t._starts.min(initial=0):],
                                  j._lows[j._starts.min(initial=0):])
    assert t._deleted == j._deleted
    assert sorted(t._overlay) == sorted(j._overlay)
    assert list(t) == list(j) and len(t) == len(j) and bool(t) == bool(j)
    for k in j:
        _same_container(t[k], j[k], k)
    tk, tn = t.key_and_count_arrays()
    jk, jn = j.key_and_count_arrays()
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tn, jn)
    assert t.total_count() == j.total_count()
    np.testing.assert_array_equal(t.all_positions(), j.all_positions())
    if len(j):
        assert t.first_key() == j.first_key()
        assert t.last_key() == j.last_key()


@pytest.mark.parametrize("shape", SHAPES)
def test_from_positions_matches_jax(shape):
    pos = _positions(shape)
    t = tfz.FrozenContainers.from_positions(pos)
    j = jfz.FrozenContainers.from_positions(pos)
    _same_store(t, j)
    kinds = {t[k].kind for k in t}
    want = {"empty": set(), "sparse": {"array"},
            "dense": {"array", "bitmap"}, "runny": {"run", "bitmap"}}[shape]
    assert kinds == want
    probe = np.concatenate([pos[::7], pos[::11] + np.uint64(1),
                            np.array([0, 70000, 1 << 40], np.uint64)])
    np.testing.assert_array_equal(t.contains_positions(probe),
                                  j.contains_positions(probe))


@pytest.mark.parametrize("seed", range(4))
def test_cow_overlay_fuzz_matches_jax(seed):
    """Seeded set/delete/pop/get/irange over base and overlay keys, on
    both stores (tests/test_frozen.py:329-360)."""
    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(0, 40 << 16, 10_000).astype(np.uint64))
    t = tfz.FrozenContainers.from_positions(pos)
    j = jfz.FrozenContainers.from_positions(pos)
    for i in range(400):
        op = int(rng.integers(0, 5))
        key = int(rng.integers(0, 44))
        if op == 0:
            vals = np.unique(rng.integers(0, 65536, int(rng.integers(1, 6000)))
                             ).astype(np.uint16)
            t[key] = Container.from_values(vals)
            j[key] = JContainer.from_values(vals)
        elif op == 1:
            a, b = t.get(key), j.get(key)
            assert (a is None) == (b is None), (i, key)
            if a is not None:
                _same_container(a, b, (i, key))
        elif op == 2:
            assert (key in t) == (key in j)
            if key in j:
                del t[key]
                del j[key]
        elif op == 3:
            a, b = t.pop(key), j.pop(key)
            assert (a is None) == (b is None), (i, key)
        else:
            assert list(t.irange(key, key + 5)) == list(j.irange(key, key + 5))
        assert len(t) == len(j) and bool(t) == bool(j)
    _same_store(t, j)
    probe = np.unique(rng.integers(0, 44 << 16, 3000).astype(np.uint64))
    np.testing.assert_array_equal(t.contains_positions(probe),
                                  j.contains_positions(probe))


def _mutate(b, rng_seed: int) -> None:
    """Bitmap-level writes after the freeze: adds into base and new keys,
    removes that empty some containers."""
    rng = np.random.default_rng(rng_seed)
    b.add_many(np.unique(rng.integers(0, 60 << 16, 300).astype(np.uint64)))
    b.add_many(np.arange(70 << 16, (70 << 16) + 9000, dtype=np.uint64))
    some = b.slice(0, 4 << 16)
    b.remove_many(some)  # whole containers deleted
    b.remove_many(np.unique(rng.integers(0, 60 << 16, 2000)
                            .astype(np.uint64)))
    b.add(int(rng.integers(80 << 16, 81 << 16)))
    b.remove(int(b.slice(5 << 16, 6 << 16)[0]) if b.slice(5 << 16, 6 << 16).size
             else 5 << 16)


@pytest.mark.parametrize("mutated", (False, True), ids=("plain", "overlay"))
@pytest.mark.parametrize("shape", SHAPES)
def test_write_pilosa_bytes_match_jax(shape, mutated):
    pos = _positions(shape, seed=7)
    t, j = Bitmap.frozen(pos), JBitmap.frozen(pos)
    if mutated:
        _mutate(t, 11)
        _mutate(j, 11)
        # an empty base has nothing to delete
        assert t.containers._overlay
        assert bool(t.containers._deleted) == (shape != "empty")
    np.testing.assert_array_equal(t.positions(), j.positions())
    assert t.count() == j.count()
    tb, jb = io.BytesIO(), io.BytesIO()
    assert t.write_to(tb) == j.write_to(jb)
    assert tb.getvalue() == jb.getvalue()
    tb, jb = io.BytesIO(), io.BytesIO()
    t.write_snapshot(tb)
    j.write_snapshot(jb)
    assert tb.getvalue() == jb.getvalue()


@pytest.mark.parametrize("writer", ("port", "jax"))
@pytest.mark.parametrize("shape", ("sparse", "dense", "runny"))
def test_frozen_parse_roundtrip_both_ways(shape, writer, monkeypatch):
    """A snapshot written by either package parses through the other's
    frozen parse (FROZEN_PARSE_MIN made small on both sides) into the same
    store, op-log records replaying into the overlay."""
    monkeypatch.setattr(tfz, "FROZEN_PARSE_MIN", 4)
    monkeypatch.setattr(jfz, "FROZEN_PARSE_MIN", 4)
    pos = _positions(shape, seed=13)
    src = (Bitmap if writer == "port" else JBitmap).frozen(pos)
    buf = io.BytesIO()
    src.write_snapshot(buf)
    data = buf.getvalue()
    t = Bitmap.from_bytes(data)
    j = JBitmap.from_bytes(data, lazy=True)
    assert isinstance(t.containers, tfz.FrozenContainers)
    assert isinstance(j.containers, jfz.FrozenContainers)
    _same_store(t.containers, j.containers)
    np.testing.assert_array_equal(t.positions(), pos)
    # writes on the parsed stores serialize alike again
    for b in (t, j):
        b.add_many(np.array([3, 9 << 16, (90 << 16) + 1], np.uint64))
    tb, jb = io.BytesIO(), io.BytesIO()
    t.write_to(tb)
    j.write_to(jb)
    assert tb.getvalue() == jb.getvalue()
    # the parsed views hold the buffer alive on their own
    del data, buf, src
    np.testing.assert_array_equal(t.positions(), j.positions())


def test_dict_store_parse_below_threshold():
    """Under FROZEN_PARSE_MIN containers a file parses into a dict."""
    pos = _positions("sparse")
    b = Bitmap.from_bytes(_bytes(Bitmap.frozen(pos)))
    assert isinstance(b.containers, dict)
    np.testing.assert_array_equal(b.positions(), pos)


def _bytes(b) -> bytes:
    buf = io.BytesIO()
    b.write_to(buf)
    return buf.getvalue()


# -- fragments --------------------------------------------------------------


def _frag_positions(seed: int, n_rows: int = 400, n: int = 20_000):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n).astype(np.uint64)
    cols = rng.integers(0, SHARD_WIDTH, n).astype(np.uint64)
    rows[: n // 5] = 3  # a heavy row with bitmap containers
    cols[: n // 5] = rng.integers(0, 1 << 16, n // 5)
    run = np.uint64(7 * SHARD_WIDTH) + np.arange(100_000, 170_000,
                                                 dtype=np.uint64)
    return np.unique(np.concatenate(
        [rows * np.uint64(SHARD_WIDTH) + cols, run]))


def _twins(tmp_path, pos):
    t = Fragment(str(tmp_path / "t" / "0"), "i", "f", "standard", 0).open()
    j = JFragment(str(tmp_path / "j" / "0"), "i", "f", "standard", 0).open()
    t.import_frozen(pos)
    j.import_frozen(pos)
    return t, j


ROW_PROBES = [0, 3, 5, 7, 11, 399, 400, 10_000]


def _same_reads(t, j) -> None:
    np.testing.assert_array_equal(t.row_counts(ROW_PROBES),
                                  j.row_counts(ROW_PROBES))
    assert t.row_ids() == j.row_ids()
    assert t.row_ids(start=5, limit=7) == j.row_ids(start=5, limit=7)
    assert t.bit_count() == j.bit_count()
    for r in ROW_PROBES:
        assert t.row_cardinality(r) == j.row_cardinality(r), r
        assert t.row_generation(r) == j.row_generation(r), r
        np.testing.assert_array_equal(t.row_runs(r), j.row_runs(r))
        assert t.row_run_stats(r) == j.row_run_stats(r), r
        assert t.row_interval_count(r) == j.row_runs(r).shape[0], r
        np.testing.assert_array_equal(t.row_dense(r), j.row_dense(r))
        np.testing.assert_array_equal(t.row_columns(r), j.row_columns(r))
    for c in (0, 5, 99_999, 100_000, SHARD_WIDTH - 1):
        assert t.rows_for_column(c) == j.rows_for_column(c), c


@pytest.mark.parametrize("seed", range(2))
def test_fragment_reads_over_a_frozen_store_match_jax(tmp_path, seed):
    t, j = _twins(tmp_path, _frag_positions(seed))
    try:
        assert t.frozen and isinstance(t.storage.containers,
                                       tfz.FrozenContainers)
        _same_reads(t, j)
        # writes after the freeze: per bit, and a batch
        for frag in (t, j):
            frag.set_bit(3, 5)
            frag.clear_bit(7, 100_500)
            frag.set_bit(10_000, 12)
            frag.apply_batch([(True, 5, 77), (False, 3, 5), (True, 400, 1),
                              (True, 7, 100_500)])
        _same_reads(t, j)
        with pytest.raises(ValueError):
            t.import_frozen(_frag_positions(seed))
    finally:
        t.close()
        j.close()


def test_volatility_contract_matches_jax(tmp_path):
    """No WAL and no automatic snapshot while volatile; every write taken
    is counted as the JAX fragment counts it; a restart before a snapshot
    finds the fragment empty; snapshot() makes it durable, re-attaches the
    WAL and clears the count (tests/test_frozen.py:301-326)."""
    pos = np.arange(0, 3000, 3, dtype=np.uint64)
    t, j = _twins(tmp_path, pos)
    for frag in (t, j):
        assert frag.storage.op_writer is None and frag._volatile
        frag.set_bit(0, 1)
        frag.clear_bit(0, 3)
        frag.clear_bit(0, 4)  # unchanged: not counted
        frag.apply_batch([(True, 2, 5), (True, 2, 6), (False, 2, 5),
                          (True, 0, 0)])
        frag.bulk_import([4, 4, 5], [1, 2, 3])
    assert t.volatile_mutations == j.volatile_mutations > 0
    assert t.op_n == j.op_n == 2 + 1  # per-bit ops count; the batch none
    n = t.bit_count()
    assert n == j.bit_count()
    for frag, cls in ((t, Fragment), (j, JFragment)):
        path = frag.path
        frag.close()
        again = cls(path, "i", "f", "standard", 0).open()
        assert again.bit_count() == 0  # not a one-op corpse
        again.import_frozen(pos)
        again.snapshot()
        assert not again._volatile and again.volatile_mutations == 0
        assert again.storage.op_writer is not None
        again.set_bit(0, 1)  # logged now
        again.close()
        back = cls(path, "i", "f", "standard", 0).open()
        assert back.bit_count() == pos.size + 1
        back.close()


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_frozen_snapshot_opens_in_the_other_package(tmp_path, monkeypatch,
                                                    writer):
    """A fragment snapshotted from one package's frozen store opens in the
    other through the frozen parse and answers the same; a WAL record
    appended after the snapshot replays in both."""
    monkeypatch.setattr(tfz, "FROZEN_PARSE_MIN", 4)
    monkeypatch.setattr(jfz, "FROZEN_PARSE_MIN", 4)
    pos = _frag_positions(5)
    path = str(tmp_path / "frag" / "0")
    cls = Fragment if writer == "port" else JFragment
    w = cls(path, "i", "f", "standard", 0).open()
    w.import_frozen(pos)
    w.set_bit(2, 3)
    w.snapshot()
    w.set_bit(9, 99)  # WAL after the snapshot
    w.close()
    t = Fragment(path, "i", "f", "standard", 0).open()
    try:
        assert isinstance(t.storage.containers, tfz.FrozenContainers)
        t_snapshot = {r: t.row_columns(r) for r in ROW_PROBES + [2, 9]}
        np.testing.assert_array_equal(
            t.storage.positions(),
            np.union1d(pos, np.array([2 * SHARD_WIDTH + 3,
                                      9 * SHARD_WIDTH + 99], np.uint64)))
    finally:
        t.close()
    j = JFragment(path, "i", "f", "standard", 0).open()
    try:
        for r, cols in t_snapshot.items():
            np.testing.assert_array_equal(j.row_columns(r), cols)
    finally:
        j.close()


def test_rows_intersection_counts_matches_jax(tmp_path):
    pos = _frag_positions(9)
    t, j = _twins(tmp_path, pos)
    d = Fragment(str(tmp_path / "d" / "0"), "i", "f", "standard", 0).open()
    d.bulk_import(pos // np.uint64(SHARD_WIDTH), pos % np.uint64(SHARD_WIDTH))
    try:
        rng = np.random.default_rng(9)
        # row 7's run containers went to the overlay at the freeze
        rows = np.array(sorted(({0, 3, 11, 399, 5000}
                                | set(rng.integers(0, 400, 50).tolist()))
                               - {7}))
        src = np.unique(rng.integers(0, SHARD_WIDTH, 30_000))
        src = np.union1d(src, t.row_columns(3)[::3])
        got = t.rows_intersection_counts(rows, src)
        np.testing.assert_array_equal(got,
                                      j.rows_intersection_counts(rows, src))
        brute = [np.intersect1d(t.row_columns(int(r)), src).size
                 for r in rows]
        np.testing.assert_array_equal(got, brute)
        empty = np.empty(0, np.int64)
        np.testing.assert_array_equal(t.rows_intersection_counts(rows, empty),
                                      np.zeros(rows.size, np.int64))
        # the None cases: a dict store; a candidate the overlay touched
        assert d.rows_intersection_counts(rows, src) is None
        assert t.rows_intersection_counts([3, 7], src) is None
        assert j.rows_intersection_counts([3, 7], src) is None
        for frag in (t, j):
            frag.set_bit(11, 12345)
        assert t.rows_intersection_counts(rows, src) is None
        assert j.rows_intersection_counts(rows, src) is None
        # untouched candidates still count; an empty src is zeros first
        rest = rows[rows != 11]
        np.testing.assert_array_equal(t.rows_intersection_counts(rest, src),
                                      j.rows_intersection_counts(rest, src))
        np.testing.assert_array_equal(t.rows_intersection_counts(rows, empty),
                                      j.rows_intersection_counts(rows, empty))
    finally:
        for frag in (t, j, d):
            frag.close()


# -- the loads ---------------------------------------------------------------


def _holders(tmp_path):
    return (Holder(str(tmp_path / "t")).open(),
            JHolder(str(tmp_path / "j")).open())


@pytest.mark.parametrize("cache_size", (50, 100_000))
def test_import_rows_frozen_matches_jax(tmp_path, cache_size):
    """Row counts, row ids, shards and the rank caches, the same rows in a
    full cache as in the JAX package (its np.argpartition)."""
    rng = np.random.default_rng(23)
    n_rows, n_bits = 2000, 60_000
    rows = rng.integers(0, n_rows, n_bits).astype(np.uint64)
    cols = rng.integers(0, 3 * SHARD_WIDTH, n_bits).astype(np.uint64)
    rows[: n_bits // 4] = rng.integers(0, 20, n_bits // 4)
    th, jh = _holders(tmp_path)
    try:
        tf = th.create_index("i", track_existence=False).create_field(
            "f", FieldOptions(cache_size=cache_size))
        jf = jh.create_index("i", track_existence=False).create_field(
            "f", JFieldOptions(cache_size=cache_size))
        tf.import_rows_frozen(rows, cols)
        jf.import_rows_frozen(rows, cols)
        assert tf.shards() == sorted(jf.available_shards.slice().tolist())
        tv, jv = tf.view("standard"), jf.view("standard")
        assert tv.shards() == jv.shards() == [0, 1, 2]
        for s in tv.shards():
            a, b = tv.fragment(s), jv.fragment(s)
            assert a.frozen and a._volatile
            ids = np.arange(n_rows + 5)
            np.testing.assert_array_equal(a.row_counts(ids), b.row_counts(ids))
            assert a.row_ids() == b.row_ids()
            assert a.row_ids(start=100, limit=10) == \
                b.row_ids(start=100, limit=10)
            assert tv.rank_caches[s].counts == jv.rank_caches[s].counts
        with pytest.raises(ValueError):
            th.index("i").create_field(
                "v", FieldOptions(type="int", max=9)).import_rows_frozen(
                    [1], [2])
    finally:
        th.close()
        jh.close()


@pytest.mark.parametrize("lo", (0, -50))
def test_import_values_frozen_matches_jax(tmp_path, lo):
    """The planes per shard, last write wins on duplicate columns, values
    read back, and the refusal on a set field."""
    rng = np.random.default_rng(41)
    n = 2 * SHARD_WIDTH + 999
    cols = rng.choice(3 * SHARD_WIDTH, n, replace=False).astype(np.uint64)
    vals = rng.integers(lo, lo + 250, n).astype(np.int64)
    # duplicates: the later value of a column wins
    cols = np.concatenate([cols, cols[:50]])
    vals = np.concatenate([vals, vals[:50][::-1]])
    last = int(vals[n])  # the value column cols[0] ends with
    th, jh = _holders(tmp_path)
    try:
        tv = th.create_index("i", track_existence=False).create_field(
            "v", FieldOptions(type="int", min=lo, max=lo + 249))
        jv = jh.create_index("i", track_existence=False).create_field(
            "v", JFieldOptions(type="int", min=lo, max=lo + 249))
        tv.import_values_frozen(cols, vals)
        jv.import_values_frozen(cols, vals)
        a, b = tv.views[tv.bsi_view_name], jv.views[jv.bsi_view_name]
        assert a.shards() == b.shards() == [0, 1, 2]
        for s in a.shards():
            np.testing.assert_array_equal(a.fragment(s).storage.positions(),
                                          b.fragment(s).storage.positions())
            assert a.fragment(s).frozen
        for c in cols[:5].tolist() + cols[-5:].tolist():
            assert tv.value(int(c)) == jv.value(int(c)), c
        assert tv.value(int(cols[0])) == (last, True)
        with pytest.raises(ValueError):
            th.index("i").create_field("s").import_values_frozen([1], [2])
        with pytest.raises(ValueError, match="out of range"):
            tv.import_values_frozen([1], [lo + 250])
    finally:
        th.close()
        jh.close()
