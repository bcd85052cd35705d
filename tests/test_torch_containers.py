"""The port's container stores against the JAX package's.

storage/containers.py is a copy of the JAX module: the B+Tree is driven
here by the JAX suite's cases (tests/test_containers.py) and checked
key for key against a dict. The port's Bitmap takes either store through
`store=` or PILOSA_TPU_CONTAINER_STORE; the roaring behaviour suite runs
over both, derived bitmaps keep their source's kind, and a bitmap or a
fragment file serializes to the JAX package's bytes whichever store
holds the containers.
"""

import io
import os

import numpy as np
import pytest

from pilosa_tpu.storage.fragment import Fragment as JaxFragment
from pilosa_tpu.storage.roaring import Bitmap as JaxBitmap
from pilosa_tpu_torch.storage.containers import (
    BTreeContainers,
    make_container_store,
    resolve_store_kind,
)
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.roaring import Bitmap


@pytest.fixture(params=["dict", "btree"])
def store(request):
    return request.param


def test_btree_basic_mapping():
    t = BTreeContainers()
    assert len(t) == 0 and not list(t)
    t[5], t[1], t[9] = "a", "b", "c"
    assert list(t) == [1, 5, 9]
    assert t[5] == "a" and t.get(7) is None and 9 in t and 7 not in t
    t[5] = "a2"
    assert len(t) == 3 and t[5] == "a2"
    del t[5]
    assert list(t) == [1, 9] and 5 not in t
    with pytest.raises(KeyError):
        _ = t[5]
    with pytest.raises(KeyError):
        del t[5]
    assert t.pop(1) == "b"
    assert list(t.items()) == [(9, "c")]


def test_btree_fuzz_against_a_dict():
    rng = np.random.default_rng(42)
    t, model = BTreeContainers(), {}
    for step in range(20_000):
        op, key = rng.integers(0, 10), int(rng.integers(0, 500))
        if op < 5:
            t[key] = model[key] = step
        elif op < 8:
            if key in model:
                del t[key], model[key]
            else:
                assert key not in t
        else:
            assert t.get(key) == model.get(key)
        if step % 2500 == 0:
            assert list(t) == sorted(model) and len(t) == len(model)
    assert [t[k] for k in sorted(model)] == [model[k] for k in sorted(model)]


def test_btree_splits_ranges_and_drains():
    rng = np.random.default_rng(7)
    keys = [int(k) for k in rng.permutation(100_000)[:30_000]]
    t = BTreeContainers((k, k * 2) for k in keys)
    expect = sorted(keys)
    assert list(t) == expect and len(t) == len(expect)
    assert t.first_key() == expect[0] and t.last_key() == expect[-1]
    lo, hi = expect[100], expect[5000]
    assert list(t.irange(lo, hi)) == [k for k in expect if lo <= k <= hi]
    assert list(t.irange(10 ** 9, 10 ** 9 + 5)) == []
    for k in expect[::3]:
        del t[k]
    rest = [k for i, k in enumerate(expect) if i % 3]
    assert list(t) == rest and list(t.values())[:5] == [k * 2
                                                      for k in rest[:5]]
    for k in reversed(rest):
        del t[k]
    assert len(t) == 0 and list(t) == []
    with pytest.raises(ValueError):
        t.first_key()


def test_btree_numpy_integer_keys():
    t = BTreeContainers()
    t[np.uint64(5)] = "a"
    assert np.uint64(5) in t and 5 in t and t[5] == "a"
    t[5] = "b"
    assert len(t) == 1 and t[np.uint64(5)] == "b"
    del t[np.uint64(5)]
    assert len(t) == 0 and "not-a-key" not in t


def test_store_selection(monkeypatch):
    assert isinstance(make_container_store("dict"), dict)
    assert isinstance(make_container_store("btree"), BTreeContainers)
    monkeypatch.setenv("PILOSA_TPU_CONTAINER_STORE", "btree")
    assert resolve_store_kind(None) == "btree"
    assert isinstance(Bitmap([1, 2, 3]).containers, BTreeContainers)
    assert isinstance(Bitmap(store="dict").containers, dict)
    monkeypatch.delenv("PILOSA_TPU_CONTAINER_STORE")
    assert isinstance(make_container_store(), dict)
    with pytest.raises(ValueError, match="unknown container store"):
        make_container_store("bogus")


def test_bitmap_ops_over_each_store_equal_jax(store):
    rng = np.random.default_rng(3)
    a_vals = rng.choice(1 << 22, size=5000, replace=False).astype(np.uint64)
    b_vals = rng.choice(1 << 22, size=5000, replace=False).astype(np.uint64)
    # a run-heavy range and a dense container beside the sparse values
    a_vals = np.concatenate([a_vals, np.arange(1 << 23, (1 << 23) + 9000,
                                               dtype=np.uint64)])
    b_vals = np.concatenate([b_vals, np.arange((1 << 23) + 4000,
                                               (1 << 23) + 70000, 3,
                                               dtype=np.uint64)])
    a, b = Bitmap(a_vals, store=store), Bitmap(b_vals, store=store)
    ja, jb = JaxBitmap(a_vals), JaxBitmap(b_vals)
    sa, sb = set(map(int, a_vals)), set(map(int, b_vals))
    assert a.count() == len(sa) and set(a) == sa
    assert list(a) == sorted(sa)
    assert a.intersection_count(b) == len(sa & sb) == \
        ja.intersection_count(jb)
    for op, want in (("intersect", sa & sb), ("union", sa | sb),
                     ("difference", sa - sb), ("xor", sa ^ sb)):
        got = getattr(a, op)(b)
        assert got.store_kind == store
        assert set(got) == want
        assert got.count() == getattr(ja, op)(jb).count()
    assert (a.min(), a.max()) == (min(sa), max(sa)) == (ja.min(), ja.max())
    assert Bitmap(store=store).min() is None
    a.check()


def test_bitmap_mutation_and_bytes_equal_jax(store):
    rng = np.random.default_rng(5)
    vals = rng.choice(1 << 20, size=3000, replace=False).astype(np.uint64)
    bm, jb = Bitmap(vals, store=store), JaxBitmap(vals)
    model = set(map(int, vals))
    for v in (0, 1, 12345, 1 << 19):
        assert bm.add(v) == (v not in model) == jb.add(v)
        model.add(v)
    for v in sorted(model)[:50]:
        assert bm.remove(v) and jb.remove(v)
        model.discard(v)
    assert set(bm) == model
    bm.optimize()
    jb.optimize()
    assert bm.to_bytes() == jb.to_bytes()
    assert set(Bitmap.from_bytes(bm.to_bytes())) == model
    dense = np.arange(100_000, dtype=np.uint64)
    d, jd = Bitmap(dense, store=store), JaxBitmap(dense)
    d.optimize()
    jd.optimize()
    assert d.to_bytes() == jd.to_bytes()
    assert Bitmap.from_bytes(d.to_bytes()).count() == 100_000


def test_both_stores_write_the_same_snapshot(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 40, 20_000)
    cols = rng.integers(0, 1 << 20, 20_000)
    files = {}
    for store in ("dict", "btree"):
        monkeypatch.setenv("PILOSA_TPU_CONTAINER_STORE", store)
        f = Fragment(str(tmp_path / store), "i", "f", "standard", 0).open()
        assert f.storage.store_kind == store
        f.bulk_import(rows.tolist(), cols.tolist())
        for c in range(0, 3000, 7):
            f.set_bit(41, c)
        f.snapshot()
        f.close()
        files[store] = open(str(tmp_path / store), "rb").read()
    monkeypatch.delenv("PILOSA_TPU_CONTAINER_STORE")
    j = JaxFragment(str(tmp_path / "jax"), "i", "f", "standard", 0).open()
    j.bulk_import(rows.tolist(), cols.tolist())
    for c in range(0, 3000, 7):
        j.set_bit(41, c)
    j.snapshot()
    j.close()
    files["jax"] = open(str(tmp_path / "jax"), "rb").read()
    assert files["dict"] == files["btree"] == files["jax"]


def test_fragment_lifecycle_under_the_btree_store(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_CONTAINER_STORE", "btree")
    f = Fragment(str(tmp_path / "bt"), "i", "f", "standard", 0).open()
    assert isinstance(f.storage.containers, BTreeContainers)
    f.bulk_import([0, 0, 1], [5, 9, 9])
    f.set_bit(2, 123)
    f.set_bit(2, 124)
    assert f.row_counts([0, 1, 2]).tolist() == [2, 1, 2]
    assert f.row_ids() == [0, 1, 2]
    assert f.rows_for_column(9) == [0, 1]
    f.close()
    f2 = Fragment(str(tmp_path / "bt"), "i", "f", "standard", 0).open()
    assert isinstance(f2.storage.containers, BTreeContainers)
    assert f2.row_counts([0, 1, 2]).tolist() == [2, 1, 2]
    assert f2.row_columns(2).tolist() == [123, 124]
    dense = f2.row_dense(2)
    assert int(np.unpackbits(dense.view(np.uint8)).sum()) == 2
    f2.clear_bit(2, 123)
    f2.snapshot()
    f2.close()
    j = JaxFragment(str(tmp_path / "bt"), "i", "f", "standard", 0).open()
    assert sorted(j.row_columns(2)) == [124]
    j.close()


def test_keys_in_walks_the_btree():
    vals = np.array([7, 1 << 17, (5 << 16) + 9, 1 << 21], dtype=np.uint64)
    bm = Bitmap(vals, store="btree")
    assert bm.min() == 7 and bm.max() == 1 << 21
    assert bm._keys_in(0, 1 << 18) == [0, 2]
    assert bm._keys_in(5 << 16, (5 << 16) + 10) == [5]
    assert bm._keys_in(10, 10) == []
    assert bm._keys_in(0, 1 << 30) == [0, 2, 5, 32]
    assert bm.slice(0, 1 << 30).tolist() == sorted(vals.tolist())
    buf = io.BytesIO()
    bm.write_snapshot(buf)
    assert Bitmap.from_bytes(buf.getvalue()).positions().tolist() == \
        sorted(vals.tolist())


def test_reset_keeps_the_store_kind():
    bm = Bitmap(np.arange(10, dtype=np.uint64), store="btree")
    bm.reset(np.array([3, 70000], dtype=np.uint64))
    assert isinstance(bm.containers, BTreeContainers)
    assert bm.positions().tolist() == [3, 70000]


def test_check_finds_what_the_jax_check_finds():
    from pilosa_tpu_torch.storage.roaring import Container

    bm = Bitmap(store="dict")
    bm.containers[0] = Container("array", np.array([3, 2], dtype=np.uint16))
    with pytest.raises(ValueError, match="unsorted/duplicate"):
        bm.check()
    bm.containers[0] = Container("run", np.array([[1, 5], [6, 9]],
                                                 dtype=np.uint16))
    with pytest.raises(ValueError, match="adjacent runs"):
        bm.check()
    assert os.environ.get("PILOSA_TPU_CONTAINER_STORE", "dict") == "dict"
