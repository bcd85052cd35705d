"""On-disk compatibility of the port's storage with the JAX package.

Fragments and whole holders written by one package open in the other with
the same bits: WAL records (framed single-bit writes and the ingest group
commit), snapshots with their integrity trailer, a WAL appended after a
snapshot, and a torn WAL tail.
"""

import os

import numpy as np
import pytest

from pilosa_tpu.models import FieldOptions as JaxFieldOptions
from pilosa_tpu.models import Holder as JaxHolder
from pilosa_tpu.storage.fragment import Fragment as JaxFragment
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.roaring import Bitmap, CorruptionError

ROWS = (0, 1, 5, 77)


def _traffic(rng, n: int = 300):
    """(op, row, col) mutations over a few rows, mixed set and clear."""
    rows = rng.choice(ROWS, size=n)
    cols = rng.integers(0, 1 << 20, size=n)
    cols[: n // 3] = rng.integers(0, 70000, size=n // 3)  # dense containers
    ops = rng.random(n) < 0.8
    return [(bool(o), int(r), int(c)) for o, r, c in zip(ops, rows, cols)]


def _bulk(rng, n: int = 20000):
    rows = rng.choice(ROWS, size=n).astype(np.uint64)
    cols = rng.integers(0, 1 << 20, size=n).astype(np.uint64)
    cols[: n // 2] = rng.integers(0, 3 << 16, size=n // 2)  # bitmap containers
    run = np.arange(200000, 260000, dtype=np.uint64)  # a run container
    return (np.concatenate([rows, np.full(run.size, 5, np.uint64)]),
            np.concatenate([cols, run]))


def _rows(frag) -> dict:
    return {r: frag.row_dense(r) for r in ROWS}


def _assert_same(a: dict, b: dict) -> None:
    for r in ROWS:
        np.testing.assert_array_equal(a[r], b[r], err_msg=f"row {r}")


def _write(frag, rng, with_batch: bool) -> None:
    """WAL writes, a bulk import (snapshot), then WAL writes after it."""
    for is_set, r, c in _traffic(rng):
        (frag.set_bit if is_set else frag.clear_bit)(r, c)
    frag.bulk_import(*_bulk(rng))
    muts = _traffic(rng, 200)
    if with_batch:
        frag.apply_batch(muts)  # the JAX ingest group commit
    else:
        for is_set, r, c in muts:
            (frag.set_bit if is_set else frag.clear_bit)(r, c)
    rows, cols = _bulk(rng, 3000)
    frag.bulk_clear(rows[:1000], cols[:1000])
    for is_set, r, c in _traffic(rng, 50):
        (frag.set_bit if is_set else frag.clear_bit)(r, c)


@pytest.mark.parametrize("with_batch", [False, True])
def test_port_reads_fragments_the_jax_package_wrote(tmp_path, with_batch):
    path = str(tmp_path / "frag" / "0")
    jax_frag = JaxFragment(path, "i", "f", "standard", 0).open()
    _write(jax_frag, np.random.default_rng(1), with_batch)
    want = _rows(jax_frag)
    jax_frag.close()
    frag = Fragment(path, "i", "f", "standard", 0).open()
    _assert_same(_rows(frag), want)
    frag.close()


def test_jax_package_reads_fragments_the_port_wrote(tmp_path):
    path = str(tmp_path / "frag" / "3")
    frag = Fragment(path, "i", "f", "standard", 3).open()
    _write(frag, np.random.default_rng(2), with_batch=False)
    want = _rows(frag)
    frag.close()
    jax_frag = JaxFragment(path, "i", "f", "standard", 3).open()
    _assert_same(_rows(jax_frag), want)
    assert jax_frag.wal_truncated_bytes == 0
    jax_frag.close()


def test_wal_compaction_past_max_op_n_reads_back(tmp_path):
    """More than MAX_OP_N single-bit writes snapshot mid-stream."""
    path = str(tmp_path / "frag" / "0")
    frag = Fragment(path, "i", "f", "standard", 0).open()
    rng = np.random.default_rng(3)
    for c in rng.integers(0, 1 << 20, size=2100):
        frag.set_bit(1, int(c))
    assert frag.op_n < 2100
    want = _rows(frag)
    frag.close()
    jax_frag = JaxFragment(path, "i", "f", "standard", 0).open()
    _assert_same(_rows(jax_frag), want)
    jax_frag.close()


def test_torn_wal_tail_is_truncated(tmp_path):
    path = str(tmp_path / "frag" / "0")
    jax_frag = JaxFragment(path, "i", "f", "standard", 0).open()
    for c in (1, 2, 3):
        jax_frag.set_bit(0, c)
    jax_frag.close()
    with open(path, "ab") as f:
        f.write(b"\xfa\x01\x00\x01")  # a torn framed record
    frag = Fragment(path, "i", "f", "standard", 0).open()
    assert frag.row_columns(0).tolist() == [1, 2, 3]
    assert frag.wal_truncated_bytes == 4
    frag.close()
    jax_frag = JaxFragment(path, "i", "f", "standard", 0).open()
    assert jax_frag.row_columns(0).tolist() == [1, 2, 3]
    jax_frag.close()


def test_damaged_snapshot_raises(tmp_path):
    path = str(tmp_path / "frag" / "0")
    frag = Fragment(path, "i", "f", "standard", 0).open()
    frag.bulk_import([0, 0], [5, 9])
    frag.close()
    data = bytearray(open(path, "rb").read())
    data[-29] ^= 0xFF  # last payload byte, just before the trailer
    with pytest.raises(CorruptionError):
        Bitmap.from_bytes(bytes(data))


def _holder_contents(h) -> dict:
    out = {}
    for iname, idx in h.indexes.items():
        for fname, f in idx.fields.items():
            out[(iname, fname, "opts")] = (f.options.type, f.options.cache_type)
            out[(iname, fname, "shards")] = sorted(f.shards())
            view = f.view("standard")
            for shard in ([] if view is None else view.shards()):
                frag = view.fragment(shard)
                for r in frag.row_ids():
                    out[(iname, fname, shard, r)] = \
                        frag.row_columns(r).tolist()
    return out


def test_holders_open_each_others_data_dirs(tmp_path):
    rng = np.random.default_rng(4)
    cols = rng.integers(0, 5 << 20, size=5000)
    rows = rng.integers(0, 4, size=5000)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")

    jh = JaxHolder(jdir).open()
    idx = jh.create_index("i", track_existence=True)
    f = idx.create_field("f", JaxFieldOptions())
    f.import_bits(rows.tolist(), cols.tolist())
    idx.existence_field().import_bits([0] * cols.size, cols.tolist())
    f.set_bit(9, 123)
    want = _holder_contents(jh)
    jh.close()
    th = Holder(jdir).open()
    assert _holder_contents(th) == want
    th.close()

    th = Holder(tdir).open()
    idx = th.create_index("i", track_existence=True)
    f = idx.create_field("f")
    f.import_bits(rows, cols)
    idx.mark_exists(cols)
    f.set_bit(9, 123)
    want_t = _holder_contents(th)
    th.close()
    assert want_t == want
    jh = JaxHolder(tdir).open()
    assert _holder_contents(jh) == want_t
    assert os.path.exists(os.path.join(tdir, "i", "f", ".available.shards"))
    jh.close()


def test_state_planes_roundtrip_bit_for_bit():
    from pilosa_tpu_torch import state

    words = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], dtype=np.uint32)
    planes = state.planes_from_numpy(words, device="cpu")
    assert planes.dtype.is_signed and planes.dtype.itemsize == 4
    np.testing.assert_array_equal(state.numpy_from_planes(planes), words)


# -- BSI values -----------------------------------------------------------------

DEPTH = 10


def _bsi_write(frag, rng) -> None:
    """Bulk value imports (a fresh fragment, then an overwrite that needs
    the zero-plane clears), then single-value sets and clears (WAL)."""
    cols = rng.integers(0, 1 << 20, size=6000)
    frag.bulk_import_values(cols, rng.integers(0, 1 << DEPTH, size=cols.size),
                            DEPTH)
    again = np.concatenate([cols[:2000], rng.integers(0, 1 << 20, size=500)])
    frag.bulk_import_values(again, rng.integers(0, 1 << DEPTH, size=again.size),
                            DEPTH)
    for c in cols[2000:2300]:
        frag.set_value(int(c), DEPTH, int(rng.integers(0, 1 << DEPTH)))
    for c in cols[2300:2400]:
        frag.clear_value(int(c), DEPTH)
    frag.set_value(5, DEPTH, 0)
    frag.set_value(6, DEPTH, (1 << DEPTH) - 1)


def _bsi_rows(frag) -> dict:
    return {r: frag.row_dense(r) for r in range(DEPTH + 1)}


def _bsi_values(frag, cols) -> list:
    return [frag.value(int(c), DEPTH) for c in cols]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bsi_fragments_match_and_open_in_the_other_package(tmp_path, writer):
    """The same value traffic gives the same planes in both packages, and
    a BSI fragment file written by either opens in the other with the same
    values."""
    probe = np.concatenate([np.arange(0, 20),
                            np.random.default_rng(9).integers(0, 1 << 20,
                                                              size=3000)])
    frags = {}
    for name, cls in (("jax", JaxFragment), ("torch", Fragment)):
        path = str(tmp_path / name / "0")
        frag = cls(path, "i", "v", "bsig_v", 0).open()
        _bsi_write(frag, np.random.default_rng(8))
        frags[name] = (path, frag)
    want_rows = _bsi_rows(frags["jax"][1])
    for r, words in _bsi_rows(frags["torch"][1]).items():
        np.testing.assert_array_equal(words, want_rows[r], err_msg=f"row {r}")
    want = _bsi_values(frags["jax"][1], probe)
    assert _bsi_values(frags["torch"][1], probe) == want
    assert frags["torch"][1].value(5, DEPTH) == (0, True)
    assert frags["torch"][1].value(6, DEPTH) == ((1 << DEPTH) - 1, True)
    for _, frag in frags.values():
        frag.close()
    reader = Fragment if writer == "jax" else JaxFragment
    frag = reader(frags[writer][0], "i", "v", "bsig_v", 0).open()
    assert _bsi_values(frag, probe) == want
    for r, words in _bsi_rows(frag).items():
        np.testing.assert_array_equal(words, want_rows[r], err_msg=f"row {r}")
    frag.close()


def test_bsi_field_values_open_in_the_jax_package(tmp_path):
    """An int field with a negative min written by the port: the JAX
    package reads the same values, and the port reads them back after a
    reopen."""
    from pilosa_tpu_torch.models.field import FieldOptions

    rng = np.random.default_rng(10)
    cols = rng.integers(0, 3 << 20, size=4000)
    vals = rng.integers(-500, 1001, size=cols.size)
    d = str(tmp_path / "d")
    th = Holder(d).open()
    idx = th.create_index("i")
    f = idx.create_field("v", FieldOptions(type="int", min=-500, max=1000))
    f.import_values(cols, vals)
    f.set_value(7, -500)
    f.set_value(8, 1000)
    assert f.clear_value(int(cols[0]))
    with pytest.raises(ValueError, match="out of range"):
        f.set_value(9, 1001)
    probe = [int(c) for c in cols[:200]] + [7, 8, 9]
    want = [f.value(c) for c in probe]
    assert want[-3:] == [(-500, True), (1000, True), (0, False)]
    assert want[0] == (0, False)
    th.close()
    jh = JaxHolder(d).open()
    jf = jh.index("i").field("v")
    assert [jf.value(c) for c in probe] == want
    jh.close()
    th = Holder(d).open()
    assert [th.index("i").field("v").value(c) for c in probe] == want
    th.close()
