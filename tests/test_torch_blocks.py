"""The port's anti-entropy blocks, merges and quarantine against the JAX
package's.

On the same seeded fragments the two packages give the same block
checksums (blake2b-16 of each 100-row block) and block data, and
merge_block_majority gives the same sets, clears, peer deltas and
durability with 2 and 3 voters, a volatile (frozen) fragment and a large
adoption included. Every write path of the port's fragment drops the
checksums it changes. A fragment whose snapshot section is truncated is
quarantined under the same `<path>.corrupt-<ts>` name by both packages
and reopens empty, with a file the other package opens too.
"""

import hashlib
import io
import os
import re
import shutil

import numpy as np
import pytest

from pilosa_tpu.storage.fragment import Fragment as JaxFragment
from pilosa_tpu_torch.constants import HASH_BLOCK_SIZE, MAX_OP_N
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.roaring import Bitmap

SW = 1 << 20
BLOCK = HASH_BLOCK_SIZE * SW


def _frag(cls, path, **kw):
    return cls(str(path), "i", "f", "standard", 0, **kw).open()


def _seed(seed: int = 5, n: int = 4000) -> tuple:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 350, n)
    cols = rng.integers(0, SW, n)
    return rows, cols


def _pair(tmp_path, seed: int = 5) -> tuple:
    rows, cols = _seed(seed)
    jf = _frag(JaxFragment, tmp_path / "jax")
    pf = _frag(Fragment, tmp_path / "port")
    jf.bulk_import(rows, cols)
    pf.bulk_import(rows, cols)
    return jf, pf


def _fresh_blocks(frag) -> list:
    """The checksums from the bits, with no cache."""
    pos = frag.storage.positions()
    out = []
    for blk in np.unique(pos // np.uint64(BLOCK)).tolist():
        lo = np.uint64(blk * BLOCK)
        vals = pos[(pos >= lo) & (pos < lo + np.uint64(BLOCK))]
        out.append((blk, hashlib.blake2b((vals - lo).tobytes(),
                                         digest_size=16).digest()))
    return out


def test_blocks_and_block_data_equal(tmp_path):
    jf, pf = _pair(tmp_path)
    try:
        assert pf.blocks() == jf.blocks() == _fresh_blocks(pf)
        assert [b for b, _ in pf.blocks()] == [0, 1, 2, 3]
        for blk in range(5):
            pr, pc = pf.block_data(blk)
            jr, jc = jf.block_data(blk)
            assert pr.tolist() == jr.tolist() and pc.tolist() == jc.tolist()
    finally:
        jf.close()
        pf.close()


def _votes(local_pos, rng, n_peers: int) -> list:
    """Peer position arrays around the local block: most bits shared,
    some missing, some extra."""
    out = []
    for _ in range(n_peers):
        keep = local_pos[rng.random(local_pos.size) < 0.8]
        extra = np.uint64(BLOCK) + rng.integers(0, BLOCK, 50).astype(
            np.uint64)
        out.append(np.concatenate([keep, extra]))
    return out


@pytest.mark.parametrize("n_peers,majority_n,volatile",
                         [(1, None, False), (2, None, False), (2, 1, False),
                          (2, None, True), (1, None, True)])
def test_merge_block_majority_equal(tmp_path, n_peers, majority_n, volatile):
    rows, cols = _seed(9)
    jf = _frag(JaxFragment, tmp_path / "jax")
    pf = _frag(Fragment, tmp_path / "port")
    try:
        if volatile:
            pos = np.unique(rows.astype(np.uint64) * np.uint64(SW)
                            + cols.astype(np.uint64))
            jf.import_frozen(pos)
            pf.import_frozen(pos)
        else:
            jf.bulk_import(rows, cols)
            pf.bulk_import(rows, cols)
        lr, lc = pf.block_data(1)
        local = lr.astype(np.uint64) * np.uint64(SW) + lc.astype(np.uint64)
        votes = _votes(local, np.random.default_rng(3), n_peers)
        gens = [pf.row_generation(r) for r in range(100, 200)]
        got = pf.merge_block_majority(1, votes, majority_n=majority_n)
        want = jf.merge_block_majority(1, votes, majority_n=majority_n)
        assert got[:2] == want[:2] and got[3] == want[3]
        assert got[0] + got[1] > 0
        assert len(got[2]) == len(want[2]) == n_peers
        for (ps, pc), (js, jc) in zip(got[2], want[2]):
            assert ps.tolist() == js.tolist() and pc.tolist() == jc.tolist()
        assert pf.storage.positions().tolist() == \
            jf.storage.positions().tolist()
        assert pf.blocks() == jf.blocks() == _fresh_blocks(pf)
        # a changed row's generation moved (resident leaves rebuild)
        moved = [pf.row_generation(r) != g
                 for r, g in zip(range(100, 200), gens)]
        assert any(moved)
        if volatile:
            assert pf.volatile_mutations > 0
    finally:
        jf.close()
        pf.close()


def test_large_adoption_asks_for_a_snapshot(tmp_path):
    jf, pf = _pair(tmp_path)
    try:
        vote = np.uint64(2 * BLOCK) + np.arange(MAX_OP_N + 10,
                                                dtype=np.uint64) * np.uint64(7)
        got = pf.merge_block_majority(2, [vote])
        want = jf.merge_block_majority(2, [vote])
        assert got[0] == want[0] > MAX_OP_N and got[3] is want[3] is False
        pf.snapshot()
        small = np.array([np.uint64(2 * BLOCK + 3)], dtype=np.uint64)
        assert pf.merge_block_majority(2, [small])[3] is True
    finally:
        jf.close()
        pf.close()


def test_small_merge_is_durable_across_a_reopen(tmp_path):
    jf, pf = _pair(tmp_path)
    jf.close()
    vote = np.array([5 * SW + 11, 150 * SW + 12], dtype=np.uint64)
    pf.merge_block_majority(0, [vote[:1]], majority_n=1)  # the union
    pf.merge_block_majority(1, [vote[1:]])
    want = pf.storage.positions().tolist()
    pf.close()
    again = _frag(Fragment, tmp_path / "port")
    try:
        assert again.storage.positions().tolist() == want
        assert 150 * SW + 12 in want and 5 * SW + 11 in want
    finally:
        again.close()


def _roaring(pos) -> bytes:
    b = Bitmap()
    b.add_many(np.asarray(pos, dtype=np.uint64))
    buf = io.BytesIO()
    b.write_to(buf)
    return buf.getvalue()


WRITES = {
    "set_bit": lambda f: f.set_bit(120, 77),
    "clear_bit": lambda f: f.clear_bit(*_some_bit(f, 1)),
    "apply_batch": lambda f: f.apply_batch([(True, 130, 5),
                                            (False, *_some_bit(f, 1))]),
    "bulk_import": lambda f: f.bulk_import([140, 141], [9, 10]),
    "bulk_clear": lambda f: f.bulk_clear(*[[x] for x in _some_bit(f, 1)]),
    "bulk_import_mutex": lambda f: f.bulk_import_mutex([150], [3]),
    "set_row": lambda f: f.set_row(160, [1, 2, 3]),
    "clear_row": lambda f: f.clear_row(_some_bit(f, 1)[0]),
    "import_roaring": lambda f: f.import_roaring(_roaring([170 * SW + 4])),
    "import_roaring_clear": lambda f: f.import_roaring(
        _roaring([_some_pos(f, 1)]), clear=True),
    "bulk_import_values": lambda f: f.bulk_import_values([5, 6], [3, 1], 4),
    "merge_block_majority": lambda f: f.merge_block_majority(
        1, [np.array([180 * SW + 1], dtype=np.uint64)]),
}


def _some_pos(f, blk: int) -> int:
    return int(f.storage.slice(blk * BLOCK, (blk + 1) * BLOCK)[0])


def _some_bit(f, blk: int) -> tuple:
    p = _some_pos(f, blk)
    return p // SW, p % SW


@pytest.mark.parametrize("path", sorted(WRITES))
def test_each_write_path_drops_its_checksums(tmp_path, path):
    rows, cols = _seed(11)
    f = _frag(Fragment, tmp_path / "port")
    try:
        f.bulk_import(rows, cols)
        before = f.blocks()  # fills the cache
        WRITES[path](f)
        after = f.blocks()
        assert after == _fresh_blocks(f)
        assert after != before
    finally:
        f.close()


def test_frozen_writes_drop_their_checksums(tmp_path):
    rows, cols = _seed(13)
    pos = np.unique(rows.astype(np.uint64) * np.uint64(SW)
                    + cols.astype(np.uint64))
    f = _frag(Fragment, tmp_path / "port")
    try:
        f.blocks()
        f.import_frozen(pos)
        assert f.blocks() == _fresh_blocks(f)
        f.blocks()
        f.set_bit(250, 1)
        f.clear_bit(*_some_bit(f, 0))
        assert f.blocks() == _fresh_blocks(f)
    finally:
        f.close()


def _damaged_copy(src: str, dst: str) -> None:
    shutil.copyfile(src, dst)
    size = os.path.getsize(dst)
    with open(dst, "r+b") as fh:
        fh.truncate(size // 2)  # inside the container payloads


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_truncated_snapshot_is_quarantined_alike(tmp_path, writer):
    rows, cols = _seed(17)
    cls = JaxFragment if writer == "jax" else Fragment
    src = _frag(cls, tmp_path / "src")
    src.bulk_import(rows, cols)
    src.snapshot()
    src.close()
    files = {}
    for name, reader in (("jax", JaxFragment), ("port", Fragment)):
        path = tmp_path / name
        _damaged_copy(str(tmp_path / "src"), str(path))
        damaged = open(path, "rb").read()
        f = _frag(reader, path)
        try:
            assert f.quarantine_path is not None and f.needs_rebuild
            assert re.fullmatch(re.escape(str(path)) + r"\.corrupt-\d{8}-\d{6}",
                                f.quarantine_path)
            assert open(f.quarantine_path, "rb").read() == damaged
            assert f.corruption_error
            assert f.bit_count() == 0 and f.blocks() == []
        finally:
            f.close()
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"]
    # each package opens the other's emptied file cleanly
    for name, reader in (("jax", Fragment), ("port", JaxFragment)):
        f = _frag(reader, tmp_path / name)
        try:
            assert f.quarantine_path is None and f.bit_count() == 0
        finally:
            f.close()


def test_rebuild_from_replica_bytes(tmp_path):
    """The repair path: a quarantined fragment takes a replica's roaring
    bytes through import_roaring and matches it."""
    rows, cols = _seed(19)
    good = _frag(Fragment, tmp_path / "good")
    good.bulk_import(rows, cols)
    good.snapshot()
    _damaged_copy(str(tmp_path / "good"), str(tmp_path / "bad"))
    bad = _frag(Fragment, tmp_path / "bad")
    try:
        assert bad.needs_rebuild
        bad.import_roaring(_roaring(good.storage.positions()))
        bad.rebuilt_from = "b"
        assert not bad.needs_rebuild
        assert bad.blocks() == good.blocks()
    finally:
        bad.close()
        good.close()
