"""The port's coalesced write path, module by module, against the JAX
package.

Same numpy inputs, made from a seed, through the JAX functions and the
port's counterparts on the CPU: the leaf patches (patch_dense_words,
patch_sparse_rows), Fragment.apply_batch on twin fragments, the incremental
run statistics, the mutation scanner; and the IngestBatcher's leadership
held through the apply. Bits, flags and counts: the tolerance is 0.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitvector as jbv
from pilosa_tpu.pql import parser as jparser
from pilosa_tpu.storage.fragment import Fragment as JaxFragment
from pilosa_tpu_torch.constants import MAX_OP_N
from pilosa_tpu_torch.ops import bitvector as bv
from pilosa_tpu_torch.parallel.ingest import (
    ApplyFence,
    IngestBatcher,
    Mutation,
)
from pilosa_tpu_torch.pql import parser as tparser
from pilosa_tpu_torch.storage.fragment import Fragment

SW = 1 << 20
W = SW // 32
SENT = bv.SPARSE_SENTINEL


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _pad(n: int) -> int:
    k = 8
    while k < n:
        k <<= 1
    return k


# ---------------------------------------------------------------- patches


def _dense_case(name: str, rng, s: int, w: int):
    """(sidx, widx, set mask, clear mask) host arrays, each coordinate
    once."""
    if name == "empty":
        e = np.empty(0, np.int64)
        return e, e, e.astype(np.uint32), e.astype(np.uint32)
    if name == "last-shard-last-word":
        sidx = np.array([s - 1, s - 1, 0], np.int64)
        widx = np.array([w - 1, 0, w - 1], np.int64)
    else:
        n = min(s * w, 40)
        flat = rng.choice(s * w, size=n, replace=False)
        sidx, widx = flat // w, flat % w
    smask = _words(rng, sidx.size)
    cmask = _words(rng, sidx.size) & ~smask
    if name == "bit31":
        smask[:] = 0x80000000
        cmask[1::2] = 0x80000001
        smask[1::2] = 0
    return sidx, widx, smask, cmask


@pytest.mark.parametrize("name,s,w", [
    ("random", 3, 64), ("bit31", 4, 128), ("last-shard-last-word", 3, W),
    ("empty", 2, 64), ("random", 5, W)])
def test_patch_dense_words_matches_jax(name, s, w):
    rng = np.random.default_rng(len(name) * 7 + s)
    plane = _words(rng, s, w)
    plane[:, :3] = 0xFFFFFFFF
    sidx, widx, smask, cmask = _dense_case(name, rng, s, w)
    # the JAX package pads to a power of two with an out-of-range shard
    n = _pad(sidx.size)
    jsidx = np.full(n, s, np.int32)
    jwidx = np.zeros(n, np.int32)
    jsm = np.zeros(n, np.uint32)
    jcm = np.zeros(n, np.uint32)
    jsidx[:sidx.size], jwidx[:sidx.size] = sidx, widx
    jsm[:sidx.size], jcm[:sidx.size] = smask, cmask
    want = np.asarray(jbv.patch_dense_words(plane, jsidx, jwidx, jsm, jcm))
    t = torch.from_numpy(plane.view(np.int32).copy())
    before = t.clone()
    got = bv.patch_dense_words(t, sidx, widx, smask, cmask)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(t, before), "the resident tensor must not change"
    assert got.data_ptr() != t.data_ptr()


def test_patch_dense_words_refuses_pads_and_repeats():
    t = torch.zeros((2, 64), dtype=torch.int32)
    one = np.array([1], np.uint32)
    with pytest.raises(IndexError):
        bv.patch_dense_words(t, [2], [0], one, one)  # the JAX pad shard
    with pytest.raises(IndexError):
        bv.patch_dense_words(t, [0], [64], one, one)
    with pytest.raises(ValueError, match="repeat"):
        bv.patch_dense_words(t, [1, 1], [3, 3], [1, 2], [0, 0])


def _sparse_rows(rng, cards, k):
    out = np.full((len(cards), k), SENT, np.int32)
    for i, c in enumerate(cards):
        cols = np.sort(rng.choice(5000, size=c, replace=False))
        out[i, :c] = cols
    return out


@pytest.mark.parametrize("case", ["random", "full-to-k", "all-pads",
                                  "removes-absent", "adds-present"])
def test_patch_sparse_rows_matches_jax(case):
    rng = np.random.default_rng(len(case))
    k = 16
    sp = _sparse_rows(rng, [5, 0, 9, 16], k)
    adds = np.full((4, 8), SENT, np.int32)
    rems = np.full((4, 8), SENT, np.int32)
    if case == "random":
        adds[0, :3] = np.sort(rng.choice(np.arange(6000, 7000), 3,
                                         replace=False))
        rems[0, :2] = sp[0, [1, 3]]
        adds[1, :2] = [0, SW - 1]
        rems[2, :1] = sp[2, :1]
    elif case == "full-to-k":
        # shard 0 from 5 to 16 entries, shard 3 stays at exactly 16
        adds[0, :8] = np.arange(6000, 6008)
        adds[0, :3] = [1, 2, 3] if 1 not in sp[0] else [7001, 7002, 7003]
        adds[0] = np.sort(adds[0])
        rems[3, :1] = sp[3, 4:5]
        adds[3, :1] = [9999]
    elif case == "removes-absent":
        rems[:, :2] = [[9000, 9001]] * 4
    elif case == "adds-present":
        adds[2, :3] = sp[2, :3]
        adds[3, :2] = sp[3, 5:7]
    want = np.asarray(jbv.patch_sparse_rows(sp, adds, rems))
    t = torch.from_numpy(sp.copy())
    got = bv.patch_sparse_rows(t, adds, rems)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(t, torch.from_numpy(sp)), "resident tensor changed"
    # narrower add/remove arrays (the port does not pad them) agree too
    na = int((adds < SENT).sum(axis=1).max()) or 1
    nr = int((rems < SENT).sum(axis=1).max()) or 1
    got2 = bv.patch_sparse_rows(t, adds[:, :na], torch.from_numpy(
        rems[:, :nr].copy()))
    np.testing.assert_array_equal(got2.numpy(), want)


# ----------------------------------------------------- Fragment.apply_batch


def _twins(tmp_path):
    j = JaxFragment(str(tmp_path / "jax" / "0"), "i", "f", "standard",
                    0).open()
    t = Fragment(str(tmp_path / "torch" / "0"), "i", "f", "standard",
                 0).open()
    return j, t


def _bits(frag, rows) -> list:
    return [frag.row_columns(r).tolist() for r in rows]


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_batch_matches_jax_across_snapshot_and_reopen(tmp_path, seed):
    rng = random.Random(seed)
    j, t = _twins(tmp_path)
    rows = [0, 1, 5]
    cols = [rng.randrange(0, 300) for _ in range(40)] + [0, SW - 1, 77]
    # a few single-bit writes first, so run statistics and generations
    # already exist
    for r in rows:
        for c in cols[:4]:
            assert j.set_bit(r, c) == t.set_bit(r, c)
    total = 0
    n_batches = 0
    while total <= MAX_OP_N + 500:  # past one snapshot
        muts = [(rng.random() < 0.6, rng.choice(rows), rng.choice(cols))
                for _ in range(rng.randrange(1, 400))]
        if n_batches % 7 == 3:
            muts = muts[:1]
        want = j.apply_batch(muts)
        got = t.apply_batch(muts)
        assert got == want, f"batch {n_batches}"
        for r in rows + [9]:
            assert t.row_generation(r) == j.row_generation(r), (r, n_batches)
        assert t.generation == j.generation
        total += got[1]
        n_batches += 1
    assert t.apply_batch([]) == j.apply_batch([]) == ([], 0, 0)
    want_bits = _bits(j, rows)
    assert _bits(t, rows) == want_bits
    j.close()
    t.close()
    # WAL replay after the snapshot: both reopen to the same bits, and
    # each reads the other's file
    j2 = JaxFragment(t.path, "i", "f", "standard", 0).open()
    t2 = Fragment(j.path, "i", "f", "standard", 0).open()
    try:
        assert _bits(j2, rows) == want_bits
        assert _bits(t2, rows) == want_bits
    finally:
        j2.close()
        t2.close()


def test_apply_batch_flags_follow_the_per_bit_order(tmp_path):
    _, t = _twins(tmp_path)
    t.set_bit(0, 5)
    muts = [(True, 0, 5), (False, 0, 5), (False, 0, 5), (True, 0, 5),
            (True, 0, 6), (False, 0, 6), (False, 1, 9)]
    changed, n_ops, n_appends = t.apply_batch(muts)
    assert changed == [False, True, False, True, True, True, False]
    # 5 ends set (as it began), 6 set then cleared: no net record
    assert (n_ops, n_appends) == (0, 0)
    gen = t.generation
    assert t.row_generation(0) == gen and t.row_generation(1) < gen
    assert t.row_columns(0).tolist() == [5]


# ------------------------------------------------------ run statistics


def _recount(frag, row):
    iv = frag.row_runs(row)
    n = int(iv.shape[0])
    return n, int((iv[:, 1] - iv[:, 0] + 1).max()) if n else 0


def test_incremental_run_stats_match_a_recount_and_jax(tmp_path):
    rng = random.Random(11)
    j, t = _twins(tmp_path)
    # dense clusters so writes extend, bridge and split runs, at both
    # shard edges and across a container boundary
    universe = (list(range(0, 40)) + list(range(65520, 65560))
                + list(range(SW - 30, SW)))
    for step in range(700):
        r = rng.choice([0, 3])
        c = rng.choice(universe)
        if rng.random() < 0.6:
            assert j.set_bit(r, c) == t.set_bit(r, c)
        else:
            assert j.clear_bit(r, c) == t.clear_bit(r, c)
        if step % 3 == 0:
            n, maxr = t.row_run_stats(r)
            assert n == j.row_run_stats(r)[0], step
            want_n, want_max = _recount(t, r)
            assert n == want_n, step
            assert maxr >= want_max, step  # an upper bound after clears
            # the chooser's count, carried by the same delta
            assert t.row_interval_count(r) == want_n, step
        if step % 50 == 49:
            muts = [(rng.random() < 0.5, r, rng.choice(universe))
                    for _ in range(30)]
            assert t.apply_batch(muts) == j.apply_batch(muts)
            assert t.row_run_stats(r) == _recount(t, r)
    j.close()
    t.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_counts_carried_across_batches(tmp_path, seed):
    """row_interval_count, current before each batch, is carried across
    it (not recounted) and equals a recount from the containers: runs
    made, grown, bridged, split and erased, at the shard's first and last
    column and across container boundaries."""
    rng = random.Random(seed)
    _, t = _twins(tmp_path)
    universe = (list(range(0, 50)) + list(range(65500, 65580))
                + list(range(SW - 40, SW)))
    rows = [0, 2]
    for r in rows:
        for c in rng.sample(universe, 60):
            t.set_bit(r, c)
    for step in range(80):
        for r in rows:
            t.row_interval_count(r)  # current before the batch
        muts = [(rng.random() < 0.5, rng.choice(rows), rng.choice(universe))
                for _ in range(rng.randrange(1, 60))]
        t.apply_batch(muts)
        for r in rows:
            entry = t._row_intervals.get(r)
            assert entry is not None and entry[0] == t.row_generation(r)
            assert entry[1] == _recount(t, r)[0], (step, r)
    t.close()


# ----------------------------------------------------------- the scanner


def _ast(q):
    return None if q is None else [(c.name, c.args, c.pos) for c in q.calls]


def _envelope(rng) -> str:
    seps = [" ", "", "\n", "\t ", "  "]
    out = []
    for _ in range(rng.randrange(1, 30)):
        name = rng.choice(["Set", "Clear"])
        col = rng.choice([0, 7, rng.randrange(0, 1 << 40)])
        field = rng.choice(["f", "g_1", "a-b", "Xy9"])
        row = rng.choice([0, 3, rng.randrange(0, 1 << 20)])
        sp = [rng.choice(seps) for _ in range(5)]
        out.append(f"{sp[0]}{name}({sp[1]}{col}{sp[2]},{sp[3]}{field}"
                   f"{sp[4]}={rng.choice(seps)}{row})")
    return "".join(out) + rng.choice(["", " ", "\n"])


def test_parse_mutations_fast_matches_jax_and_the_full_parser():
    rng = random.Random(5)
    for _ in range(200):
        src = _envelope(rng)
        got = tparser.parse_mutations_fast(src)
        assert got is not None, src
        assert _ast(got) == _ast(jparser.parse_mutations_fast(src)), src
        full = tparser.parse_string(src)
        assert [(c.name, c.args) for c in got.calls] == \
            [(c.name, c.args) for c in full.calls], src
    declined = ["Count(Row(f=1))", "Set(1, f=1) Count(Row(f=1))",
                "Set('a', f=1)", "Set(1, f=true)", "Set(01, f=1)",
                "Set(1, f=1, 2017-01-01T00:00)", "", "  ",
                "Set(1, f==2)", "Clear(1.5, f=1)", "Set(1, f=1) x"]
    for src in declined:
        assert tparser.parse_mutations_fast(src) is None, src
        assert jparser.parse_mutations_fast(src) is None, src


# ---------------------------------------------------------- IngestBatcher


def _muts(n: int, base: int = 0) -> list:
    return [Mutation(True, "f", 0, base + i) for i in range(n)]


def test_ingest_batcher_slices_outcomes_per_request():
    def apply(index_name, muts):
        assert index_name == "i"
        return [("err", ValueError(f"bad {m.col}")) if m.col == 13
                else ("ok", m.col % 2 == 0) for m in muts]

    b = IngestBatcher(apply)
    assert b.submit(("i",), _muts(4)) == [("ok", True), ("ok", False),
                                          ("ok", True), ("ok", False)]
    out = b.submit(("i",), _muts(3, base=12))
    assert out[0] == ("ok", True) and out[2] == ("ok", True)
    assert out[1][0] == "err" and "bad 13" in str(out[1][1])
    snap = b.snapshot()
    assert snap["mutations"] == 7 and snap["setMutations"] == 7


def _run_threads(target, n: int, timeout: float = 30.0) -> None:
    ts = [threading.Thread(target=target, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a submitter hung"


def test_ingest_batcher_holds_leadership_through_the_apply():
    """No second apply of one key starts while one runs; arrivals pile up
    behind it and are cut at max_batch requests."""
    state = {"running": 0, "overlap": False, "sizes": []}
    lock = threading.Lock()
    gate = threading.Event()

    def apply(index_name, muts):
        with lock:
            state["running"] += 1
            state["overlap"] |= state["running"] > 1
            state["sizes"].append(len(muts))
            first = len(state["sizes"]) == 1
        if first:
            assert gate.wait(10)  # hold the key while the queue fills
        time.sleep(0.005)
        with lock:
            state["running"] -= 1
        return [("ok", True)] * len(muts)

    b = IngestBatcher(apply, max_batch=3)
    results: dict = {}
    errors: list = []

    def writer(i: int) -> None:
        try:
            for k in range(3):
                results[(i, k)] = b.submit(("i",), _muts(2, base=100 * i))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def release() -> None:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with b._lock:
                if len(b._pending.get(("i",), ())) >= 8:
                    break
            time.sleep(0.001)
        gate.set()

    releaser = threading.Thread(target=release, daemon=True)
    releaser.start()
    _run_threads(writer, 12)
    releaser.join(10)
    assert not errors
    assert len(results) == 36
    assert all(v == [("ok", True)] * 2 for v in results.values())
    assert not state["overlap"], "two applies of one key ran at once"
    # the queue that piled up behind the first apply was cut at 3 requests
    assert max(state["sizes"]) == 6
    snap = b.snapshot()
    assert snap["max_batch_seen"] == 3
    assert snap["mutations"] == 72


def test_ingest_batcher_returns_leadership_after_an_apply_raises():
    calls = {"n": 0}

    def apply(index_name, muts):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.05)  # let followers queue behind the failure
            raise RuntimeError("disk full")
        return [("ok", False)] * len(muts)

    b = IngestBatcher(apply)
    outcomes: dict = {}

    def writer(i: int) -> None:
        try:
            outcomes[i] = b.submit(("i",), _muts(1, base=i))
        except RuntimeError as e:
            outcomes[i] = e

    _run_threads(writer, 6)
    errs = [v for v in outcomes.values() if isinstance(v, RuntimeError)]
    assert len(outcomes) == 6 and errs and "disk full" in str(errs[0])
    # the key is free again: a later submit leads and applies
    assert b.submit(("i",), _muts(1)) == [("ok", False)]
    assert not b._leaders and not b._pending


def test_apply_fence_keeps_reads_out_of_an_apply():
    """Reads share the fence; an apply excludes them and waits for those
    in flight; a waiting apply holds off new reads but not a nested read
    of a thread already reading."""
    fence = ApplyFence()
    log: list = []
    lock = threading.Lock()
    in_read = threading.Event()
    release = threading.Event()

    def note(x):
        with lock:
            log.append(x)

    def long_reader() -> None:
        with fence.read():
            note("r1 in")
            in_read.set()
            assert release.wait(10)
            with fence.read():  # nested, while the apply waits
                note("r1 nested")
            note("r1 out")

    def applier() -> None:
        with fence.apply():
            note("apply")
            time.sleep(0.02)
            note("apply done")

    def late_reader() -> None:
        with fence.read():
            note("r2")

    t1 = threading.Thread(target=long_reader, daemon=True)
    t1.start()
    assert in_read.wait(10)
    t2 = threading.Thread(target=applier, daemon=True)
    t2.start()
    deadline = time.monotonic() + 10
    while fence._waiting == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    t3 = threading.Thread(target=late_reader, daemon=True)
    t3.start()
    time.sleep(0.05)
    assert log == ["r1 in"]  # the apply waits for r1; r2 waits for it
    release.set()
    for t in (t1, t2, t3):
        t.join(10)
        assert not t.is_alive()
    assert log == ["r1 in", "r1 nested", "r1 out", "apply", "apply done",
                   "r2"]


def test_apply_fence_lets_waiting_reads_in_between_applies():
    """A read that waited through one apply goes in before the next
    waiting apply: back-to-back batches cannot starve reads."""
    fence = ApplyFence()
    order: list = []
    first_in = threading.Event()
    release = threading.Event()

    def first_apply() -> None:
        with fence.apply():
            first_in.set()
            assert release.wait(10)
            order.append("apply 1")

    def second_apply() -> None:
        with fence.apply():
            order.append("apply 2")

    def reader() -> None:
        with fence.read():
            order.append("read")

    t1 = threading.Thread(target=first_apply, daemon=True)
    t1.start()
    assert first_in.wait(10)
    t2 = threading.Thread(target=reader, daemon=True)
    t2.start()
    time.sleep(0.02)  # the read waits on apply 1
    t3 = threading.Thread(target=second_apply, daemon=True)
    t3.start()
    deadline = time.monotonic() + 10
    while fence._waiting == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    release.set()
    for t in (t1, t2, t3):
        t.join(10)
        assert not t.is_alive()
    assert order == ["apply 1", "read", "apply 2"]
