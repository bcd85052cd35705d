"""The port's sparse/run leaves, chooser and statistics against the JAX
package.

Same numpy inputs, made from a seed, through the JAX functions (the Pallas
sparse_intersect_dense in interpret mode, as tests/test_hybrid.py runs it)
and the port's counterparts on the CPU, where the kernel wrappers take
their plain versions. Column ids and bits: the tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.ops import bitvector as jbv
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel import residency as jres
from pilosa_tpu_torch import state
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import hybrid as hy
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import residency as tres

SW = 1 << 20
W = SW // 32
SENT = hy.SPARSE_SENTINEL
S = 3
# a narrow column universe, so that random rows overlap, plus the edges
UNIVERSE = 40000
EDGE = np.array([0, 31, 63, 32 * 77 + 31, SW - 33, SW - 1], dtype=np.int64)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return state.planes_from_numpy(a, device="cpu")
    return state.hybrid_leaf_from_numpy(a, device="cpu")


def _same(jax_out, port_out: torch.Tensor) -> None:
    want = np.asarray(jax_out)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    got = port_out.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def _cols(rng, n: int, edges: bool = True) -> np.ndarray:
    c = rng.choice(UNIVERSE, size=min(n, UNIVERSE), replace=False)
    if edges:
        c = np.concatenate([c, EDGE[rng.random(EDGE.size) < 0.5]])
    return np.unique(c)


def _sparse(rng, cards, slots=None) -> np.ndarray:
    """[S, slots] sparse leaf; a card of -1 is an all-sentinel row."""
    rows = [np.empty(0, np.int64) if c < 0 else _cols(rng, c) for c in cards]
    slots = slots or tres.HybridManager.pad_slots(
        max(max(r.size for r in rows), 1))
    return np.stack([jbv.sparse_from_columns(r, slots) for r in rows])


def _intervals(rng, n: int) -> np.ndarray:
    """n disjoint non-adjacent inclusive intervals in the universe, one of
    them ending at the last column when n > 2."""
    if n == 0:
        return np.empty((0, 2), np.int64)
    pts = np.sort(rng.choice(UNIVERSE // 2, size=2 * n, replace=False)) * 2
    iv = pts.reshape(-1, 2)
    iv[:, 1] += rng.integers(0, 2, size=n)  # odd and even ends
    if n > 2:
        iv[-1] = [SW - 40, SW - 1]
    return iv


def _runs(rng, counts, slots=None) -> np.ndarray:
    ivs = [_intervals(rng, n) for n in counts]
    slots = slots or tres.HybridManager.pad_slots(max(max(counts), 1))
    return np.stack([jbv.runs_from_intervals(iv, slots) for iv in ivs])


def _dense(rng, density: float = 0.3) -> np.ndarray:
    bits = np.zeros((S, SW), dtype=bool)
    bits[:, :UNIVERSE] = rng.random((S, UNIVERSE)) < density
    bits[:, EDGE] = rng.random((S, EDGE.size)) < 0.5
    return np.packbits(bits, axis=1, bitorder="little").view("<u4").copy()


# -- host builders --------------------------------------------------------------


def test_host_builders_match_jax():
    rng = np.random.default_rng(1)
    cols = np.concatenate([_cols(rng, 300), np.arange(5000, 5100)])
    rng.shuffle(cols)
    for slots in (8, 512, 1024):
        np.testing.assert_array_equal(hy.sparse_from_columns(cols, slots),
                                      jbv.sparse_from_columns(cols, slots))
        np.testing.assert_array_equal(hy.runs_from_columns(cols, slots),
                                      jbv.runs_from_columns(cols, slots))
    np.testing.assert_array_equal(hy.runs_from_columns([], 8),
                                  jbv.runs_from_columns([], 8))
    srt = np.unique(cols)
    np.testing.assert_array_equal(hy.intervals_from_sorted(srt),
                                  jbv.intervals_from_sorted(srt))
    iv = jbv.intervals_from_sorted(srt)
    np.testing.assert_array_equal(hy.runs_from_intervals(iv, 64),
                                  jbv.runs_from_intervals(iv, 64))


def test_hybrid_leaf_from_numpy_keeps_values():
    rng = np.random.default_rng(2)
    sp = _sparse(rng, [5, -1, 40])
    rn = _runs(rng, [3, 0, 9])
    np.testing.assert_array_equal(_t(sp).numpy(), sp)
    np.testing.assert_array_equal(_t(rn).numpy(), rn)
    with pytest.raises(ValueError):
        state.hybrid_leaf_from_numpy(sp.astype(np.int64), device="cpu")
    with pytest.raises(ValueError):
        state.hybrid_leaf_from_numpy(np.zeros((2, 3, 4), np.int32),
                                     device="cpu")


# -- sparse and run ops ------------------------------------------------------------

SPARSE_CASES = [
    ([100, 0, 600], [300, 50, 7]),     # empty row in a
    ([-1, 20, 600], [300, -1, 2000]),  # all-sentinel rows on both sides
    ([4000, 4000, 4000], [8, 3000, 1]),
    ([1, 1, 1], [1, 1, 1]),
]


@pytest.mark.parametrize("case", range(len(SPARSE_CASES)))
def test_sparse_ops_match_jax(case):
    rng = np.random.default_rng(10 + case)
    ca, cb = SPARSE_CASES[case]
    a, b, d = _sparse(rng, ca), _sparse(rng, cb), _dense(rng)
    ta, tb, td = _t(a), _t(b), _t(d)
    for name in ("sparse_intersect", "sparse_difference", "sparse_union",
                 "sparse_xor"):
        _same(getattr(jbv, name)(a, b), getattr(hy, name)(ta, tb))
        _same(getattr(jbv, name)(b, a), getattr(hy, name)(tb, ta))
    for name in ("sparse_intersect_dense", "sparse_difference_dense",
                 "sparse_dense_count"):
        _same(getattr(jbv, name)(a, d), getattr(hy, name)(ta, td))
    _same(jbv.sparse_count(a), hy.sparse_count(ta))
    _same(jbv.sparse_to_dense(a, W), hy.sparse_to_dense(ta, W))
    _same(jbv.sparse_to_dense(b, W), hy.sparse_to_dense(tb))


def test_sparse_to_dense_bit_31_and_the_last_column():
    cols = np.array([31, 63, 95, 32 * 1000 + 31, SW - 1], dtype=np.int64)
    sp = np.stack([jbv.sparse_from_columns(cols, 8),
                   jbv.sparse_from_columns(cols[-1:], 8),
                   jbv.sparse_from_columns([], 8)])
    got = hy.sparse_to_dense(_t(sp))
    _same(jbv.sparse_to_dense(sp, W), got)
    words = got.numpy().view(np.uint32)
    assert words[0, 0] == 1 << 31 and words[0, W - 1] == 1 << 31
    assert words[1].sum() == 1 << 31 and not words[2].any()


RUN_CASES = [([3, 0, 9], [5, 2, 0]), ([1, 7, 16], [16, 1, 4]),
             ([0, 0, 0], [2, 3, 1])]


@pytest.mark.parametrize("case", range(len(RUN_CASES)))
def test_run_ops_match_jax(case):
    rng = np.random.default_rng(20 + case)
    ca, cb = RUN_CASES[case]
    a, b = _runs(rng, ca), _runs(rng, cb, slots=32)
    sp, d = _sparse(rng, [900, 0, 3000]), _dense(rng)
    ta, tb, tsp, td = _t(a), _t(b), _t(sp), _t(d)
    _same(jbv.run_count(a), hy.run_count(ta))
    for x, y, tx, ty in ((a, b, ta, tb), (b, a, tb, ta), (a, a, ta, ta)):
        _same(jbv.run_intersect(x, y), hy.run_intersect(tx, ty))
        _same(jbv.run_intersect_count(x, y), hy.run_intersect_count(tx, ty))
    _same(jbv.sparse_intersect_run(sp, a), hy.sparse_intersect_run(tsp, ta))
    _same(jbv.sparse_difference_run(sp, a), hy.sparse_difference_run(tsp, ta))
    _same(jbv.run_to_dense(a, W), hy.run_to_dense(ta, W))
    _same(jbv.run_to_dense(b, W), hy.run_to_dense(tb))
    _same(jbv.run_intersect_dense(a, d, W), hy.run_intersect_dense(ta, td, W))
    _same(jbv.run_dense_count(a, d, W), hy.run_dense_count(ta, td, W))


def test_run_to_dense_word_edges():
    """Runs inside one word, ending on bit 31, spanning many words, and
    two runs sharing a word."""
    iv = np.array([[0, 0], [5, 31], [33, 40], [62, 64], [100, 1000],
                   [1002, 1023], [SW - 64, SW - 1]], dtype=np.int64)
    rn = np.stack([jbv.runs_from_intervals(iv, 8),
                   jbv.runs_from_intervals(iv[3:5], 8),
                   jbv.runs_from_intervals(np.empty((0, 2)), 8)])
    _same(jbv.run_to_dense(rn, W), hy.run_to_dense(_t(rn)))
    # a narrower plane drops the bits past its width, as the JAX form does
    _same(jbv.run_to_dense(rn, 16), hy.run_to_dense(_t(rn), 16))


# -- the kernel's plain route against the Pallas kernel ----------------------------


@pytest.mark.parametrize("k", [8, 31, 32, 33, 255, 256, 257, 512, 4096])
def test_sparse_intersect_dense_matches_pallas(k):
    rng = np.random.default_rng(k)
    cards = [k, k // 2, -1]
    sp = _sparse(rng, cards, slots=k)
    d = _dense(rng, 0.5)
    d[0, :] = 0xFFFFFFFF  # every entry of row 0 hits
    before = kernels.launch_counts()["sparse_intersect_dense"]
    got = kernels.sparse_intersect_dense(_t(sp), _t(d))
    _same(pk.sparse_intersect_dense(jnp.asarray(sp), jnp.asarray(d)), got)
    _same(jbv.sparse_intersect_dense(sp, d), got)
    _same(jbv.sparse_difference_dense(sp, d),
          kernels.sparse_difference_dense(_t(sp), _t(d)))
    # the contract the kernel relies on: sorted rows, the sentinel last
    out = got.numpy()
    assert (np.diff(out, axis=1) >= 0).all()
    np.testing.assert_array_equal(out[0], sp[0])
    assert (out[2] == SENT).all()
    # a CPU tensor takes the plain version: no launch
    assert kernels.launch_counts()["sparse_intersect_dense"] == before


def test_sparse_intersect_dense_rejects_bad_layouts():
    sp = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="sparse rows"):
        kernels.sparse_intersect_dense(sp, torch.zeros((3, W),
                                                       dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.sparse_intersect_dense(sp.long(), torch.zeros(
            (2, W), dtype=torch.int32))


# -- mixed trees ---------------------------------------------------------------------

KINDS = ("sparse", "run", "dense")


def _leaf(rng, kind: str):
    if kind == "sparse":
        return _sparse(rng, [int(rng.integers(-1, 2500)) for _ in range(S)])
    if kind == "run":
        return _runs(rng, [int(rng.integers(0, 12)) for _ in range(S)])
    return _dense(rng, float(rng.choice([0.05, 0.5])))


def _program(rng, n_leaves: int, depth: int = 0):
    r = rng.random()
    if depth >= 2 or r < 0.25:
        return ("leaf", int(rng.integers(n_leaves)))
    if r < 0.35:
        return ("not", _program(rng, n_leaves, depth + 1))
    op = ("and", "and", "andnot", "or", "xor")[int(rng.integers(5))]
    return (op, *[_program(rng, n_leaves, depth + 1)
                  for _ in range(int(rng.integers(2, 4)))])


def _check_tree(program, leaves, kinds) -> None:
    jleaves = [jnp.asarray(x) for x in leaves]
    tleaves = [_t(x) for x in leaves]
    jkind, jarr = jbv.eval_hybrid(program, jleaves, kinds, W)
    tkind, tarr = hy.eval_hybrid(program, tleaves, kinds, W,
                                 kernels.sparse_intersect_dense,
                                 kernels.sparse_difference_dense)
    assert tkind == jkind, program
    _same(jarr, tarr)
    assert hy.hybrid_count(program, tleaves, kinds) == \
        jbv.hybrid_count(program, jleaves, kinds), program


@pytest.mark.parametrize("seed", range(6))
def test_eval_hybrid_and_count_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    kinds = [KINDS[i % 3] for i in range(4)]
    rng.shuffle(kinds)
    leaves = [_leaf(rng, k) for k in kinds]
    for _ in range(4):
        _check_tree(_program(rng, len(leaves)), leaves, kinds)


@pytest.mark.parametrize("program", [
    ("and", ("leaf", 0), ("leaf", 1)),
    ("and", ("leaf", 0), ("leaf", 1), ("leaf", 2)),   # all-run pushdown
    ("and", ("leaf", 3), ("leaf", 0)),                # sparse ∩ run
    ("and", ("leaf", 0), ("leaf", 4)),                # run ∩ dense
    ("andnot", ("leaf", 3), ("leaf", 4)),             # sparse &~ dense
    ("andnot", ("leaf", 0), ("leaf", 3)),             # run &~ sparse
    ("or", ("leaf", 3), ("leaf", 5)),                 # sparse ∪ sparse
    ("xor", ("leaf", 0), ("leaf", 3)),                # run ^ sparse
    ("not", ("leaf", 3)),
])
def test_hybrid_shapes_match_jax(program):
    rng = np.random.default_rng(7)
    leaves = [_runs(rng, [4, 0, 9]), _runs(rng, [6, 2, 1]),
              _runs(rng, [1, 1, 1]), _sparse(rng, [700, -1, 30]),
              _dense(rng), _sparse(rng, [0, 5, 2000])]
    _check_tree(program, leaves,
                ["run", "run", "run", "sparse", "dense", "sparse"])


def test_wide_union_densifies_like_jax():
    rng = np.random.default_rng(13)
    a = _sparse(rng, [12000] * S, slots=1 << 14)
    b = _sparse(rng, [12000] * S, slots=1 << 14)
    c = _sparse(rng, [100] * S)
    for program in (("or", ("leaf", 0), ("leaf", 1)),
                    ("xor", ("leaf", 0), ("leaf", 2))):
        _check_tree(program, [a, b, c], ["sparse"] * 3)
    kind, _ = hy.eval_hybrid(("or", ("leaf", 0), ("leaf", 1)),
                             [_t(a), _t(b)], ["sparse", "sparse"])
    assert kind == "dense"


# -- the chooser ------------------------------------------------------------------------


@pytest.mark.parametrize("thresholds", [(4096, 2048), (1000, 0), (100, 50)])
@pytest.mark.parametrize("seed", range(3))
def test_hybrid_manager_matches_jax(thresholds, seed, monkeypatch):
    monkeypatch.delenv("PILOSA_TPU_HYBRID", raising=False)
    monkeypatch.delenv("PILOSA_TPU_TORCH_HYBRID", raising=False)
    thr, run_thr = thresholds
    j = jres.HybridManager(threshold=thr, run_threshold=run_thr)
    t = tres.HybridManager(threshold=thr, run_threshold=run_thr)
    rng = np.random.default_rng(seed)
    keys = [("i", "f", "standard", r) for r in range(5)]
    for _ in range(300):
        key = keys[int(rng.integers(len(keys)))]
        card = int(rng.choice([0, 1, thr // 2, int(thr * 0.8), thr,
                               thr + 1, 4 * thr + 3]))
        stats = None
        if rng.random() < 0.7:
            n_iv = int(rng.choice([1, max(run_thr // 2, 1),
                                   int(run_thr * 0.9) + 1, run_thr,
                                   run_thr + 1, 3 * run_thr + 5]))
            stats = (n_iv, int(rng.integers(1, 5000)))
        if rng.random() < 0.2:
            j.observe(key, card, run_stats=stats)
            t.observe(key, card, run_stats=stats)
            continue
        peek = bool(rng.random() < 0.2)
        assert t.choose(key, card, run_stats=stats, peek=peek) == \
            j.choose(key, card, run_stats=stats, peek=peek)
    js, ts = j.snapshot(), t.snapshot()
    for name in ("promoted", "demoted", "runTransitions", "trackedRows",
                 "enabled", "threshold", "runThreshold"):
        assert ts[name] == js[name], name


def test_hybrid_manager_kill_switch(monkeypatch):
    t = tres.HybridManager()
    assert t.choose(("i", "f", "standard", 1), 10) == ("sparse", 16)
    monkeypatch.setenv("PILOSA_TPU_TORCH_HYBRID", "0")
    assert not t.active()
    assert t.choose(("i", "f", "standard", 1), 10) == ("dense", 0)
    monkeypatch.delenv("PILOSA_TPU_TORCH_HYBRID")
    t.threshold = 0
    assert not t.active()
    assert [t.pad_slots(n) for n in (0, 8, 9, 4096)] == [8, 8, 16, 4096]


# -- storage statistics --------------------------------------------------------------


def test_row_statistics_match_jax(tmp_path):
    """row_cardinality, row_runs and row_run_stats of a data dir the JAX
    package wrote: sparse rows, runs across container boundaries, a dense
    row, and single-bit writes after the bulk import."""
    rng = np.random.default_rng(5)
    h = JaxHolder(str(tmp_path / "d")).open()
    idx = h.create_index("i", track_existence=False)
    f = idx.create_field("f")
    rows, cols = [], []
    for s in range(2):
        base = s * SW
        parts = {0: rng.choice(SW, 300, replace=False),
                 1: np.concatenate([np.arange(65530, 65545),
                                    np.arange(131072 - 3, 131072 + 4000),
                                    np.arange(SW - 70, SW)]),
                 2: rng.choice(SW, 20000, replace=False)}
        for r, c in parts.items():
            rows.append(np.full(len(c), r))
            cols.append(c + base)
    f.import_bits(np.concatenate(rows).tolist(), np.concatenate(cols).tolist())
    for c, r in ((65545, 1), (SW + 12, 1), (5, 0)):
        f.set_bit(r, c)
    f.clear_bit(1, 65533)
    want = {}
    for s in range(2):
        frag = f.view("standard").fragment(s)
        for r in (0, 1, 2, 3):
            want[(s, r)] = (frag.row_cardinality(r), frag.row_runs(r),
                            frag.row_run_stats(r))
    h.close()
    th = Holder(str(tmp_path / "d")).open()
    try:
        view = th.index("i").field("f").view("standard")
        for (s, r), (card, runs, stats) in want.items():
            frag = view.fragment(s)
            assert frag.row_cardinality(r) == card, (s, r)
            np.testing.assert_array_equal(frag.row_runs(r), runs)
            assert frag.row_run_stats(r) == stats, (s, r)
            assert frag.row_interval_count(r) == stats[0], (s, r)
        # a write re-keys the cached statistics
        frag = view.fragment(0)
        n_iv = frag.row_run_stats(1)[0]
        frag.set_bit(1, 200000)
        assert frag.row_run_stats(1)[0] == n_iv + 1
        assert frag.row_interval_count(1) == n_iv + 1
        assert frag.row_cardinality(1) == want[(0, 1)][0] + 1
    finally:
        th.close()


# -- the executor ------------------------------------------------------------------------


def test_executor_serves_each_form_and_materializes_twins(tmp_path):
    h = Holder(str(tmp_path / "x")).open()
    try:
        idx = h.create_index("i")
        f = idx.create_field("f")
        rng = np.random.default_rng(3)
        sets = {0: _cols(rng, 300), 1: np.arange(1000, 9000),
                2: _cols(rng, 20000, edges=False)}
        for r, c in sets.items():
            f.import_bits(np.full(c.size, r), c)
            idx.mark_exists(c)
        ex = Executor(h, device="cpu")
        a, b, c = (set(x.tolist()) for x in sets.values())
        assert ex.execute("i", "Count(Intersect(Row(f=0), Row(f=2)))") == \
            [len(a & c)]
        assert ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2)))") == \
            [len(b & c)]
        assert ex.execute("i", "Count(Intersect(Row(f=0), Row(f=1)))") == \
            [len(a & b)]
        snap = ex.hybrid_snapshot()
        assert snap["sparseUploads"] == 1 and snap["runUploads"] == 1
        assert snap["residentSparseBytes"] == 4 * tres.HybridManager.pad_slots(
            len(a))
        assert snap["residentRunBytes"] == 2 * 4 * 8
        # a dense consumer (a TopN recount) of the sparse row expands its
        # resident twin on the device: no host build
        dense = ex._row_leaf_dev(idx, "f", [0], 0)
        after = ex.hybrid_snapshot()
        assert after["materialized"] == 1
        assert after["denseUploads"] == snap["denseUploads"]
        assert set(np.flatnonzero(np.unpackbits(
            dense.numpy().view(np.uint8), bitorder="little")).tolist()) == a
    finally:
        h.close()


def test_run_row_kept_run_in_the_sparse_band_stays_exact(tmp_path):
    """Hysteresis keeps a run row run after writes drop it into the sparse
    band, where the chooser has no run statistics. The JAX package then
    sizes the leaf at 8 slots and loses every interval past the eighth;
    the port reads the statistics and stays exact."""
    h = Holder(str(tmp_path / "y")).open()
    try:
        idx = h.create_index("i")
        f = idx.create_field("f")
        starts = np.arange(40) * 200
        cols = np.concatenate([np.arange(s, s + 120) for s in starts])
        f.import_bits(np.zeros(cols.size, np.int64), cols)
        ex = Executor(h, device="cpu")
        ex.hybrid.threshold = 4000
        assert ex.execute("i", "Count(Row(f=0))") == [cols.size]  # run
        drop = cols[cols % 200 >= 90]  # 30 bits of each run: 3600 left
        f.import_bits(np.zeros(drop.size, np.int64), drop, clear=True)
        left = np.setdiff1d(cols, drop)
        assert ex.hybrid.last(("i", "f", "standard", 0)) == "run"
        assert ex.execute("i", "Count(Row(f=0))") == [left.size]
        assert ex.hybrid.last(("i", "f", "standard", 0)) == "run"
        got = ex.execute("i", "Row(f=0)")[0]
        np.testing.assert_array_equal(got.segments[0].astype(np.int64), left)
    finally:
        h.close()


def test_recreated_index_does_not_reuse_leaf_statistics(tmp_path):
    """A deleted and recreated index restarts its generations: the row
    below has the same generations both times, and its leaf must be sized
    from the new data, not the old statistics."""
    from pilosa_tpu_torch.api import API

    h = Holder(str(tmp_path / "z")).open()
    try:
        api = API(h, Executor(h, device="cpu"))
        for n in (10, 3000):
            api.create_index("i")
            api.create_field("i", "f")
            cols = np.arange(n) * 7
            api.import_bits("i", "f", np.zeros(n, np.int64), cols)
            assert api.query("i", "Count(Row(f=0))")["results"] == [n]
            api.delete_index("i")
    finally:
        h.close()
