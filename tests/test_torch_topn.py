"""The port's TopN and GroupBy kernels and modules against the JAX package.

Same numpy inputs, made from a seed, through the JAX function (Pallas in
interpret mode, as tests/test_pallas.py runs it) and the port's
counterpart on the CPU, where the kernel wrappers take their plain
versions. Integer counts: the tolerance is 0.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.models import cache as jcache
from pilosa_tpu.ops import bitvector as jbv
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.ops import topn as jtopn
from pilosa_tpu_torch.models import cache as tcache
from pilosa_tpu_torch.ops import bitvector as tbv
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops import topn as ttopn


def _planes(rng, *shape) -> np.ndarray:
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    x[..., :5] = 0xFFFFFFFF
    x[..., 5:9] = 0x80000000
    return x


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# -- topn_counts_packed (kernel 4) --------------------------------------------


@pytest.mark.parametrize("r", [1, 8, 100, 130])
def test_topn_counts_packed_matches_jax(r):
    """R candidates of [S, W] against the Pallas kernel (interpret mode) on
    the flattened [R, S*W] slab and the XLA tanimoto_counts_packed."""
    rng = np.random.default_rng(r)
    s, w = 2, 1024
    rows = _planes(rng, r, s, w)
    rows[0, :, 100:200] = 0
    src = _planes(rng, s, w)
    got = kernels.topn_counts_packed(list(_t(rows).unbind(0)), _t(src))
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, r)
    flat, sflat = rows.reshape(r, -1), src.reshape(-1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pk.topn_counts_packed(flat, sflat)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtopn.tanimoto_counts_packed(flat, sflat)))
    # a stacked slab takes the same route
    np.testing.assert_array_equal(
        kernels.topn_counts_packed(_t(rows), _t(src)).numpy(), got.numpy())


def test_top_rows_and_intersect_match_jax():
    rng = np.random.default_rng(4)
    rows = _planes(rng, 12, 3, 256)
    rows[3] = rows[7]  # a tie: slab order breaks it, as lax.top_k does
    src = _planes(rng, 3, 256)
    flat = rows.reshape(12, -1)
    for k in (1, 5, 50):
        gc, gi = ttopn.top_rows(_t(rows), k)
        wc, wi = pk.top_rows(flat, k)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        wc, wi = jtopn.top_rows(flat, k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        gc, gi = ttopn.top_rows_intersect(list(_t(rows).unbind(0)),
                                          _t(src), k)
        wc, wi = jtopn.top_rows_intersect(flat, src.reshape(-1), k)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_tanimoto_mask_matches_jax():
    rng = np.random.default_rng(5)
    rows = _planes(rng, 40, 2, 128)
    src = _planes(rng, 2, 128)
    src[:, 64:] = 0
    src[:, :64] = 0xFFFFFFFF
    rows[0] = src  # tanimoto 1
    rows[1] = 0
    rows[2] = 0
    rows[2][:, :32] = 0xFFFFFFFF  # tanimoto exactly 1/2: dropped at 50
    packed = ttopn.tanimoto_counts_packed(_t(rows), _t(src))
    inter, rc, sc = packed[0], packed[1], packed[2, 0]
    assert 2 * int(inter[2]) == int(rc[2] + sc - inter[2])
    for t in (0, 10, 49, 50, 99, 100):
        got = ttopn.tanimoto_mask(inter, rc, sc, t)
        want = jtopn.tanimoto_mask(jnp.asarray(inter.numpy()),
                                   jnp.asarray(rc.numpy()),
                                   jnp.asarray(int(sc)), jnp.asarray(t))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(ttopn.tanimoto_mask(inter, rc, sc, 49)[2])
    assert not bool(ttopn.tanimoto_mask(inter, rc, sc, 50)[2])


# -- cross_count_matrix (kernel 7) ---------------------------------------------


@pytest.mark.parametrize("p", [1, 8, 9])
@pytest.mark.parametrize("r", [1, 128, 130])
def test_cross_count_matrix_matches_jax(p, r):
    rng = np.random.default_rng(p * 1000 + r)
    prefix = _planes(rng, p, 2, 128)
    axis = _planes(rng, r, 2, 128)
    got = kernels.cross_count_matrix(_t(prefix), _t(axis))
    assert got.dtype == torch.int64 and tuple(got.shape) == (p, r)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pk.cross_count_matrix(prefix, axis)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbv.cross_count_matrix(prefix, axis)))


# -- GroupBy chunk helpers -------------------------------------------------------


def _chunk_args(rng):
    slab_a = _planes(rng, 5, 2, 256)
    slab_b = _planes(rng, 4, 2, 256)
    slab_c = _planes(rng, 6, 2, 256)
    slab_b[1, 0, :] = 0  # some zero groups
    slab_c[2] = 0
    # 4 prefixes padded to a chunk of 6; the padding gathers row 0
    idx = (np.array([0, 3, 4, 1, 0, 0], dtype=np.int32),
           np.array([2, 0, 1, 1, 0, 0], dtype=np.int32))
    return (slab_a, slab_b), idx, slab_c, 4


@pytest.mark.parametrize("bound", [32, 5])
def test_groupby_chunk_live_matches_jax(bound):
    """Padded n_valid, and a bound (5) smaller than the live set: the same
    (n_live, flat indices, counts) as the JAX contract."""
    rng = np.random.default_rng(8)
    slabs, idx, axis, n_valid = _chunk_args(rng)
    want = jbv.groupby_chunk_live(
        tuple(jnp.asarray(x) for x in slabs),
        tuple(jnp.asarray(i) for i in idx), jnp.asarray(axis),
        jnp.int32(n_valid), bound, pk.cross_count_matrix)
    got = tbv.groupby_chunk_live([_t(x) for x in slabs], idx, _t(axis),
                                 n_valid, bound)
    n_live, flat, counts = got
    assert int(n_live) == int(want[0])
    if bound == 5:
        assert int(n_live) > bound  # the caller must refetch
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))


def test_groupby_chunk_matrix_matches_jax():
    rng = np.random.default_rng(9)
    slabs, idx, axis, n_valid = _chunk_args(rng)
    want = jbv.groupby_chunk_matrix(
        tuple(jnp.asarray(x) for x in slabs),
        tuple(jnp.asarray(i) for i in idx), jnp.asarray(axis),
        jnp.int32(n_valid))
    got = tbv.groupby_chunk_matrix([_t(x) for x in slabs], idx, _t(axis),
                                   n_valid, kernels.cross_count_matrix_plain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # gather_prefix alone: the AND of the rows each axis names
    pref = tbv.gather_prefix([_t(x) for x in slabs],
                             [i[:n_valid] for i in idx])
    np.testing.assert_array_equal(
        pref.numpy().view(np.uint32),
        np.asarray(jbv.gather_prefix(slabs, tuple(i[:n_valid] for i in idx))))


def test_live_from_matrix_matches_jax():
    rng = np.random.default_rng(10)
    cmat = rng.integers(0, 3, size=(7, 9)).astype(np.int32)
    cmat[2] = 0
    for bound in (1, 10, 63, 100):
        want = jbv.live_from_matrix(jnp.asarray(cmat), bound)
        got = tbv.live_from_matrix(torch.from_numpy(cmat), bound)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- rank caches and the Pairs merge ---------------------------------------------


@pytest.mark.parametrize("kind", ["ranked", "lru", "none"])
def test_caches_match_jax(kind, tmp_path):
    """One random add / bulk_add sequence through both packages' caches;
    each reads the .cache file the other saved."""
    rng = np.random.default_rng(11)
    mine = tcache.make_cache(kind, 20)
    ref = jcache.make_cache(kind, 20)
    for step in range(400):
        if step % 25 == 24:
            pairs = [(int(r), int(c)) for r, c in zip(
                rng.integers(0, 60, size=8), rng.integers(0, 50, size=8))]
            mine.bulk_add(pairs)
            ref.bulk_add(pairs)
        else:
            r, c = int(rng.integers(0, 60)), int(rng.integers(-3, 50))
            mine.add(r, c)
            ref.add(r, c)
        assert mine.counts == ref.counts
        if step % 50 == 0:
            assert mine.top(7) == ref.top(7)
    mine.invalidate()
    ref.invalidate()
    assert mine.top() == ref.top()
    ids, cnts = mine.top_arrays()
    rids, rcnts = ref.top_arrays()
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(cnts, rcnts)
    path = str(tmp_path / "0.cache")
    mine.save(path)
    if kind == "none":
        assert not os.path.exists(path)
        return
    assert jcache.load_cache(path).counts == mine.counts
    ref.save(path)
    back = tcache.load_cache(path)
    assert type(back).__name__ == type(ref).__name__
    assert (back.counts, back.cache_size) == (ref.counts, ref.cache_size)


def test_merge_pair_arrays_matches_jax():
    rng = np.random.default_rng(12)
    arrays = []
    for _ in range(5):
        ids = rng.choice(40, size=15, replace=False).astype(np.int64)
        arrays.append((ids, rng.integers(1, 9, size=15).astype(np.int64)))
    arrays.append((np.empty(0, np.int64), np.empty(0, np.int64)))
    got = tcache.merge_pair_arrays(arrays)
    want = jcache.merge_pair_arrays(arrays)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lists = [list(zip(i.tolist(), c.tolist())) for i, c in arrays]
    assert tcache.merge_pairs(lists) == jcache.merge_pairs(lists)
    assert tcache.merge_pairs([]) == []


# -- concurrency: rank caches and counters under racing request threads ------


def test_racing_writers_and_topns_keep_caches_and_counters(tmp_path):
    """16 threads (more than cores, switch interval shortened) set and
    clear bits of the same rows while others run TopN recounts: every
    rank cache must end equal to its fragment's row counts (a lost or
    reordered cache update breaks it), and the recount counter must equal
    the rows recounted (a lost increment breaks it)."""
    import sys
    import threading

    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder

    holder = Holder(str(tmp_path / "d")).open()
    try:
        idx = holder.create_index("i")
        t = idx.create_field("t")
        f = idx.create_field("f")
        rng = np.random.default_rng(13)
        for r in range(6):
            cols = rng.integers(0, 2 << 20, size=400 * (r + 1))
            t.import_bits(np.full(cols.size, r), cols)
        f.import_bits(np.zeros(3000, dtype=np.int64),
                      rng.integers(0, 2 << 20, size=3000))
        ex = Executor(holder, device="cpu")
        errors = []

        def writer(seed: int) -> None:
            r = np.random.default_rng(seed)
            try:
                for _ in range(60):
                    row, col = int(r.integers(6)), int(r.integers(2 << 20))
                    if r.random() < 0.7:
                        t.set_bit(row, col)
                    else:
                        t.clear_bit(row, col)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        def reader() -> None:
            try:
                for _ in range(5):
                    ex.execute("i", "TopN(t, Row(f=0), ids=[0, 2, 4])")
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(12)]
        threads += [threading.Thread(target=reader) for _ in range(4)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors[:1]
        view = t.view("standard")
        for shard, frag in view.fragments.items():
            want = {r: frag.row_count(r) for r in frag.row_ids()}
            assert view.rank_caches[shard].counts == want, shard
        assert ex.topn_recount_rows == 4 * 5 * 3
    finally:
        holder.close()
