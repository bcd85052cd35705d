"""The pair stream's host plan against the JAX package.

The CountBatcher reduces a batch of K pair queries to its distinct
canonical pairs (ops/kernels.py plan_pairs), launches pair_stream_counts
over those once and maps the counts back to the K queries on the host.
Here the plan, the plain counts over the distinct pairs and the gather are
held against the CountBatcher's XLA form (pilosa_tpu/parallel/batcher.py
_batched_counts) and the interpret-mode Pallas pair_stream_counts, and the
port's CountBatcher against the same. Counts are integers: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel.batcher import _batched_counts
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.batcher import CountBatcher

COMMUTING = ("and", "or", "xor")


def _rows(rng, n: int, s: int, w: int) -> np.ndarray:
    x = rng.integers(0, 2**32, size=(n, s, w), dtype=np.uint64).astype(np.uint32)
    x[..., :3] = 0xFFFFFFFF
    x[..., 3:5] = 0x80000000
    return x


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _queries(rng, k: int, n_leaves: int):
    """k queries over n_leaves with heavy repetition, a query with
    ii == jj, and (0, 1) beside (1, 0)."""
    ii = rng.integers(0, n_leaves, size=k)
    jj = rng.integers(0, n_leaves, size=k)
    ii[0] = jj[0]
    if k >= 3:
        ii[1], jj[1], ii[2], jj[2] = 0, 1, 1, 0
    return ii.astype(np.int32), jj.astype(np.int32)


def _canonical(ii, jj, op):
    ii, jj = np.asarray(ii, np.int64), np.asarray(jj, np.int64)
    if op == "id":
        return ii, ii
    if op in COMMUTING:
        return np.minimum(ii, jj), np.maximum(ii, jj)
    return ii, jj


def _check_plan(plan, ii, jj, op):
    ci, cj = _canonical(ii, jj, op)
    pairs = list(zip(plan.a.tolist(), plan.b.tolist()))
    # distinct, canonical, and the inverse map gives back every query
    assert len(set(pairs)) == len(pairs) == len(set(zip(ci.tolist(),
                                                        cj.tolist())))
    np.testing.assert_array_equal(plan.a[plan.inverse], ci)
    np.testing.assert_array_equal(plan.b[plan.inverse], cj)
    if op in COMMUTING:
        assert bool((plan.a <= plan.b).all())
    if op == "id":
        np.testing.assert_array_equal(plan.a, plan.b)
    np.testing.assert_array_equal(plan.leaves,
                                  np.unique(np.concatenate([ci, cj])))


def _plan_counts(rows: np.ndarray, plan, op: str) -> torch.Tensor:
    """Plain counts over the distinct pairs, gathered back to the queries."""
    leaves = [_t(x) for x in rows]
    parts = kernels.pair_stream_counts_plain(leaves, plan.a, plan.b, op)
    return parts.index_select(0, torch.from_numpy(plan.inverse))


@pytest.mark.parametrize("s", (3, 2017))
@pytest.mark.parametrize("n_leaves", (2, 8, 16))
@pytest.mark.parametrize("k", (1, 3, 64, 512))
@pytest.mark.parametrize("op", kernels.PAIR_OPS)
def test_pair_plan_matches_batched_counts(op, k, n_leaves, s):
    """The plan, the plain counts over its distinct pairs and the gather
    equal the JAX batcher's [K, C] partials (C = 2 at S = 2017)."""
    rng = np.random.default_rng(k * 100 + n_leaves * 10 + s)
    rows = _rows(rng, n_leaves, s, 32)
    ii, jj = _queries(rng, k, n_leaves)
    plan = kernels.plan_pairs(ii, jj, op)
    _check_plan(plan, ii, jj, op)
    got = _plan_counts(rows, plan, op)
    want = np.asarray(_batched_counts(tuple(jnp.asarray(x) for x in rows),
                                      jnp.asarray(ii), jnp.asarray(jj),
                                      op=op))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper over every query gives the same
    np.testing.assert_array_equal(
        kernels.pair_stream_counts([_t(x) for x in rows], ii, jj, op).numpy(),
        want)


@pytest.mark.parametrize("n_leaves", (2, 8, 16))
@pytest.mark.parametrize("k", (1, 3, 64, 512))
def test_pair_plan_matches_pallas(k, n_leaves):
    """Totals over the chunks equal the interpret-mode Pallas kernel's
    per-query intersection counts."""
    rng = np.random.default_rng(7 * k + n_leaves)
    rows = _rows(rng, n_leaves, 3, 128)
    ii, jj = _queries(rng, k, n_leaves)
    plan = kernels.plan_pairs(ii, jj, "and")
    got = _plan_counts(rows, plan, "and").numpy().astype(np.int64).sum(axis=1)
    want = np.asarray(pk.pair_stream_counts(jnp.asarray(rows), jnp.asarray(ii),
                                            jnp.asarray(jj)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_leaves", (2, 8))
@pytest.mark.parametrize("k", (3, 64))
@pytest.mark.parametrize("op", kernels.PAIR_OPS)
def test_count_batcher_counts_distinct_pairs_once(op, k, n_leaves):
    """The port's CountBatcher launches over the distinct canonical pairs
    and maps the totals back to every query: equal to the JAX batcher's
    totals, S = 2017 (two chunks)."""
    rng = np.random.default_rng(31 * k + n_leaves)
    rows = _rows(rng, n_leaves, 2017, 8)
    leaves = [_t(x) for x in rows]
    ii, jj = _queries(rng, k, n_leaves)
    if op == "id":
        jj = ii
    payloads = [(leaves[i], leaves[j]) for i, j in zip(ii, jj)]
    batcher = CountBatcher()
    key = (op, tuple(leaves[0].shape), str(leaves[0].dtype), "cpu")
    parts, inverse = handle = batcher._dispatch(key, payloads)
    assert parts.shape[0] == len(set(zip(*_canonical(ii, jj, op))))
    got = batcher._finalize(key, handle, payloads)
    want = np.asarray(_batched_counts(tuple(jnp.asarray(x) for x in rows),
                                      jnp.asarray(ii), jnp.asarray(jj),
                                      op=op))
    assert got == want.astype(np.int64).sum(axis=1).tolist()
    assert all(type(c) is int for c in got)


def test_bench_headline_batch_reduces_to_its_distinct_pairs():
    """bench.py's kernel_intersect_count_qps_1Bcol batch (K = 512 pairs of
    distinct rows among 16, bench.py:295-299): at most 120 distinct
    pairs over the 16 leaves."""
    rng = np.random.default_rng(23)
    pairs = [tuple(rng.choice(16, size=2, replace=False)) for _ in range(512)]
    ii = np.array([p[0] for p in pairs])
    jj = np.array([p[1] for p in pairs])
    plan = kernels.plan_pairs(ii, jj, "and")
    assert plan.a.size <= 120
    np.testing.assert_array_equal(plan.leaves, np.arange(16))
    _check_plan(plan, ii, jj, "and")
    # andnot keeps (i, j) and (j, i) apart
    assert kernels.plan_pairs([0, 1], [1, 0], "andnot").a.size == 2
    assert kernels.plan_pairs([0, 1], [1, 0], "xor").a.size == 1


def test_sum_forms_are_explicit_arguments():
    x = _t(np.ones((2, 8), dtype=np.uint32))
    planes = _t(np.ones((3, 2, 8), dtype=np.uint32))
    with pytest.raises(ValueError, match="form"):
        kernels.bsi_sum_counts(planes, [x], form="tiled")
    kernels.reset_launch_counts()
    for form in kernels.SUM_FORMS:
        kernels.bsi_sum_counts(planes, [x, x], form=form)
    # the CPU takes the plain version: nothing launched, in either form
    assert kernels.form_launch_counts() == {
        "bsi_sum_counts/grid": 0, "bsi_sum_counts/staged": 0}
