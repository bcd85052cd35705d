"""The port's kernels and dense algebra against the JAX package.

Every plain version in pilosa_tpu_torch/ops is held against the JAX
function on the same numpy inputs (Pallas in interpret mode, as
tests/test_pallas.py runs it): integer counts, so the tolerance is 0.
The CUDA kernels themselves run only on a card: tests/test_torch_card.py
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitvector as jbv
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel.batcher import _batched_counts
from pilosa_tpu.parallel.mesh import eval_row
from pilosa_tpu_torch.ops import bitvector as tbv
from pilosa_tpu_torch.ops import kernels

W = 1024  # small word count for interpret-mode speed
SHARDS = (1, 3, 16, 17)


def _planes(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _with_edge_words(x: np.ndarray) -> np.ndarray:
    """All-ones words and lone sign bits in every plane."""
    x = x.copy()
    x[..., :7] = 0xFFFFFFFF
    x[..., 7:13] = 0x80000000
    x[..., 13:17] = 0x7FFFFFFF
    return x


# -- dense algebra ------------------------------------------------------------


@pytest.mark.parametrize("name", ["band", "bor", "bxor", "bandnot"])
def test_bitwise_ops_match_jax(name):
    rng = np.random.default_rng(1)
    a = _with_edge_words(_planes(rng, 5, W))
    b = _planes(rng, 5, W)
    got = getattr(tbv, name)(_t(a), _t(b)).numpy().view(np.uint32)
    want = np.asarray(getattr(jbv, name)(a, b))
    np.testing.assert_array_equal(got, want)
    got = tbv.bnot(_t(a)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jbv.bnot(a)))


@pytest.mark.parametrize("name", ["popcount_rows", "intersect_count",
                                  "union_count", "difference_count",
                                  "xor_count"])
def test_popcounts_match_jax(name):
    rng = np.random.default_rng(2)
    a = _with_edge_words(_planes(rng, 6, W))
    b = _with_edge_words(_planes(rng, 6, W))
    b[:, 20:30] = 0
    if name == "popcount_rows":
        got, want = tbv.popcount(_t(a)), jbv.popcount(a)
    else:
        got = getattr(tbv, name)(_t(a), _t(b))
        want = getattr(jbv, name)(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_word_popcounts_edge_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555,
                      0xAAAAAAAA, 0x0F0F0F0F], dtype=np.uint32)
    got = tbv.word_popcounts(_t(words)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(words))


def test_dense_columns_roundtrip_matches_jax():
    rng = np.random.default_rng(3)
    cols = np.unique(rng.integers(0, 1 << 20, size=5000))
    dense = tbv.dense_from_columns(cols)
    np.testing.assert_array_equal(dense, jbv.dense_from_columns(cols))
    np.testing.assert_array_equal(
        tbv.columns_from_planes(_t(dense.reshape(1, -1)))[0], cols)


@pytest.mark.parametrize("density", [0.0, 1e-5, 0.01, 0.9])
def test_columns_from_planes_matches_jax_per_row(density):
    """The Row result decode over nonzero words only gives each shard
    row's columns as the JAX package's columns_from_dense does, empty
    rows, bit 31 and full words included."""
    rng = np.random.default_rng(int(density * 1e6))
    planes = (rng.random((5, 32768 * 32)) < density)
    planes = np.packbits(planes, axis=1, bitorder="little").view(np.uint32)
    planes = planes.reshape(5, 32768).copy()
    planes[1] = 0
    planes[2, :3] = (0xFFFFFFFF, 0x80000000, 1)
    got = tbv.columns_from_planes(_t(planes))
    assert len(got) == 5
    for row, cols in zip(planes, got):
        np.testing.assert_array_equal(cols, jbv.columns_from_dense(row))
        assert cols.dtype == np.int64


# -- intersect_count ------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
def test_intersect_count_matches_pallas(s):
    rng = np.random.default_rng(10 + s)
    a = _with_edge_words(_planes(rng, s, W))
    b = _with_edge_words(_planes(rng, s, W))
    got = kernels.intersect_count(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (s,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(pk.intersect_count(a, b)))


# -- program_count --------------------------------------------------------------

def _balanced(lo: int, hi: int):
    """A complete binary tree over leaf references lo..hi-1 (of 5 leaves):
    stack depth log2(hi - lo) + 1."""
    if hi - lo == 1:
        return ("leaf", lo % 5)
    mid = (lo + hi) // 2
    op = ("and", "or", "xor")[(hi - lo).bit_length() % 3]
    return (op, _balanced(lo, mid), _balanced(mid, hi))


PROGRAMS = {
    "nested": ("andnot", ("or", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
    "not_rooted": ("not", ("xor", ("leaf", 0), ("leaf", 1))),
    "chain5": ("and", ("leaf", 0), ("leaf", 1), ("leaf", 2), ("leaf", 3),
               ("leaf", 4)),
    "mixed": ("or", ("and", ("leaf", 0), ("not", ("leaf", 3))),
              ("xor", ("leaf", 1), ("andnot", ("leaf", 2), ("leaf", 4),
                                    ("leaf", 0)))),
    # stack depth 5: the kernel's deepest class (a local stack)
    "balanced16": _balanced(0, 16),
    # 5 leaves + 502 to 531 instructions: past the kernel's parameter
    # table, at each depth class (2, 4, 16)
    "table": ("xor", *[("leaf", i % 5) for i in range(250)],
              ("not", ("leaf", 3))),
    "table4": ("andnot", _balanced(0, 4),
               ("or", *[("leaf", i % 5) for i in range(250)])),
    "table16": ("xor", ("and", *[("leaf", i % 5) for i in range(250)]),
                _balanced(0, 16)),
}


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_count_matches_pallas(name, s):
    rng = np.random.default_rng(20 + s)
    leaves = _with_edge_words(_planes(rng, 5, s, W))
    leaves[2, :, 100:200] = 0
    program = PROGRAMS[name]
    plan = kernels.program_plan(program, 5)
    assert plan.depth_class == {"balanced16": 16, "table": 2, "table4": 4,
                                "table16": 16}.get(name, plan.depth_class)
    assert plan.form == ("table" if name.startswith("table") else "param")
    got = kernels.program_count([_t(x) for x in leaves], program)
    want = pk.program_count(tuple(jnp.asarray(x) for x in leaves), program)
    assert got.shape == (s,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the stacked [L, S, W] form takes the same path
    np.testing.assert_array_equal(
        kernels.program_count(_t(leaves), program).numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_eval_program_plain_matches_eval_row(name):
    rng = np.random.default_rng(30)
    leaves = _with_edge_words(_planes(rng, 5, 3, W))
    got = kernels.eval_program_plain([_t(x) for x in leaves], PROGRAMS[name])
    want = np.asarray(eval_row(tuple(jnp.asarray(x) for x in leaves),
                               program=PROGRAMS[name]))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# -- pair_stream_counts ---------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
def test_pair_stream_counts_matches_pallas(s):
    rng = np.random.default_rng(40 + s)
    rows = _with_edge_words(_planes(rng, 5, s, W))
    ii = np.array([0, 4, 2, 2, 3], dtype=np.int32)
    jj = np.array([1, 4, 0, 3, 3], dtype=np.int32)
    got = kernels.pair_stream_counts([_t(x) for x in rows], ii, jj, "and")
    assert got.dtype == torch.int32 and got.shape == (5, 1)
    want = pk.pair_stream_counts(jnp.asarray(rows), jnp.asarray(ii),
                                 jnp.asarray(jj))
    np.testing.assert_array_equal(got.numpy()[:, 0], np.asarray(want))


@pytest.mark.parametrize("s", (3, 2017, 4100))
@pytest.mark.parametrize("op", kernels.PAIR_OPS)
def test_pair_stream_counts_matches_batched_counts(op, s):
    """All five batcher ops, with S > 2016 giving C > 1 chunk partials."""
    rng = np.random.default_rng(50 + s)
    w = 32 if s > 16 else W  # keep the multi-chunk slabs small
    rows = _with_edge_words(_planes(rng, 3, s, w))
    ii = np.array([0, 1, 2, 2], dtype=np.int32)
    jj = np.array([1, 1, 0, 2], dtype=np.int32)
    got = kernels.pair_stream_counts(_t(rows), ii, jj, op)
    want = np.asarray(_batched_counts(tuple(jnp.asarray(x) for x in rows),
                                      jnp.asarray(ii), jnp.asarray(jj),
                                      op=op))
    assert got.shape == want.shape == (4, -(-s // 2016))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pair_stream_counts_rejects_bad_input():
    x = _t(np.zeros((2, 8), dtype=np.uint32))
    with pytest.raises(ValueError):
        kernels.pair_stream_counts([x], [0], [1], "and")
    with pytest.raises(ValueError):
        kernels.pair_stream_counts([x], [0], [0], "nand")
    with pytest.raises(TypeError):
        kernels.intersect_count(x.to(torch.int64), x.to(torch.int64))


# -- postfix encoder ------------------------------------------------------------


def _random_tree(rng, n_leaves: int, depth: int):
    if depth == 0 or rng.random() < 0.25:
        return ("leaf", int(rng.integers(n_leaves)))
    op = ["and", "or", "xor", "andnot", "not"][int(rng.integers(5))]
    if op == "not":
        return ("not", _random_tree(rng, n_leaves, depth - 1))
    return (op, *[_random_tree(rng, n_leaves, depth - 1)
                  for _ in range(int(rng.integers(1, 4)))])


def _run_postfix(codes, args, leaves) -> torch.Tensor:
    """The kernel's bytecode interpreter, in plain torch."""
    binary = {kernels.AND: tbv.band, kernels.OR: tbv.bor,
              kernels.XOR: tbv.bxor, kernels.ANDNOT: tbv.bandnot,
              kernels.RANDNOT: lambda x, y: tbv.bandnot(y, x)}
    stack = []
    for c, a in zip(codes, args):
        if c == kernels.LEAF:
            stack.append(leaves[a])
        elif c == kernels.NOT:
            stack.append(tbv.bnot(stack.pop()))
        else:
            y, x = stack.pop(), stack.pop()
            stack.append(binary[c](x, y))
    assert len(stack) == 1
    return stack[0]


def test_postfix_encoder_on_random_trees():
    rng = np.random.default_rng(60)
    leaves = [_t(x) for x in _with_edge_words(_planes(rng, 6, 2, 64))]
    for _ in range(200):
        program = _random_tree(rng, len(leaves), 5)
        codes, args, depth = kernels.encode_program(program)
        got = _run_postfix(codes, args, leaves)
        want = kernels.eval_program_plain(leaves, program)
        assert torch.equal(got, want), program
        # the stack depth the encoder reports is what the machine needs
        sp = peak = 0
        for c in codes:
            sp += 1 if c == kernels.LEAF else (0 if c == kernels.NOT else -1)
            peak = max(peak, sp)
        assert sp == 1 and peak == depth


def _full_tree(levels: int):
    """A complete binary AND tree over 2^levels references of leaf 0."""
    tree = ("leaf", 0)
    for _ in range(levels):
        tree = ("and", tree, tree)
    return tree


def test_program_caps():
    """Leaves and program length are uncapped; the operand stack grows with
    the tree's Strahler number, so only a 2^16-leaf program overflows it."""
    x = _t(np.full((2, 8), 0xF0F0F0F0, dtype=np.uint32))
    chain = ("and", *[("leaf", i) for i in range(40)])
    assert kernels.encode_program(chain)[2] == 2
    assert kernels.program_count([x] * 40, chain).tolist() == [128, 128]
    deep = ("leaf", 0)
    for _ in range(16):
        deep = ("or", ("leaf", 0), deep)   # nested 16 deep, deepest first
    assert kernels.encode_program(deep)[2] == 2
    minuend_last = ("andnot", ("leaf", 0), ("xor", deep, ("not", deep)))
    codes, _, depth = kernels.encode_program(minuend_last)
    assert codes[-1] == kernels.RANDNOT and depth == 3
    assert kernels.program_count([x], minuend_last).tolist() == [0, 0]
    assert kernels.encode_program(_full_tree(15))[2] == 16
    kernels.program_count([x], _full_tree(15))
    with pytest.raises(ValueError, match="operand stack of 17"):
        kernels.program_count([x], _full_tree(16))
    with pytest.raises(ValueError, match="missing leaf"):
        kernels.program_count([x], ("and", ("leaf", 0), ("leaf", 1)))


def test_program_count_over_40_leaves_matches_pallas():
    """More leaves than any fixed table would hold: Count(Union(...)) of 40
    Rows resolves each Row to a leaf of its own."""
    rng = np.random.default_rng(70)
    base = _with_edge_words(_planes(rng, 8, 3, W))
    leaves = [base[i % 8] for i in range(40)]
    program = ("or", ("xor", *[("leaf", i) for i in range(0, 40, 2)]),
               ("andnot", *[("leaf", i) for i in range(1, 40, 2)]))
    got = kernels.program_count([_t(x) for x in leaves], program)
    want = pk.program_count(tuple(jnp.asarray(x) for x in leaves), program)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_path():
    """On the CPU no kernel launches: the counts stay at zero."""
    kernels.reset_launch_counts()
    x = _t(np.ones((2, 8), dtype=np.uint32))
    kernels.intersect_count(x, x)
    kernels.program_count([x], ("leaf", 0))
    kernels.pair_stream_counts([x], [0], [0], "id")
    kernels.topn_counts_packed([x], x)
    kernels.cross_count_matrix(x[None], x[None])
    sp = torch.full((2, 8), 1 << 20, dtype=torch.int32)
    plane = torch.zeros((2, 1 << 15), dtype=torch.int32)
    kernels.sparse_intersect_dense(sp, plane)
    kernels.sparse_difference_dense(sp, plane)
    assert kernels.launch_counts() == {"pair_stream_counts": 0,
                                       "program_count": 0,
                                       "intersect_count": 0,
                                       "bsi_compare": 0,
                                       "bsi_sum_counts": 0,
                                       "topn_counts_packed": 0,
                                       "cross_count_matrix": 0,
                                       "sparse_intersect_dense": 0}
