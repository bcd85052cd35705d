"""The kernel wrappers' pure-Python choices, held without a card.

* sparse_plan: the work unit of sparse_intersect_dense (a warp or a block
  per shard), the block size and the grid, at
  every K from 1 to 16384, and a numpy model of the kernel's compaction
  (a warp's chunk of 32 V entries in V stripes of 32, a ballot per
  stripe, the warps' totals, a running offset from tile to tile, the
  sentinel tail) under each plan, against the plain version.
* program_plan: the depth class program_count's kernel is instantiated
  for, against encode_program's depth on random trees, and a Python model
  of the kernel's interpreter (top of the stack cached, a leaf followed by
  a binary op combined straight into it) that must give the plain result
  within the class's slots; whether a table fits the kernel's by-value
  parameter; and a round trip of the packed table back to the bytecode
  and the leaf order.

Bits and ids: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.ops import bitvector as tbv
from pilosa_tpu_torch.ops import hybrid
from pilosa_tpu_torch.ops import kernels

SENT = hybrid.SPARSE_SENTINEL
V = kernels.SPARSE_V  # entries per thread (the kernel's kSparseVec)

# K on each side of every edge of the plan: the warp unit's span (32 V =
# 256), the block unit's thread steps (every 256 entries up to 2048) and
# its tiles of 2048
EDGE_K = sorted({1, 8, 31, 32, 33}
                | {e + d for e in (256, 512, 768, 1024, 1792, 2048, 4096,
                                   8192, 12288) for d in (-1, 0, 1)}
                | {16384})


# -- sparse_intersect_dense ----------------------------------------------------


def test_sparse_plan_at_every_k():
    for k in range(1, 16385):
        plan = kernels.sparse_plan(k, 1029)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
        if plan.unit == "warp":
            assert k <= 32 * V
            assert plan.threads == 32 * kernels.SPARSE_WARPS
            shards_per_block = plan.threads // 32
            assert plan.grid == -(-1029 // shards_per_block)
        else:
            assert plan.unit == "block" and k > 256
            assert plan.grid == 1029
            # the threads follow K up to 256: no warp without entries in
            # the first tile
            assert plan.threads == min(256, 32 * -(-k // 256))
            assert (plan.threads - 32) * V < k


@pytest.mark.parametrize("s", [1, 3, 4, 5, 1029])
def test_sparse_plan_grid_covers_every_shard(s):
    for k in (8, 256, 257, 4096):
        plan = kernels.sparse_plan(k, s)
        per_block = plan.threads // 32 if plan.unit == "warp" else 1
        assert plan.grid * per_block >= s > (plan.grid - 1) * per_block


def _kernel_model(sp: np.ndarray, plane: np.ndarray, keep_hits: bool,
                  plan) -> np.ndarray:
    """One shard's row through the kernel's compaction, in numpy: warp w
    of a tile owns 32 V consecutive entries, lane l of it entries 32 j + l
    (stripe j); per stripe a ballot ranks the kept lanes; the warps'
    totals give each warp its offset in the tile."""
    k, v = sp.size, V
    warps = 1 if plan.unit == "warp" else plan.threads // 32
    tile = warps * 32 * v
    if plan.unit == "warp":
        assert k <= tile
    out = np.full(k, -1, dtype=np.int64)
    filled = 0
    for base in range(0, k, tile):
        idx = np.full(tile, SENT, dtype=np.int64)
        part = sp[base:base + tile]
        idx[:part.size] = part
        live = idx < SENT
        word = plane[np.minimum(idx, SENT - 1) >> 5]
        bit = (word >> (idx & 31)) & 1
        keep = live & ((bit == 1) if keep_hits else (bit == 0))
        keep = keep.reshape(warps, v, 32)      # [warp, stripe, lane]
        rows = idx.reshape(warps, v, 32)
        stripe = keep.sum(axis=2)               # each ballot's popcount
        totals = stripe.sum(axis=1)             # each warp's count
        warp_off = np.concatenate(([0], totals.cumsum()[:-1]))
        for w in range(warps):
            pos = filled + warp_off[w]
            for j in range(v):
                rank = keep[w, j].cumsum() - keep[w, j]  # kept lanes below
                for lane in np.flatnonzero(keep[w, j]):
                    assert out[pos + rank[lane]] == -1
                    out[pos + rank[lane]] = rows[w, j, lane]
                pos += stripe[w, j]
        filled += int(totals.sum())
    out[filled:] = SENT
    return out


@pytest.mark.parametrize("k", EDGE_K)
def test_sparse_kernel_model_matches_plain(k):
    rng = np.random.default_rng(k)
    s = 3
    rows = np.full((s, k), SENT, dtype=np.int64)
    for i, n in enumerate((k, k // 2, 0)):  # full, half full, sentinel only
        rows[i, :n] = np.sort(rng.choice(SENT, size=n, replace=False))
    plane = rng.integers(0, 2**32, size=(s, SENT // 32), dtype=np.int64)
    sp = torch.from_numpy(rows.astype(np.int32))
    dense = torch.from_numpy(plane.astype(np.uint32).view(np.int32))
    plan = kernels.sparse_plan(k, s)
    for keep_hits, plain in ((True, kernels.sparse_intersect_dense_plain),
                             (False, kernels.sparse_difference_dense_plain)):
        want = plain(sp, dense).numpy()
        for i in range(s):
            got = _kernel_model(rows[i], plane[i], keep_hits, plan)
            np.testing.assert_array_equal(got, want[i])


# -- program_count -------------------------------------------------------------


def _random_tree(rng, n_leaves: int, depth: int):
    if depth == 0 or rng.random() < 0.2:
        return ("leaf", int(rng.integers(n_leaves)))
    op = ["and", "or", "xor", "andnot", "not"][int(rng.integers(5))]
    if op == "not":
        return ("not", _random_tree(rng, n_leaves, depth - 1))
    return (op, *[_random_tree(rng, n_leaves, depth - 1)
                  for _ in range(int(rng.integers(1, 4)))])


def _balanced(lo: int, hi: int):
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    return ("xor", _balanced(lo, mid), _balanced(mid, hi))


def _interpreter_model(codes, args, leaves) -> tuple:
    """The kernel's count_program loop over whole planes: (result, most
    slots below the top in use)."""
    binary = {kernels.AND: tbv.band, kernels.OR: tbv.bor,
              kernels.XOR: tbv.bxor, kernels.ANDNOT: tbv.bandnot,
              kernels.RANDNOT: lambda a, b: tbv.bandnot(b, a)}
    slots, top, peak, pc, n = [], None, 0, 0, len(codes)
    while pc < n:
        c = codes[pc]
        if c == kernels.LEAF:
            x = leaves[args[pc]]
            nxt = codes[pc + 1] if pc + 1 < n else kernels.LEAF
            if pc > 0 and nxt in binary:
                top = binary[nxt](top, x)  # combined straight into the top
                pc += 1
            else:
                if pc > 0:
                    slots.append(top)
                    peak = max(peak, len(slots))
                top = x
        elif c == kernels.NOT:
            top = tbv.bnot(top)
        else:
            top = binary[c](slots.pop(), top)
        pc += 1
    assert not slots
    return top, peak


def test_depth_class_on_random_trees():
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(
        rng.integers(0, 2**32, size=(2, 64), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)) for _ in range(6)]
    trees = [_random_tree(rng, len(leaves), 6) for _ in range(300)]
    trees += [_balanced(0, 2 ** n) for n in range(5)]
    seen = set()
    for program in trees:
        program = tuple(program)
        codes, args, depth = kernels.encode_program(program)
        n_leaves = 16  # _balanced(0, 16) reads 16 leaves
        if depth > kernels.MAX_STACK:
            continue
        cls = kernels.depth_class(depth)
        smaller = [c for c in kernels.DEPTH_CLASSES if c < cls]
        assert cls >= depth and all(c < depth for c in smaller), (depth, cls)
        assert kernels.program_plan(program, n_leaves).depth_class == cls
        seen.add(cls)
        planes = [leaves[i % len(leaves)] for i in range(n_leaves)]
        got, peak = _interpreter_model(codes, args, planes)
        assert torch.equal(got, kernels.eval_program_plain(planes, program))
        assert peak <= depth - 1 <= cls - 1, (program, peak, depth)
    assert seen == set(kernels.DEPTH_CLASSES)


def test_depth_class_edges():
    assert [kernels.depth_class(d) for d in range(1, 17)] == \
        [2] * 2 + [4] * 2 + [16] * 12
    with pytest.raises(ValueError, match="operand stack of 17"):
        kernels.depth_class(17)


@pytest.mark.parametrize("n", [1, 2, 167, 168, 169, 300])
def test_program_fits_param(n):
    """An n-leaf chain has 2n - 1 instructions: its table fits the
    kernel's parameter while n + 2n - 1 <= PARAM_META (504)."""
    chain = ("and", *[("leaf", i) for i in range(n)]) if n > 1 else \
        ("leaf", 0)
    codes = kernels.encode_program(chain)[0]
    assert len(codes) == 2 * n - 1
    fits = 3 * n - 1 <= kernels.PARAM_META
    assert kernels.program_fits_param(n, len(codes)) == fits
    assert kernels.program_plan(chain, n).form == ("param" if fits
                                                   else "table")
    # 8 bytes an entry: within the kernel's 4032-byte parameter
    table = kernels.pack_program(np.arange(n) * 256, chain)
    assert (table.nbytes <= 4032) == fits


def test_param_form_refused_for_a_long_table():
    """Past PARAM_META entries the plan takes the device table at every
    depth class, and the CPU route gives the plain counts."""
    rng = np.random.default_rng(9)
    rows = [torch.from_numpy(
        rng.integers(0, 2**32, size=(2, 8), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)) for _ in range(4)]
    leaves = [rows[i % 4] for i in range(300)]
    chain = ("or", *[("leaf", i) for i in range(300)])
    for program, cls in ((chain, 2), (("xor", chain, _balanced(0, 4)), 4),
                         (("xor", chain, _balanced(0, 16)), 16)):
        assert kernels.program_plan(program, 300) == (
            kernels.encode_program(program)[2], cls, "table")
        assert torch.equal(kernels.program_count(leaves, program),
                           kernels.program_count_plain(leaves, program))


def _unpack(table: np.ndarray, n_leaves: int) -> tuple:
    """(leaf pointers, codes, args) of a packed table, as the kernel reads
    it: pointers first, then opcode | leaf << 8 per instruction."""
    ins = table[n_leaves:]
    return (table[:n_leaves].tolist(), tuple((ins & 0xFF).tolist()),
            tuple((ins >> 8).tolist()))


def test_pack_round_trip():
    rng = np.random.default_rng(8)
    for _ in range(100):
        program = _random_tree(rng, 7, 5)
        codes, args, _ = kernels.encode_program(program)
        ptrs = (rng.integers(1, 2**40, size=7) * 16).tolist()
        table = kernels.pack_program(ptrs, program)
        assert table.dtype == np.int64 and table.size == 7 + len(codes)
        got_ptrs, got_codes, got_args = _unpack(
            np.frombuffer(table.tobytes(), dtype=np.int64), 7)
        assert got_ptrs == ptrs
        assert got_codes == tuple(codes) and got_args == tuple(args)
