"""The port's CUDA kernels and server on an NVIDIA card.

Imports neither JAX nor pilosa_tpu, so it runs on a machine that has only
PyTorch. Run on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_card.py

(--noconftest: tests/conftest.py sets up JAX). Without a card the gpu tests
skip; the tests that check the port refuses a missing card run anywhere.
Kernel and plain version agree exactly (integer counts, tolerance 0).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.device import resolve_device
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.mesh import DeviceRunner
from pilosa_tpu_torch.server import Server

PROGRAMS = [
    ("leaf", 0),
    ("and", ("leaf", 0), ("leaf", 1)),
    ("andnot", ("or", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
    ("not", ("xor", ("leaf", 0), ("leaf", 1))),
    ("and", ("leaf", 0), ("leaf", 1), ("leaf", 2), ("leaf", 3), ("leaf", 4)),
    ("or", ("and", ("leaf", 0), ("not", ("leaf", 3))),
     ("xor", ("leaf", 1), ("andnot", ("leaf", 2), ("leaf", 4), ("leaf", 0)))),
    # the minuend goes after its deeper subtrahend (RANDNOT)
    ("andnot", ("leaf", 4), ("or", ("leaf", 0), ("xor", ("leaf", 1),
                                                 ("leaf", 2)))),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _planes(rng, device, *shape) -> torch.Tensor:
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    x[..., :7] = 0xFFFFFFFF
    x[..., 7:13] = 0x80000000
    return torch.from_numpy(x.view(np.int32)).to(device)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceRunner()  # the default device is cuda


@pytest.mark.gpu
@pytest.mark.parametrize("s,w", [(3, 64), (2100, 256), (64, 32768)])
def test_kernels_match_plain_on_card(cuda_device, s, w):
    rng = np.random.default_rng(s)
    rows = list(_planes(rng, cuda_device, 5, s, w).unbind(0))
    kernels.reset_launch_counts()
    assert torch.equal(kernels.intersect_count(rows[0], rows[1]),
                       kernels.intersect_count_plain(rows[0], rows[1]))
    for program in PROGRAMS:
        assert torch.equal(kernels.program_count(rows, program),
                           kernels.program_count_plain(rows, program)), program
    wide = ("xor", *[("leaf", i) for i in range(40)])  # 40 leaf pointers
    many = [rows[i % 5] for i in range(40)]
    assert torch.equal(kernels.program_count(many, wide),
                       kernels.program_count_plain(many, wide))
    ii = rng.integers(0, 5, size=300)
    jj = rng.integers(0, 5, size=300)
    for op in kernels.PAIR_OPS:
        assert torch.equal(kernels.pair_stream_counts(rows, ii, jj, op),
                           kernels.pair_stream_counts_plain(rows, ii, jj, op)), op
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"pair_stream_counts": 5,
                                       "program_count": len(PROGRAMS) + 1,
                                       "intersect_count": 1,
                                       "bsi_compare": 0,
                                       "bsi_sum_counts": 0,
                                       "topn_counts_packed": 0,
                                       "cross_count_matrix": 0,
                                       "sparse_intersect_dense": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 10, 33])
@pytest.mark.parametrize("s,w", [(3, 64), (64, 32768)])
def test_bsi_kernels_match_plain_on_card(cuda_device, depth, s, w):
    from pilosa_tpu_torch.ops import bsi

    rng = np.random.default_rng(depth * 100 + s)
    planes = _planes(rng, cuda_device, depth, s, w)
    exists = _planes(rng, cuda_device, s, w)
    exists[-1, 20:40] = 0
    pred = int(rng.integers(0, 1 << min(depth, 62)))
    kernels.reset_launch_counts()
    for value in (0, (1 << depth) - 1, pred):
        bits = bsi.value_to_bits(value, depth)
        for op in kernels.BSI_OPS:
            assert torch.equal(
                kernels.bsi_compare(planes, exists, bits, op),
                kernels.bsi_compare_plain(planes, exists, bits, op)), (op, value)
    filters = [exists] + [_planes(rng, cuda_device, s, w) for _ in range(2)]
    for k in (1, 3):
        assert torch.equal(kernels.bsi_sum_counts(planes, filters[:k]),
                           kernels.bsi_sum_counts_plain(planes, filters[:k])), k
    assert torch.equal(kernels.bsi_sum_counts(planes, exists),
                       kernels.bsi_sum_counts_plain(planes, exists))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["bsi_compare"] == 3 * len(kernels.BSI_OPS)
    assert counts["bsi_sum_counts"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("s,w", [(1029, 32768), (2017, 1000), (3, 1000)])
def test_pair_stream_distinct_pairs_match_plain_on_card(cuda_device, s, w):
    """The pair stream as the CountBatcher launches it, every op: over the
    distinct canonical pairs of 300 queries on 50 leaves (ii == jj, (i, j)
    beside (j, i)) and of three queries on three leaves, mapped back to
    the queries, and over every query. S = 2017 spans two chunks; W = 1000
    is no multiple of the kernel's loop stride."""
    rng = np.random.default_rng(s + w)
    rows = list(_planes(rng, cuda_device, 50, s, w).unbind(0))
    ii = rng.integers(0, 50, size=300)
    jj = rng.integers(0, 50, size=300)
    ii[0], ii[1], jj[1], ii[2], jj[2] = jj[0], 3, 4, 4, 3
    kernels.reset_launch_counts()
    for op in kernels.PAIR_OPS:
        for qi, qj in ((ii, jj), ([0, 1, 0], [1, 0, 2])):
            want = kernels.pair_stream_counts_plain(rows, qi, qj, op)
            plan = kernels.plan_pairs(qi, qj, op)
            got = kernels.pair_stream_counts(rows, plan.a, plan.b, op)
            inverse = torch.from_numpy(plan.inverse).to(cuda_device)
            assert torch.equal(got.index_select(0, inverse), want), (op, len(qi))
            got = kernels.pair_stream_counts(rows, qi, qj, op)
            assert torch.equal(got, want), (op, len(qi))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pair_stream_counts"] == 20


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [10, 33])
@pytest.mark.parametrize("s,w", [(1029, 32768), (2017, 1000)])
def test_bsi_sum_forms_match_plain_on_card(cuda_device, depth, s, w):
    """Both forms of bsi_sum_counts at K = 1, 2, 32 and 33 filters (one
    past the staged form's 32-filter group), one filter given twice;
    depth 33 takes two 32-plane passes; W = 1000 is no multiple of the
    staged form's 128-vector tile."""
    rng = np.random.default_rng(depth * 10 + s)
    planes = _planes(rng, cuda_device, depth, s, w)
    filters = list(_planes(rng, cuda_device, 32, s, w).unbind(0))
    filters[1][:, 100:200] = 0
    filters.append(filters[2])
    kernels.reset_launch_counts()
    for k in (1, 2, 32, 33):
        want = kernels.bsi_sum_counts_plain(planes, filters[:k])
        for form in kernels.SUM_FORMS:
            got = kernels.bsi_sum_counts(planes, filters[:k], form=form)
            assert torch.equal(got, want), (k, form)
    for form in kernels.SUM_FORMS:
        assert torch.equal(
            kernels.bsi_sum_counts(planes, filters[0], form=form),
            kernels.bsi_sum_counts_plain(planes, filters[0])), form
    torch.cuda.synchronize()
    assert kernels.form_launch_counts() == {
        "bsi_sum_counts/grid": 5, "bsi_sum_counts/staged": 5}
    assert kernels.launch_counts()["bsi_sum_counts"] == 10


@pytest.mark.gpu
@pytest.mark.parametrize("s,w", [(3, 64), (2100, 256)])
def test_topn_and_cross_kernels_match_plain_on_card(cuda_device, s, w):
    """R = 130 candidates (past the Pallas 128-row block) and P = 9
    prefixes (past a 8-prefix tile); S = 2100 spans two 2016-shard chunks
    of partials."""
    rng = np.random.default_rng(s + w)
    rows = _planes(rng, cuda_device, 130, s, w)
    src = _planes(rng, cuda_device, s, w)
    prefix = _planes(rng, cuda_device, 9, s, w)
    kernels.reset_launch_counts()
    for r in (1, 8, 100, 130):
        assert torch.equal(
            kernels.topn_counts_packed(list(rows[:r].unbind(0)), src),
            kernels.topn_counts_packed_plain(list(rows[:r].unbind(0)), src)), r
    assert torch.equal(kernels.topn_counts_packed(rows, src),
                       kernels.topn_counts_packed_plain(rows, src))
    for p, r in ((1, 1), (8, 64), (9, 130), (4, 3)):
        assert torch.equal(
            kernels.cross_count_matrix(prefix[:p].contiguous(),
                                       rows[:r].contiguous()),
            kernels.cross_count_matrix_plain(prefix[:p], rows[:r])), (p, r)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["topn_counts_packed"] == 5
    assert counts["cross_count_matrix"] == 4


def _sparse_rows(rng, s: int, k: int) -> np.ndarray:
    """[s, k] sorted sentinel-padded rows: full rows, half-full rows, an
    empty (sentinel-only) row, entries on bit 31 and the last column."""
    sent = 1 << 20
    out = np.full((s, k), sent, dtype=np.int32)
    for i in range(s):
        if i % 5 == 2:
            continue  # sentinel only
        n = k if i % 2 == 0 else k // 2
        cols = np.sort(rng.choice(sent, size=n, replace=False))
        if n >= 3:
            cols[:3] = [31, 63, sent - 1]
            cols = np.sort(np.unique(cols))
            n = cols.size
        out[i, :n] = cols
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("s,k", [(3, 8), (1029, 8), (37, 16384), (257, 300),
                                 (9, 1), (9, 31), (9, 32), (9, 33), (9, 255),
                                 (9, 256), (9, 257), (9, 511), (9, 512),
                                 (9, 513), (9, 2048), (9, 2049), (9, 4096),
                                 (9, 4097), (130, 2048)])
def test_sparse_intersect_dense_matches_plain_on_card(cuda_device, s, k):
    """S not a multiple of any block size; K at each edge of the work
    units (sparse_plan: a warp per shard up to 32 x 8 entries, then a
    block per shard in tiles of up to 2048) and odd K (no 16-byte tail
    stores); rows of all hits (an all-ones plane), all misses (a zero
    plane), sentinel only, half full; both modes of the kernel (keep
    hits, keep misses)."""
    rng = np.random.default_rng(s * 7 + k)
    sp = torch.from_numpy(_sparse_rows(rng, s, k)).to(cuda_device)
    dense = _planes(rng, cuda_device, s, 1 << 15)
    dense[0] = -1  # every entry of row 0 hits
    dense[1] = 0   # every entry of row 1 misses
    kernels.reset_launch_counts()
    for fn, plain in ((kernels.sparse_intersect_dense,
                       kernels.sparse_intersect_dense_plain),
                      (kernels.sparse_difference_dense,
                       kernels.sparse_difference_dense_plain)):
        got = fn(sp, dense)
        assert torch.equal(got, plain(sp, dense)), fn.__name__
        assert torch.equal(plain(sp.cpu(), dense.cpu()), got.cpu())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sparse_intersect_dense"] == 2
    hits = kernels.sparse_intersect_dense(sp, dense)
    assert torch.equal(hits[0], sp[0])
    assert bool((hits[1] == 1 << 20).all())


@pytest.mark.gpu
def test_sparse_intersect_dense_unaligned_rows_on_card(cuda_device):
    """K a multiple of 4 but the rows, and so the output's tail, not on
    16-byte boundaries: the kernel reads any alignment."""
    rng = np.random.default_rng(11)
    s, k = 33, 64
    flat = torch.from_numpy(_sparse_rows(rng, s, k).reshape(-1)).to(cuda_device)
    buf = torch.empty(s * k + 1, dtype=torch.int32, device=cuda_device)
    buf[1:] = flat
    sp = buf[1:].view(s, k)
    assert sp.is_contiguous() and sp.data_ptr() % 16 == 4
    dense = _planes(rng, cuda_device, s, 1 << 15)
    assert torch.equal(kernels.sparse_intersect_dense(sp, dense),
                       kernels.sparse_intersect_dense_plain(sp, dense))
    assert torch.equal(kernels.sparse_difference_dense(sp, dense),
                       kernels.sparse_difference_dense_plain(sp, dense))


def _balanced(lo: int, hi: int):
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    op = ("and", "or", "xor")[(hi - lo).bit_length() % 3]
    return (op, _balanced(lo, mid), _balanced(mid, hi))


@pytest.mark.gpu
@pytest.mark.parametrize("s,w", [(3, 64), (130, 32768)])
def test_program_count_classes_and_forms_on_card(cuda_device, s, w):
    """Every depth class of the kernel (2, 4, 16) in both forms of the
    table: short programs take the kernel parameter, 300-leaf ones the
    device table (staged into shared memory), and a 7000-leaf chain a
    table read from device memory."""
    rng = np.random.default_rng(s + w)
    rows = list(_planes(rng, cuda_device, 8, s, w).unbind(0))
    leaves16 = [rows[i % 8] for i in range(16)]
    many = [rows[i % 8] for i in range(300)]
    chain = ("or", *[("leaf", i) for i in range(300)])
    cases = [
        (("andnot", ("leaf", 0), ("leaf", 1)), rows, 2, "param"),
        (("leaf", 3), rows, 2, "param"),
        (("and", *[("leaf", i) for i in range(8)]), rows, 2, "param"),
        (("or", ("xor", ("leaf", 0), ("leaf", 1)),
          ("andnot", ("leaf", 2), ("not", ("leaf", 3)))), rows, 4, "param"),
        (("not", ("andnot", ("leaf", 4), ("or", ("leaf", 0),
                                          ("xor", ("leaf", 1), ("leaf", 2))))),
         rows, 2, "param"),
        (_balanced(0, 8), rows, 4, "param"),
        (("andnot", ("leaf", 7), _balanced(0, 4), ("not", _balanced(4, 8))),
         rows, 4, "param"),
        (_balanced(0, 16), leaves16, 16, "param"),
        (("xor", _balanced(0, 8), ("not", _balanced(8, 16))), leaves16, 16,
         "param"),
        (chain, many, 2, "table"),
        (("xor", chain, _balanced(0, 4)), many, 4, "table"),
        (("andnot", _balanced(0, 8), ("not", chain)), many, 4, "table"),
        (("xor", chain, _balanced(0, 16)), many, 16, "table"),
    ]
    kernels.reset_launch_counts()
    for program, leaves, cls, form in cases:
        plan = kernels.program_plan(program, len(leaves))
        assert (plan.depth_class, plan.form) == (cls, form), program
        got = kernels.program_count(leaves, program)
        assert torch.equal(got, kernels.program_count_plain(leaves, program)), \
            program
    n = 7000  # past the shared-memory staging: read from device memory
    long_chain = ("or", *[("leaf", i) for i in range(n)])
    longest = [rows[i % 8] for i in range(n)]
    assert kernels.program_plan(long_chain, n).form == "table"
    assert torch.equal(kernels.program_count(longest, long_chain),
                       kernels.program_count_plain(longest, long_chain))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["program_count"] == len(cases) + 1


@pytest.mark.gpu
def test_program_count_stack_in_registers_on_card(cuda_device):
    """ptxas -v: the classes up to depth 4 keep the operand stack in
    registers (0-byte stack frame, no spills), in both forms."""
    from pilosa_tpu_torch.ops import _build

    _build.load()
    report = _build.ptxas_report(_build.build_log())
    shallow = {name: r for name, r in report.items()
               if "program_count" in name and ("ILi2E" in name or "ILi4E" in name)}
    assert len(shallow) == 4, sorted(report)
    for name, r in shallow.items():
        assert (r["stack"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), (
            name, r)


@pytest.mark.gpu
def test_counts_past_int32_finish_in_int64(cuda_device):
    """Full rows over 2100 shards hold 2100 * 2^20 bits, past 2^31: the
    per-chunk int32 partials must sum exactly in int64."""
    s, w = 2100, 32768
    ones = torch.full((2, s, w), -1, dtype=torch.int32, device=cuda_device)
    full = s * w * 32
    assert full > 2**31
    packed = kernels.topn_counts_packed(ones, ones[0])
    assert packed.dtype == torch.int64
    assert packed.cpu().tolist() == [[full, full]] * 3
    cmat = kernels.cross_count_matrix(ones[:1].contiguous(), ones)
    assert cmat.cpu().tolist() == [[full, full]]


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros((4, 30), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.intersect_count(x, x)
    deep = ("leaf", 0)
    for _ in range(16):  # a complete tree over 2^16 leaves: stack 17
        deep = ("and", deep, deep)
    y = torch.zeros((4, 32), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="caps"):
        kernels.program_count([y], deep)


@pytest.mark.gpu
def test_server_on_card_matches_numpy(cuda_device, tmp_path):
    rng = np.random.default_rng(9)
    cols = [np.unique(rng.integers(0, 3 << 20, size=30000)) for _ in range(3)]
    srv = Server(str(tmp_path / "d"), port=0).open()  # device defaults to cuda
    try:
        def post(path, body):
            req = urllib.request.Request(srv.uri + path, data=body.encode(),
                                         method="POST")
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read())

        post("/index/i", "{}")
        post("/index/i/field/f", "{}")
        for r, c in enumerate(cols):
            srv.api.import_bits("i", "f", np.full(c.size, r), c)
        a, b, c = (set(x.tolist()) for x in cols)
        exists = a | b | c
        want = {
            "Count(Row(f=0))": len(a),
            "Count(Intersect(Row(f=0), Row(f=1)))": len(a & b),
            "Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))": len(a & b & c),
            "Count(Union(Row(f=0), Row(f=2)))": len(a | c),
            "Count(Not(Row(f=1)))": len(exists - b),
            "Count(Xor(Row(f=1), Union(Row(f=0), Row(f=2))))":
                len(b ^ (a | c)),
        }
        for pql, n in want.items():
            assert post("/index/i/query", pql)["results"] == [n], pql
        got = post("/index/i/query?shards=1", "Row(f=2)")["results"][0]
        assert got["columns"] == sorted(x for x in c if (x >> 20) == 1)

        # BSI: an int field with a negative min, values on the columns of
        # row 0, Sum/Min/Max and Range through both BSI kernels
        post("/index/i/field/v",
             '{"options": {"type": "int", "min": -50, "max": 1000}}')
        vals = rng.integers(-50, 1001, size=cols[0].size)
        srv.api.import_values("i", "v", cols[0], vals)
        kernels.reset_launch_counts()
        bsi_want = {
            "Sum(field=v)": {"value": int(vals.sum()), "count": vals.size},
            "Sum(Range(v > 100), field=v)": {
                "value": int(vals[vals > 100].sum()),
                "count": int((vals > 100).sum())},
            "Min(field=v)": {"value": int(vals.min()),
                             "count": int((vals == vals.min()).sum())},
            "Max(field=v)": {"value": int(vals.max()),
                             "count": int((vals == vals.max()).sum())},
            "Count(Range(v >< [0, 10]))": int(((vals >= 0) & (vals <= 10)).sum()),
        }
        for pql, res in bsi_want.items():
            assert post("/index/i/query", pql)["results"] == [res], pql
        counts = kernels.launch_counts()
        assert counts["bsi_compare"] >= 2 and counts["bsi_sum_counts"] >= 2

        # TopN with a Src and a two-axis GroupBy, through both new kernels
        kernels.reset_launch_counts()
        inter = sorted(((len(x & a), -r) for r, x in enumerate((a, b, c))),
                       reverse=True)
        want_topn = [{"id": -nr, "count": n} for n, nr in inter[:2]]
        got = post("/index/i/query", "TopN(f, Row(f=0), n=2)")["results"][0]
        assert got == want_topn
        got = post("/index/i/query",
                   "GroupBy(Rows(field=f), Rows(field=f))")["results"][0]
        sets = (a, b, c)
        assert got == [{"group": [{"field": "f", "rowID": x},
                                  {"field": "f", "rowID": y}],
                        "count": len(sets[x] & sets[y])}
                       for x in range(3) for y in range(3)
                       if sets[x] & sets[y]]
        counts = kernels.launch_counts()
        assert counts["topn_counts_packed"] >= 1
        assert counts["cross_count_matrix"] >= 1

        # a sparse row (under 4096 bits per shard) against the dense rows:
        # the hybrid path, through sparse_intersect_dense
        d = np.unique(rng.integers(0, 3 << 20, size=900))
        post("/index/i/field/s", "{}")
        srv.api.import_bits("i", "s", np.zeros(d.size, np.int64), d)
        d = set(d.tolist())
        kernels.reset_launch_counts()
        assert post("/index/i/query", "Count(Intersect(Row(s=0), Row(f=1)))"
                    )["results"] == [len(d & b)]
        assert post("/index/i/query", "Count(Difference(Row(s=0), Row(f=2)))"
                    )["results"] == [len(d - c)]
        got = post("/index/i/query", "Intersect(Row(f=0), Row(s=0))")
        assert got["results"][0]["columns"] == sorted(d & a)
        assert kernels.launch_counts()["sparse_intersect_dense"] == 3
        assert srv.executor.hybrid.sparse_uploads == 1
    finally:
        srv.close()


@pytest.mark.gpu
def test_patch_functions_match_cpu_on_card(cuda_device):
    """patch_dense_words and patch_sparse_rows on CUDA tensors against the
    same calls on the CPU: bit 31, the last shard and word, an empty
    patch, a sparse row filled to K."""
    from pilosa_tpu_torch.ops import bitvector as bv

    rng = np.random.default_rng(17)
    s, w = 1024, 32768
    plane = _planes(rng, "cpu", s, w)
    flat = rng.choice(s * w, size=5000, replace=False)
    flat[:2] = [s * w - 1, (s - 1) * w]
    sidx, widx = flat // w, flat % w
    smask = rng.integers(0, 2**32, size=flat.size, dtype=np.uint64)
    smask = smask.astype(np.uint32)
    smask[:2] = 0x80000000
    cmask = rng.integers(0, 2**32, size=flat.size, dtype=np.uint64)
    cmask = cmask.astype(np.uint32) & ~smask
    dev = plane.to(cuda_device)
    got = bv.patch_dense_words(dev, sidx, widx, smask, cmask)
    want = bv.patch_dense_words(plane, sidx, widx, smask, cmask)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(dev.cpu(), plane), "the resident tensor changed"
    empty = np.empty(0, np.int64)
    assert torch.equal(bv.patch_dense_words(dev, empty, empty, empty,
                                            empty).cpu(), plane)
    k = 64
    cards = rng.integers(0, k + 1, size=s)
    cards[:3] = [k, 0, k - 1]
    sp = np.full((s, k), bv.SPARSE_SENTINEL, np.int32)
    adds = np.full((s, 4), bv.SPARSE_SENTINEL, np.int32)
    rems = np.full((s, 4), bv.SPARSE_SENTINEL, np.int32)
    for i, c in enumerate(cards.tolist()):
        cols = np.sort(rng.choice(1 << 20, size=c + 2, replace=False))
        sp[i, :c] = cols[:c]
        rems[i, :min(c, 2)] = cols[:min(c, 2)]
        if c + 2 - min(c, 2) <= k:  # stays within K
            adds[i, :2] = cols[c:c + 2]
    got = bv.patch_sparse_rows(torch.from_numpy(sp).to(cuda_device), adds,
                               rems)
    want = bv.patch_sparse_rows(torch.from_numpy(sp), adds, rems)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_ingest_apply_patch_and_read_on_card(cuda_device, tmp_path):
    """Set/Clear envelopes through the IngestBatcher on the card: the
    resident dense and sparse leaves are patched on the device and the
    reads after the writes, through the kernels, match numpy with no
    dense re-upload of a written row."""
    rng = np.random.default_rng(23)
    n_cols = 3 << 20
    dense = [np.unique(rng.integers(0, n_cols, size=40000))
             for _ in range(3)]
    sparse = np.unique(rng.integers(0, n_cols, size=600))
    srv = Server(str(tmp_path / "d"), port=0).open()  # device: cuda
    try:
        def post(path, body):
            req = urllib.request.Request(srv.uri + path, data=body.encode(),
                                         method="POST")
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read())

        def query(pql):
            return post("/index/i/query", pql)["results"]

        post("/index/i", "{}")
        post("/index/i/field/f", "{}")
        post("/index/i/field/s", "{}")
        for r, c in enumerate(dense):
            srv.api.import_bits("i", "f", np.full(c.size, r), c)
        srv.api.import_bits("i", "s", np.zeros(sparse.size, np.int64),
                            sparse)
        rows = [set(c.tolist()) for c in dense]
        srow = set(sparse.tolist())
        for q in ("Count(Row(f=0))", "Count(Row(f=1))", "Count(Row(f=2))",
                  "Count(Row(s=0))", "Count(Not(Row(f=0)))"):
            query(q)  # resident before the writes
        calls = []
        for _ in range(2000):
            col = int(rng.integers(0, n_cols))
            r = int(rng.integers(0, 4))
            target = srow if r == 3 else rows[r]
            field = "s=0" if r == 3 else f"f={r}"
            if rng.random() < 0.3 and target:
                col = next(iter(target))
                calls.append(f"Clear({col}, {field})")
                target.discard(col)
            else:
                calls.append(f"Set({col}, {field})")
                target.add(col)
        exists = set().union(*[set(c.tolist()) for c in dense],
                             set(sparse.tolist()))
        exists |= {int(c.split("(")[1].split(",")[0]) for c in calls
                   if c.startswith("Set")}
        before = srv.executor.hybrid_snapshot()
        for k in range(0, len(calls), 250):
            assert len(query("".join(calls[k:k + 250]))) == len(calls[k:k + 250])
        snap = srv.executor.ingest_snapshot()
        assert snap["patchedDense"] >= 3 and snap["patchDroppedDense"] == 0
        kernels.reset_launch_counts()
        a, b, c = rows
        want = {
            "Count(Row(f=0))": len(a),
            "Count(Intersect(Row(f=0), Row(f=1)))": len(a & b),
            "Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))": len(a & b & c),
            "Count(Intersect(Row(s=0), Row(f=1)))": len(srow & b),
        }
        for pql, n in want.items():
            assert query(pql) == [n], pql
        assert srv.executor.hybrid_snapshot()["denseUploads"] == \
            before["denseUploads"]
        assert query("Count(Not(Row(f=0)))") == [len(exists - a)]
        counts = kernels.launch_counts()
        assert counts["pair_stream_counts"] >= 2
        assert counts["program_count"] >= 1
        assert counts["sparse_intersect_dense"] >= 1
    finally:
        srv.close()
