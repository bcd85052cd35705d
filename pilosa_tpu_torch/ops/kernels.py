"""Wrappers of the hand-written Hopper kernels, with their plain versions.

Three kernels (csrc/bitmap_kernels.cu) carry the dense read path:

* ``pair_stream_counts``: K queries popcount(op(leaf[ii], leaf[jj])) as
  int32 partials per 2016-shard chunk. Replaces Pallas pair_stream_counts
  (pilosa_tpu/ops/pallas_kernels.py:234) and serves the CountBatcher, whose
  XLA form is pilosa_tpu/parallel/batcher.py _batched_counts (:436). The
  batcher launches it over a batch's distinct canonical pairs
  (``plan_pairs``) and maps the counts back to its queries on the host.
* ``program_count``: a nested bitmap program + popcount per shard, the
  program encoded as postfix bytecode over a table of leaf pointers (any
  number of leaves, any length): a by-value kernel parameter when it fits
  (``program_plan``), else a device table. Replaces Pallas program_count
  (pallas_kernels.py:108).
* ``intersect_count``: per-shard popcount(a & b). Replaces Pallas
  intersect_count (pallas_kernels.py:59).

Two more carry the BSI path (int fields), over a [D, S, W] plane slab:

* ``bsi_compare``: the lt/lte/gt/gte/eq/neq plane sweep against a
  predicate given as D bits -> int32[S, W] match mask. Replaces Pallas
  bsi_compare (pallas_kernels.py:451).
* ``bsi_sum_counts``: per-plane popcount(plane & filter) per shard plus the
  filter's own count, for one filter or K of them in one launch. Replaces
  Pallas bsi_sum_counts (pallas_kernels.py:504) and the PlaneSumBatcher's
  XLA form pilosa_tpu/parallel/batcher.py _batched_plane_sums (:590). Two
  forms (``form=``): "grid" holds one filter per block and streams the
  planes once per filter; "staged" stages up to 32 filters per block in
  shared memory and streams the planes once per group of 32. By default
  one filter takes "grid", more take "staged".

Two more carry TopN and GroupBy:

* ``topn_counts_packed``: per candidate leaf |leaf & src| and |leaf|, and
  |src| broadcast -> the Pallas [3, R] layout. Replaces Pallas
  topn_counts_packed (pallas_kernels.py:364; top_rows :388 calls it with a
  zero src). Serves the TopN walk and recount, and one-axis GroupBy.
* ``cross_count_matrix``: counts[p, r] = popcount(prefix[p] & axis[r])
  over all shards -> [P, R]. Replaces Pallas cross_count_matrix
  (pallas_kernels.py:182). Serves every GroupBy level past the first.

Both kernels write int32 partials per 2016-shard chunk ([C, 3, R] and
[C, P, R]): a full row holds 2^30 bits at 1024 shards, so from 2048 shards
on a total no longer fits int32. The wrappers finish the sum over chunks
in int64 on the device and return int64 tensors; their plain versions
count in int64 throughout.

One more carries the hybrid sparse/run read path (ops/hybrid.py):

* ``sparse_intersect_dense``: a sparse row int32[S, K] x a dense plane
  int32[S, W] -> the sorted sentinel-padded int32[S, K] of the entries
  whose bit is set. Replaces Pallas sparse_intersect_dense
  (pallas_kernels.py:295). Serves every sparse∩dense node of eval_hybrid.
  ``sparse_difference_dense`` launches the same kernel keeping the entries
  whose bit is clear (sparse &~ dense; XLA in the JAX package); both
  count as launches of sparse_intersect_dense. Its work unit (a warp or a
  block per shard) and entries per thread follow K (``sparse_plan``).

Two compositions carry the replica x shard mesh (parallel/mesh.py), over
blocked leaves (parallel/blocks.py: one block per mesh position):

* ``program_count_mesh``: the program_count kernel on each shard slot's
  blocks of the first replica row, the partials summed in int64.
  Replaces the Pallas mesh form program_count_mesh (pallas_kernels.py:571).
* ``pair_stream_counts_mesh``: the queries split over the replica rows
  (``scatter_queries``), the pair_stream_counts kernel on each position's
  blocks, each query's partials summed over the slots in int64. Replaces
  the Pallas mesh form pair_stream_counts_mesh (pallas_kernels.py:602)
  and serves the CountBatcher on a mesh.

Their block launches count under program_count and pair_stream_counts;
each call on the card also counts once in ``mesh_launch_counts``. Every
other wrapper given blocked operands runs per block (``blockwise``): row
results stay blocked, per-shard counts are concatenated over the slots,
summed counts are summed over them.

Routing: a CPU tensor takes the plain version (``<name>_plain``, plain
torch). A CUDA tensor launches the kernel or raises; nothing falls back.
Each wrapper adds one to its launch count where it launches its kernel;
bsi_sum_counts, which has two forms, also counts each launch under its
form (``form_launch_counts``). The same place records the launch in the
kernel statistics (utils/telemetry.py) under the family "pallas", the
family their TPU twins are counted under: the wrapper's host time since
its entry, the bytes it staged from the host, and the device time between
two CUDA events recorded on the launch's stream around the launch.

Layout checks: planes are C-contiguous int32 [S, W] tensors (a BSI slab
[D, S, W]) with W a multiple of 4 (the kernels load 16 bytes at a time),
all on one device.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from pilosa_tpu_torch.constants import WORDS_PER_SHARD
from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops import bitvector as bv
from pilosa_tpu_torch.ops import hybrid
from pilosa_tpu_torch.parallel.blocks import Blocked, blockwise
from pilosa_tpu_torch.utils import telemetry

# int32 partials per chunk of shards: 2016 shards x 2^20 bits < 2^31, so a
# chunk's count cannot wrap; the host finishes the sum in int64
# (pilosa_tpu/parallel/batcher.py:74-78).
SUM_SHARD_CHUNK = 2016

PAIR_OPS = ("and", "or", "xor", "andnot", "id")

# BSI comparison ops, in the kernel's order (csrc kLt..kNeq)
BSI_OPS = ("lt", "lte", "gt", "gte", "eq", "neq")

# the BSI sum kernel's grid carries the filter index in gridDim.y
MAX_SUM_FILTERS = 65535

# the two forms of bsi_sum_counts (csrc/bitmap_kernels.cu), and the staged
# form's filters per group (the kernel's kSumFilters) and block size
SUM_FORMS = ("grid", "staged")
SUM_GROUP = 32
_SUM_STAGED_THREADS = 128

# operand stack slots of the program interpreter (the kernel's kMaxStack)
MAX_STACK = 16

# the kernel is instantiated per class of stack depth: the classes up to 4
# keep the stack in registers, the last in local memory
DEPTH_CLASSES = (2, 4, MAX_STACK)

# int64 entries of the program table (leaf pointers, then instructions)
# that fit the kernel's by-value parameter (the kernel's kParamMeta: 4032
# bytes, within the classic 4 KB of kernel parameters)
PARAM_META = 504

# sparse_intersect_dense: shards per block of the warp unit, and entries
# per thread (the kernel's kSparseVec)
SPARSE_WARPS = 4
SPARSE_V = 8

# postfix opcodes, shared with the kernel; RANDNOT is b &~ a for the stack
# [.., a, b], so a minuend can be pushed after its deeper subtrahend
LEAF, AND, OR, XOR, ANDNOT, NOT, RANDNOT = range(7)
_BINARY = {"and": AND, "or": OR, "xor": XOR, "andnot": ANDNOT}

# enough resident blocks to fill the 132 SMs of an H100 a few times over
_TARGET_BLOCKS = 132 * 4
_THREADS = 256

_launch_lock = threading.Lock()
_launches = {"pair_stream_counts": 0, "program_count": 0,
             "intersect_count": 0, "bsi_compare": 0, "bsi_sum_counts": 0,
             "topn_counts_packed": 0, "cross_count_matrix": 0,
             "sparse_intersect_dense": 0}
_form_launches = {f"bsi_sum_counts/{f}": 0 for f in SUM_FORMS}
# calls of the two mesh compositions (their block launches count under
# program_count and pair_stream_counts)
_mesh_launches = {"program_count_mesh": 0, "pair_stream_counts_mesh": 0}

# the kernel family of every launch here (constants.KERNEL_FAMILY_REPS)
FAMILY = "pallas"

# the __global__ functions of csrc/bitmap_kernels.cu: what a device trace
# names (torch.profiler, DeviceProfiler)
DEVICE_KERNELS = ("pair_stream_kernel", "program_count_kernel",
                  "program_count_table_kernel", "intersect_count_kernel",
                  "bsi_compare_kernel", "bsi_sum_kernel",
                  "bsi_sum_staged_kernel", "topn_counts_kernel",
                  "cross_count_kernel", "sparse_dense_kernel")


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    with _launch_lock:
        return dict(_launches)


def form_launch_counts() -> dict:
    """Launches of bsi_sum_counts per "bsi_sum_counts/<form>" since the
    last reset; they sum to its launch_counts() entry."""
    with _launch_lock:
        return dict(_form_launches)


def mesh_launch_counts() -> dict:
    """Calls of program_count_mesh and pair_stream_counts_mesh on the card
    since the last reset; each call's block launches count under
    program_count and pair_stream_counts in launch_counts()."""
    with _launch_lock:
        return dict(_mesh_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for d in (_launches, _form_launches, _mesh_launches):
            for k in d:
                d[k] = 0


def _checked(lib, rc: int, what: str, token) -> None:
    """_build.check of a launch's return code; a failed launch first
    closes its kernel statistics token (telemetry.launch_begin's)."""
    if rc:
        telemetry.launch_abort(token)
    _build.check(lib, rc, what)


def _count_launch(name: str, token, t0: float, dev: torch.device,
                  arity: int, h2d_bytes: int = 0,
                  form: str | None = None) -> None:
    """One launch of `name`: its count, and its kernel statistics (token:
    telemetry.launch_begin's, taken right before the launch)."""
    with _launch_lock:
        _launches[name] += 1
        if form is not None:
            _form_launches[f"{name}/{form}"] += 1
    telemetry.launch_end(token, FAMILY, name, arity, t0, dev, h2d_bytes)


# ---------------------------------------------------------------------------
# Program encoding: nested tuples -> postfix bytecode
# ---------------------------------------------------------------------------
# program: ("leaf", i) | ("not", p) | (op, p1, p2, ...) with op in
# and/or/xor/andnot (pilosa_tpu/parallel/mesh.py:192-216). An n-ary op is a
# left fold. Operands go deepest first (Sethi-Ullman order): and/or/xor
# commute, and andnot's subtrahends commute among themselves, with RANDNOT
# when the deepest subtrahend goes before the minuend. The stack then grows
# with the tree's Strahler number, not its nesting depth: only a program
# over 2^MAX_STACK leaves or more overflows it.


def _encode(p) -> tuple[list, int]:
    """([(opcode, arg), ...] postfix code of p, stack depth it needs)."""
    op = p[0]
    if op == "leaf":
        return [(LEAF, int(p[1]))], 1
    if op == "not":
        code, depth = _encode(p[1])
        return code + [(NOT, 0)], depth
    if op not in _BINARY:
        raise ValueError(f"unknown op {op!r}")
    kids = [_encode(q) for q in p[1:]]
    if op == "andnot":
        first = kids[0]
        rest = sorted(kids[1:], key=lambda k: -k[1])
        if rest and rest[0][1] > first[1]:
            order = [rest[0], first, *rest[1:]]
            ops = [RANDNOT] + [ANDNOT] * (len(rest) - 1)
        else:
            order = [first, *rest]
            ops = [ANDNOT] * len(rest)
    else:
        order = sorted(kids, key=lambda k: -k[1])
        ops = [_BINARY[op]] * (len(kids) - 1)
    code, depth = list(order[0][0]), order[0][1]
    for (kid_code, kid_depth), o in zip(order[1:], ops):
        code += kid_code
        code.append((o, 0))
        depth = max(depth, 1 + kid_depth)
    return code, depth


@functools.lru_cache(maxsize=4096)
def encode_program(program) -> tuple:
    """(codes, args, stack depth) of `program`'s postfix bytecode."""
    code, depth = _encode(program)
    codes, args = zip(*code)
    return codes, args, depth


def _check_program(program, n_leaves: int) -> tuple:
    """`program`'s bytecode; raises where the kernel cannot run it."""
    codes, args, depth = encode_program(program)
    if depth > MAX_STACK:
        raise ValueError(
            f"program needs an operand stack of {depth} (kernel caps: stack "
            f"{MAX_STACK}, reached only by a program over 2^{MAX_STACK} "
            "leaves)")
    if max(args) >= n_leaves:
        raise ValueError("program references a missing leaf")
    return codes, args


@blockwise("map", 0)
def eval_program_plain(leaves, program) -> torch.Tensor:
    """Evaluate a nested program over [S, W] leaves in plain torch — the
    _eval of pilosa_tpu/parallel/mesh.py:197."""
    op = program[0]
    if op == "leaf":
        return leaves[program[1]]
    if op == "not":
        return bv.bnot(eval_program_plain(leaves, program[1]))
    fn = {"and": bv.band, "or": bv.bor, "xor": bv.bxor,
          "andnot": bv.bandnot}.get(op)
    if fn is None:
        raise ValueError(f"unknown op {op!r}")
    acc = eval_program_plain(leaves, program[1])
    for q in program[2:]:
        acc = fn(acc, eval_program_plain(leaves, q))
    return acc


def depth_class(depth: int) -> int:
    """The kernel instantiation a program of stack `depth` runs in."""
    for c in DEPTH_CLASSES:
        if depth <= c:
            return c
    raise ValueError(f"program needs an operand stack of {depth} (kernel "
                     f"caps: stack {MAX_STACK})")


@functools.lru_cache(maxsize=4096)
def _instructions(program) -> np.ndarray:
    """int64 instructions of `program`: opcode | leaf << 8."""
    codes, args, _ = encode_program(program)
    return (np.array(codes, dtype=np.int64)
            | (np.array(args, dtype=np.int64) << 8))


def pack_program(ptrs, program) -> np.ndarray:
    """The kernel's program table: int64 leaf pointers, then `program`'s
    instructions (opcode | leaf << 8), as the parameter and the device
    table hold it."""
    return np.concatenate([np.asarray(ptrs, dtype=np.int64),
                           _instructions(program)])


def program_fits_param(n_leaves: int, n_instr: int) -> bool:
    """Whether the table fits the kernel's by-value parameter."""
    return n_leaves + n_instr <= PARAM_META


class ProgramPlan(NamedTuple):
    """How program_count runs a program: its stack depth, the kernel's
    depth class, and the table's form ("param" or "table")."""

    depth: int
    depth_class: int
    form: str


def program_plan(program, n_leaves: int) -> ProgramPlan:
    codes, _, depth = encode_program(program)
    form = "param" if program_fits_param(n_leaves, len(codes)) else "table"
    return ProgramPlan(depth, depth_class(depth), form)


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------


def _leaf_list(leaves) -> list:
    if isinstance(leaves, torch.Tensor):
        if leaves.dim() != 3:
            raise ValueError(f"stacked leaves must be [L, S, W], got "
                             f"{tuple(leaves.shape)}")
        return list(leaves.unbind(0))
    return list(leaves)


def _check_planes(planes: Sequence[torch.Tensor]) -> torch.device:
    if not planes:
        raise ValueError("no leaves")
    first = planes[0]
    for t in planes:
        if t.dtype != torch.int32:
            raise TypeError(f"planes are int32 tensors, got {t.dtype}")
        if t.dim() != 2 or t.shape != first.shape:
            raise ValueError(f"leaves must share one [S, W] shape, got "
                             f"{tuple(t.shape)} and {tuple(first.shape)}")
        if t.device != first.device:
            raise ValueError("leaves on different devices")
        if not t.is_contiguous():
            raise ValueError("leaves must be contiguous")
    dev = first.device
    if dev.type == "cuda":
        if first.shape[1] % 4:
            raise ValueError(f"W={first.shape[1]} must be a multiple of 4 "
                             "for the kernels' 16-byte loads")
        for t in planes:
            if t.data_ptr() % 16:
                raise ValueError("leaf storage must be 16-byte aligned")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=1024)
def _split(work_items: int, vec_per_item: int, target: int = _TARGET_BLOCKS,
           threads: int = _THREADS) -> int:
    """Blocks per work item: `target` blocks overall, but at least one
    16-byte load per thread per block."""
    want = -(-target // max(work_items, 1))
    most = max(1, vec_per_item // threads)
    return int(max(1, min(want, most, 65535)))


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev: torch.device) -> int:
    """The handle of the current CUDA stream of `dev`, in one call."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _device_table(parts, dev: torch.device) -> torch.Tensor:
    """int64 arrays concatenated into one table on the device (one
    pinned host-to-device copy, ordered on the current stream)."""
    table = torch.from_numpy(np.concatenate(parts).astype(np.int64))
    return table.pin_memory().to(dev, non_blocking=True)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded at first use."""
    global _LIB
    if _LIB is None:
        _LIB = _build.load()
    return _LIB


# ---------------------------------------------------------------------------
# intersect_count
# ---------------------------------------------------------------------------


def intersect_count_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[S, W] x [S, W] -> int32[S] per-shard popcount(a & b)."""
    return bv.intersect_count(a, b)


@blockwise("cat", -1)
def intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[S, W] x [S, W] -> int32[S] per-shard intersection counts."""
    t0 = time.perf_counter()
    dev = _check_planes([a, b])
    if dev.type == "cpu":
        return intersect_count_plain(a, b)
    s, w = a.shape
    out = torch.empty(s, dtype=torch.int32, device=dev)
    if s == 0:
        return out
    lib = _lib()
    w4 = w // 4
    tok = telemetry.launch_begin(dev)
    rc = lib.pbk_intersect_count(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 s, w4, _split(s, w4), _stream(dev))
    _checked(lib, rc, "intersect_count", tok)
    _count_launch("intersect_count", tok, t0, dev, 2)
    return out


# ---------------------------------------------------------------------------
# program_count
# ---------------------------------------------------------------------------


def program_count_plain(leaves, program) -> torch.Tensor:
    """L x [S, W] + nested program -> int32[S] per-shard counts."""
    return bv.popcount(eval_program_plain(_leaf_list(leaves), program))


@functools.lru_cache(maxsize=4096)
def _program_static(program, n_leaves: int) -> tuple:
    """(instruction count, program_plan, int64 instructions) of a program
    the kernel can run over n_leaves leaves; raises where it cannot."""
    codes, _ = _check_program(program, n_leaves)
    return len(codes), program_plan(program, n_leaves), _instructions(program)


@blockwise("cat", -1)
def program_count(leaves, program) -> torch.Tensor:
    """L x [S, W] leaves (list or stacked [L, S, W]) + nested program ->
    int32[S]: the whole program and its popcount in one pass, no
    intermediate planes. The leaf pointers and bytecode go to the kernel
    as a by-value parameter when they fit, else as a device table
    (program_plan's form), so neither is capped; raises only for a program
    whose operand stack exceeds MAX_STACK (on any device)."""
    t0 = time.perf_counter()
    leaves = _leaf_list(leaves)
    dev = _check_planes(leaves)
    n_instr, plan, instr = _program_static(program, len(leaves))
    if dev.type == "cpu":
        return program_count_plain(leaves, program)
    s, w = leaves[0].shape
    out = torch.empty(s, dtype=torch.int32, device=dev)
    if s == 0:
        return out
    lib = _lib()
    ptrs = np.array([t.data_ptr() for t in leaves], dtype=np.int64)
    w4 = w // 4
    staged = 0
    if plan.form == "param":
        tok = telemetry.launch_begin(dev)
        rc = lib.pbk_program_count(ptrs.ctypes.data, instr.ctypes.data,
                                   len(leaves), n_instr, plan.depth_class,
                                   out.data_ptr(), s, w4, _split(s, w4),
                                   _stream(dev))
    else:
        table = _device_table([pack_program(ptrs, program)], dev)
        staged = table.numel() * 8
        tok = telemetry.launch_begin(dev)
        rc = lib.pbk_program_count_table(table.data_ptr(), len(leaves),
                                         n_instr, plan.depth_class,
                                         out.data_ptr(), s, w4, _split(s, w4),
                                         _stream(dev))
    _checked(lib, rc, "program_count", tok)
    _count_launch("program_count", tok, t0, dev, len(leaves), staged)
    return out


# ---------------------------------------------------------------------------
# pair_stream_counts
# ---------------------------------------------------------------------------


def _n_chunks(s: int) -> int:
    return -(-s // SUM_SHARD_CHUNK)


def _pair_fn(op: str):
    if op not in PAIR_OPS:
        raise ValueError(f"unknown pair op {op!r}")
    return {"and": bv.band, "or": bv.bor, "xor": bv.bxor,
            "andnot": bv.bandnot, "id": lambda a, b: a}[op]


def _indices(ii, jj, n_leaves: int) -> tuple[np.ndarray, np.ndarray]:
    ii = np.asarray(ii.cpu() if isinstance(ii, torch.Tensor) else ii,
                    dtype=np.int64).reshape(-1)
    jj = np.asarray(jj.cpu() if isinstance(jj, torch.Tensor) else jj,
                    dtype=np.int64).reshape(-1)
    if ii.shape != jj.shape:
        raise ValueError("ii and jj differ in length")
    if ii.size and (min(ii.min(), jj.min()) < 0
                    or max(ii.max(), jj.max()) >= n_leaves):
        raise ValueError("query index out of leaf range")
    return ii, jj


def pair_stream_counts_plain(leaves, ii, jj, op: str = "and") -> torch.Tensor:
    """K queries op(leaves[ii[k]], leaves[jj[k]]) -> int32[K, C] partial
    counts per 2016-shard chunk, C = ceil(S / 2016)."""
    leaves = _leaf_list(leaves)
    ii, jj = _indices(ii, jj, len(leaves))
    fn = _pair_fn(op)
    s = leaves[0].shape[0]
    c = _n_chunks(s)
    out = torch.zeros((len(ii), c), dtype=torch.int32,
                      device=leaves[0].device)
    for q, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        per_shard = bv.popcount(fn(leaves[i], leaves[j])).to(torch.int64)
        pad = c * SUM_SHARD_CHUNK - s
        per_shard = torch.nn.functional.pad(per_shard, (0, pad))
        out[q] = per_shard.view(c, SUM_SHARD_CHUNK).sum(dim=1).to(torch.int32)
    return out


class PairPlan(NamedTuple):
    """A batch of K pair queries reduced to P distinct canonical pairs:
    a, b int64[P], the leaf indices of pair p (b == a for "id"), in order
    of first use; inverse int64[K], query k's pair."""

    a: np.ndarray
    b: np.ndarray
    inverse: np.ndarray

    @property
    def leaves(self) -> np.ndarray:
        """The distinct leaves the pairs use, sorted."""
        return np.union1d(self.a, self.b)


def plan_pairs(ii, jj, op: str) -> PairPlan:
    """The distinct canonical pairs of the queries op(leaf[ii[k]],
    leaf[jj[k]]) and the inverse map (host only, no torch). and/or/xor
    commute, so (i, j) and (j, i) are one pair (i <= j); andnot does not;
    id keys on i alone."""
    _pair_fn(op)
    ii = np.asarray(ii, dtype=np.int64).reshape(-1).tolist()
    jj = np.asarray(jj, dtype=np.int64).reshape(-1).tolist()
    if len(ii) != len(jj):
        raise ValueError("ii and jj differ in length")
    rows: dict = {}
    inverse = []
    for i, j in zip(ii, jj):
        if op == "id":
            j = i
        elif op != "andnot" and j < i:
            i, j = j, i
        inverse.append(rows.setdefault((i, j), len(rows)))
    pairs = np.array(list(rows), dtype=np.int64).reshape(-1, 2)
    return PairPlan(a=pairs[:, 0], b=pairs[:, 1],
                    inverse=np.array(inverse, dtype=np.int64))


@blockwise("cat", -1)
def pair_stream_counts(leaves, ii, jj, op: str = "and") -> torch.Tensor:
    """K queries op(leaves[ii[k]], leaves[jj[k]]) over L x [S, W] leaves
    (list of resident tensors, or stacked [L, S, W]) -> int32[K, C]
    partials per 2016-shard chunk. op in and/or/xor/andnot/id; id reads
    only leaves[ii[k]]. The leaves are passed to the kernel as a device
    table of pointers, so they are never restacked."""
    t0 = time.perf_counter()
    leaves = _leaf_list(leaves)
    dev = _check_planes(leaves)
    if dev.type == "cpu":
        return pair_stream_counts_plain(leaves, ii, jj, op)
    code = PAIR_OPS.index(op) if op in PAIR_OPS else None
    if code is None:
        raise ValueError(f"unknown pair op {op!r}")
    ii, jj = _indices(ii, jj, len(leaves))
    s, w = leaves[0].shape
    k = int(ii.size)
    c = _n_chunks(s)
    out = torch.zeros((k, c), dtype=torch.int32, device=dev)
    if k == 0 or s == 0:
        return out
    lib = _lib()
    ptrs = np.array([t.data_ptr() for t in leaves], dtype=np.int64)
    meta = _device_table([ptrs, ii, jj], dev)
    w4 = w // 4
    chunk_vec = min(s, SUM_SHARD_CHUNK) * w4
    tok = telemetry.launch_begin(dev)
    rc = lib.pbk_pair_stream_counts(meta.data_ptr(), len(leaves), k, code,
                                    out.data_ptr(), s, w4, SUM_SHARD_CHUNK,
                                    c, _split(k * c, chunk_vec), _stream(dev))
    _checked(lib, rc, "pair_stream_counts", tok)
    _count_launch("pair_stream_counts", tok, t0, dev, len(leaves),
                  meta.numel() * 8)
    return out


# ---------------------------------------------------------------------------
# Mesh compositions: program_count_mesh and pair_stream_counts_mesh
# ---------------------------------------------------------------------------
# pilosa_tpu/ops/pallas_kernels.py:553-613 runs the single-device Pallas
# kernel under shard_map, each device on its local shard slice, and psums
# the partials over "shard" outside the pallas_call. Here the same: the
# hand-written kernel is launched on each position's block of the blocked
# leaves (parallel/blocks.py), and the partials are summed over the shard
# slots in int64. The replicas hold copies of the same data, so a program's
# count needs one replica row; the pair stream splits its queries over the
# replica rows instead, each row counting its part against its own copy.


def _mesh_layout(mesh, leaves) -> tuple[int, int]:
    """(replicas, shard slots) of `mesh`, checked against the blocked
    leaves."""
    n_rep = mesh.shape.get("replica", 1)
    n_slots = mesh.shape["shard"]
    for t in leaves:
        if not isinstance(t, Blocked):
            raise TypeError("mesh kernels take blocked leaves "
                            "(DeviceRunner.put_leaf on a mesh)")
        if (t.n_replicas, t.n_slots) != (n_rep, n_slots):
            raise ValueError(
                f"leaf blocked {t.n_replicas}x{t.n_slots}, mesh is "
                f"{n_rep}x{n_slots}")
    return n_rep, n_slots


def _count_mesh_call(name: str, dev: torch.device) -> None:
    """One call of a mesh composition (its block launches are counted
    under their kernel); counted where the blocks lie on the card."""
    if dev.type == "cuda":
        with _launch_lock:
            _mesh_launches[name] += 1


def _program_count_mesh(mesh, leaves, program, fn) -> int:
    leaves = list(leaves)
    _n_rep, n_slots = _mesh_layout(mesh, leaves)
    dev = leaves[0].device
    total = None
    for s in range(n_slots):
        part = fn([t.blocks[0][s] for t in leaves], program).to(
            device=dev).sum(dtype=torch.int64)
        total = part if total is None else total + part
    return int(total)


def program_count_mesh(mesh, leaves, program) -> int:
    """Blocked [S, W] leaves (sharded over the mesh's shard axis,
    replicated over its replica axis) + nested program -> total count:
    the program_count kernel on each shard slot's blocks of the first
    replica row, the per-shard partials summed over the slots in int64.
    Replaces the Pallas mesh form pallas_kernels.py:571."""
    out = _program_count_mesh(mesh, leaves, program, program_count)
    _count_mesh_call("program_count_mesh", list(leaves)[0].device)
    return out


def program_count_mesh_plain(mesh, leaves, program) -> int:
    """program_count_mesh through program_count_plain on every block."""
    return _program_count_mesh(mesh, leaves, program, program_count_plain)


def scatter_queries(n_rep: int, ii, jj) -> tuple:
    """(parts, k): the query indices padded with (0, 0) queries to a
    multiple of the replica count and cut into n_rep contiguous parts,
    part r for replica row r (pilosa_tpu/parallel/mesh.py:350-367: ii/jj
    placed P("replica")); k the real count, whose padding is dropped."""
    ii = np.asarray(ii.cpu() if isinstance(ii, torch.Tensor) else ii,
                    dtype=np.int64).reshape(-1)
    jj = np.asarray(jj.cpu() if isinstance(jj, torch.Tensor) else jj,
                    dtype=np.int64).reshape(-1)
    if ii.shape != jj.shape:
        raise ValueError("ii and jj differ in length")
    k = int(ii.size)
    pad = (-k) % n_rep
    if pad:
        ii = np.concatenate([ii, np.zeros(pad, np.int64)])
        jj = np.concatenate([jj, np.zeros(pad, np.int64)])
    per = ii.size // n_rep
    return [(ii[r * per:(r + 1) * per], jj[r * per:(r + 1) * per])
            for r in range(n_rep)], k


def _pair_stream_mesh(mesh, rows, ii, jj, op: str, fn) -> np.ndarray:
    rows = [rows] if isinstance(rows, Blocked) else list(rows)
    n_rep, n_slots = _mesh_layout(mesh, rows)
    if len(rows) == 1 and rows[0].dim() == 3:
        def block(r, s):  # a stacked [R, S, W] slab
            return rows[0].blocks[r][s]
    else:
        def block(r, s):
            return [t.blocks[r][s] for t in rows]
    parts, k = scatter_queries(n_rep, ii, jj)
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    dev = rows[0].device
    out = []
    for r, (ir, jr) in enumerate(parts):
        acc = None
        for s in range(n_slots):
            part = fn(block(r, s), ir, jr, op).to(device=dev).sum(
                dim=1, dtype=torch.int64)
            acc = part if acc is None else acc + part
        out.append(acc)
    return torch.cat(out).cpu().numpy()[:k]


def pair_stream_counts_mesh(mesh, rows, ii, jj,
                            op: str = "and") -> np.ndarray:
    """K queries op(rows[ii[k]], rows[jj[k]]) on a replica x shard mesh ->
    host int64[K]. `rows` is a list of blocked [S, W] leaves or one
    blocked [R, S, W] slab. The queries are split over the replica rows
    (scatter_queries), each row runs the pair_stream_counts kernel on each
    of its shard slots' blocks against its own copy of the data, and each
    query's partials are summed over the slots in int64. Replaces the
    Pallas mesh form pallas_kernels.py:602."""
    out = _pair_stream_mesh(mesh, rows, ii, jj, op, pair_stream_counts)
    first = rows if isinstance(rows, Blocked) else list(rows)[0]
    _count_mesh_call("pair_stream_counts_mesh", first.device)
    return out


def pair_stream_counts_mesh_plain(mesh, rows, ii, jj,
                                  op: str = "and") -> np.ndarray:
    """pair_stream_counts_mesh through pair_stream_counts_plain on every
    block."""
    return _pair_stream_mesh(mesh, rows, ii, jj, op,
                             pair_stream_counts_plain)


# ---------------------------------------------------------------------------
# BSI: bsi_compare and bsi_sum_counts over a [D, S, W] plane slab
# ---------------------------------------------------------------------------


def _check_slab(planes: torch.Tensor, masks: Sequence[torch.Tensor]):
    """Device of a [D, S, W] slab and its [S, W] masks; raises where the
    kernels cannot take them."""
    if not isinstance(planes, torch.Tensor) or planes.dim() != 3:
        raise ValueError("planes must be an int32 [D, S, W] tensor")
    if planes.shape[0] < 1:
        raise ValueError("planes must have a depth of at least 1")
    if planes.dtype != torch.int32:
        raise TypeError(f"planes are int32 tensors, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    for m in masks:
        if m.shape != planes.shape[1:]:
            raise ValueError(f"mask shape {tuple(m.shape)} does not match "
                             f"the planes' [S, W] {tuple(planes.shape[1:])}")
    dev = _check_planes(list(masks))
    if planes.device != dev:
        raise ValueError("planes and masks on different devices")
    if dev.type == "cuda" and planes.data_ptr() % 16:
        raise ValueError("plane storage must be 16-byte aligned")
    return dev


def _pred_tensor(pred_bits, depth: int, dev: torch.device) -> torch.Tensor:
    """Predicate bits as an int32[depth] tensor on `dev`."""
    if isinstance(pred_bits, torch.Tensor):
        pred = pred_bits.to(device=dev, dtype=torch.int32).reshape(-1)
    else:
        arr = np.asarray(pred_bits, dtype=np.int32).reshape(-1)
        pred = torch.from_numpy(arr)
        if dev.type == "cuda":
            pred = pred.pin_memory().to(dev, non_blocking=True)
    if pred.shape[0] != depth:
        raise ValueError(f"{pred.shape[0]} predicate bits for a depth of "
                         f"{depth}")
    return pred.contiguous()


def bsi_compare_plain(planes: torch.Tensor, exists: torch.Tensor, pred_bits,
                      op: str) -> torch.Tensor:
    """The comparison sweep of pilosa_tpu/ops/bsi.py:124-163 in torch
    bitwise ops on int32: columns of `exists` whose stored value `op` the
    predicate, as an [S, W] mask."""
    if op not in BSI_OPS:
        raise ValueError(f"unknown comparison op {op!r}")
    depth = planes.shape[0]
    # -bit: all ones (-1) where the predicate bit is 1, else 0
    m = -(_pred_tensor(pred_bits, depth, planes.device) & 1)
    if op in ("eq", "neq"):
        r = exists
        for i in range(depth):
            r = bv.band(r, bv.bnot(bv.bxor(planes[i], m[i])))
        return bv.bandnot(exists, r) if op == "neq" else r
    matched = torch.zeros_like(exists)
    remaining = exists
    for i in range(depth - 1, -1, -1):
        p = planes[i]
        if op in ("lt", "lte"):
            # predicate bit 1: a 0 here is strictly less
            matched = bv.bor(matched, bv.band(bv.bandnot(remaining, p), m[i]))
        else:
            # predicate bit 0: a 1 here is strictly greater
            matched = bv.bor(matched, bv.bandnot(bv.band(remaining, p), m[i]))
        remaining = bv.band(remaining, bv.bnot(bv.bxor(p, m[i])))
    if op in ("lte", "gte"):
        matched = bv.bor(matched, remaining)
    return matched


@blockwise("map", 0)
def bsi_compare(planes: torch.Tensor, exists: torch.Tensor, pred_bits,
                op: str) -> torch.Tensor:
    """[D, S, W] planes x [S, W] exists x int32[D] predicate bits (LSB
    first) -> int32[S, W] mask of the columns whose stored value `op` the
    predicate, op in lt/lte/gt/gte/eq/neq. One pass over the planes; the
    predicate reaches the kernel as data."""
    t0 = time.perf_counter()
    if op not in BSI_OPS:
        raise ValueError(f"unknown comparison op {op!r}")
    dev = _check_slab(planes, [exists])
    if dev.type == "cpu":
        return bsi_compare_plain(planes, exists, pred_bits, op)
    d, s, w = planes.shape
    pred = _pred_tensor(pred_bits, d, dev)
    out = torch.empty((s, w), dtype=torch.int32, device=dev)
    n = s * w // 4
    if n == 0:
        return out
    lib = _lib()
    blocks = min(-(-n // _THREADS), 1 << 20)
    tok = telemetry.launch_begin(dev)
    rc = lib.pbk_bsi_compare(planes.data_ptr(), exists.data_ptr(),
                             pred.data_ptr(), d, BSI_OPS.index(op),
                             out.data_ptr(), n, blocks, _stream(dev))
    _checked(lib, rc, "bsi_compare", tok)
    _count_launch("bsi_compare", tok, t0, dev, 2,
                  0 if isinstance(pred_bits, torch.Tensor) else d * 4)
    return out


def bsi_sum_counts_plain(planes: torch.Tensor, filters) -> torch.Tensor:
    """Per plane popcount(plane & filter) per shard, plus the filter's own
    count: int32[D+1, S] for one [S, W] filter, int32[K, D+1, S] for a
    list of K."""
    single = isinstance(filters, torch.Tensor)
    out = []
    for f in ([filters] if single else list(filters)):
        rows = [bv.popcount(bv.band(planes[d], f))
                for d in range(planes.shape[0])]
        out.append(torch.stack(rows + [bv.popcount(f)]))
    return out[0] if single else torch.stack(out)


def sum_form(k: int) -> str:
    """The form a K-filter sum takes by default: the grid form for one
    filter (it reads each plane once already), staged for more."""
    return "grid" if k == 1 else "staged"


@blockwise("cat", -1)
def bsi_sum_counts(planes: torch.Tensor, filters,
                   form: str | None = None) -> torch.Tensor:
    """[D, S, W] planes x filters -> per-plane per-shard counts of
    plane & filter with the filter's own count as row D: int32[D+1, S]
    (the Pallas layout) for one [S, W] filter tensor, int32[K, D+1, S] for
    a list of K resident filter tensors, passed to one launch as a device
    table of pointers. form is "grid", "staged" or None (sum_form picks).
    No depth cap; a count is at most 2^20, so int32 cannot wrap, and the
    caller finishes totals in int64."""
    t0 = time.perf_counter()
    single = isinstance(filters, torch.Tensor)
    masks = [filters] if single else list(filters)
    if not masks:
        raise ValueError("no filters")
    if form is not None and form not in SUM_FORMS:
        raise ValueError(f"unknown bsi_sum_counts form {form!r}")
    if len(masks) > MAX_SUM_FILTERS:
        raise ValueError(f"{len(masks)} filters in one launch (the kernel "
                         f"takes at most {MAX_SUM_FILTERS})")
    dev = _check_slab(planes, masks)
    if dev.type == "cpu":
        return bsi_sum_counts_plain(planes, filters)
    d, s, w = planes.shape
    k = len(masks)
    out = torch.zeros((k, d + 1, s), dtype=torch.int32, device=dev)
    if s and w:
        form = form or sum_form(k)
        lib = _lib()
        table = _device_table(
            [np.array([t.data_ptr() for t in masks], dtype=np.int64)], dev)
        tok = telemetry.launch_begin(dev)
        if form == "grid":
            rc = lib.pbk_bsi_sum_counts(planes.data_ptr(), table.data_ptr(),
                                        k, d, out.data_ptr(), s, w // 4,
                                        _stream(dev))
        else:
            # about 24 blocks an SM (three resident at a time): a short
            # last wave
            parts = _split(s * -(-k // SUM_GROUP), w // 4,
                           6 * _TARGET_BLOCKS, _SUM_STAGED_THREADS)
            rc = lib.pbk_bsi_sum_staged(planes.data_ptr(), table.data_ptr(),
                                        k, d, out.data_ptr(), s, w // 4,
                                        parts, _stream(dev))
        _checked(lib, rc, "bsi_sum_counts", tok)
        _count_launch("bsi_sum_counts", tok, t0, dev, 1 + k, k * 8, form)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# TopN and GroupBy: topn_counts_packed and cross_count_matrix
# ---------------------------------------------------------------------------


def _total(x: torch.Tensor) -> torch.Tensor:
    """int64 sum of an [S, W] tensor's set bits (a 0-dim tensor)."""
    return bv.word_popcounts(x).sum()


def topn_counts_packed_plain(leaves, src: torch.Tensor) -> torch.Tensor:
    """R x [S, W] leaves x [S, W] src -> int64[3, R]: |leaf & src|, |leaf|,
    |src| broadcast."""
    leaves = _leaf_list(leaves)
    r = len(leaves)
    if r == 0:
        return torch.zeros((3, 0), dtype=torch.int64, device=src.device)
    inter = torch.stack([_total(bv.band(t, src)) for t in leaves])
    rows = torch.stack([_total(t) for t in leaves])
    return torch.stack([inter, rows, _total(src).expand(r)])


@blockwise("sum")
def topn_counts_packed(leaves, src: torch.Tensor) -> torch.Tensor:
    """R candidate leaves (list of [S, W] tensors, or stacked [R, S, W]) x
    [S, W] src -> int64[3, R]: row 0 |leaf & src|, row 1 |leaf|, row 2
    |src| broadcast (the Pallas layout). The leaves reach the kernel as a
    device table of pointers, never restacked; each is read once, and src
    once per launch."""
    t0 = time.perf_counter()
    leaves = _leaf_list(leaves)
    dev = _check_planes(leaves + [src])
    if dev.type == "cpu":
        return topn_counts_packed_plain(leaves, src)
    s, w = src.shape
    r = len(leaves)
    out = torch.zeros((_n_chunks(s), 3, r), dtype=torch.int32, device=dev)
    if r and s and w:
        lib = _lib()
        table = _device_table(
            [np.array([t.data_ptr() for t in leaves], dtype=np.int64)], dev)
        tok = telemetry.launch_begin(dev)
        rc = lib.pbk_topn_counts(table.data_ptr(), r, src.data_ptr(),
                                 out.data_ptr(), s, w // 4, SUM_SHARD_CHUNK,
                                 _stream(dev))
        _checked(lib, rc, "topn_counts_packed", tok)
        _count_launch("topn_counts_packed", tok, t0, dev, r + 1, r * 8)
    return out.sum(dim=0, dtype=torch.int64)


def _check_cross(prefix: torch.Tensor, axis: torch.Tensor) -> torch.device:
    for name, t in (("prefix", prefix), ("axis", axis)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{name} must be an int32 [N, S, W] tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"planes are int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if prefix.shape[1:] != axis.shape[1:]:
        raise ValueError(f"prefix [S, W] {tuple(prefix.shape[1:])} differs "
                         f"from axis [S, W] {tuple(axis.shape[1:])}")
    if prefix.device != axis.device:
        raise ValueError("prefix and axis on different devices")
    dev = prefix.device
    if dev.type == "cuda":
        if prefix.shape[2] % 4:
            raise ValueError(f"W={prefix.shape[2]} must be a multiple of 4 "
                             "for the kernels' 16-byte loads")
        if prefix.data_ptr() % 16 or axis.data_ptr() % 16:
            raise ValueError("plane storage must be 16-byte aligned")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def cross_count_matrix_plain(prefix: torch.Tensor,
                             axis: torch.Tensor) -> torch.Tensor:
    """[P, S, W] x [R, S, W] -> int64[P, R] intersection counts, a block
    of axis rows at a time (at most 2^28 words of temporaries)."""
    p, s, w = prefix.shape
    r = axis.shape[0]
    out = torch.zeros((p, r), dtype=torch.int64, device=prefix.device)
    step = max(1, (1 << 28) // max(1, s * w))
    for i in range(p):
        for r0 in range(0, r, step):
            both = bv.band(axis[r0:r0 + step], prefix[i])
            out[i, r0:r0 + step] = bv.word_popcounts(both).sum(dim=(1, 2))
    return out


@blockwise("sum")
def cross_count_matrix(prefix: torch.Tensor,
                       axis: torch.Tensor) -> torch.Tensor:
    """[P, S, W] prefixes x [R, S, W] axis rows -> int64[P, R]:
    counts[p, r] = popcount(prefix[p] & axis[r]) over all shards and
    words. Every operand word is read from device memory once per output
    tile of the kernel (16 prefixes x 64 rows at most)."""
    t0 = time.perf_counter()
    dev = _check_cross(prefix, axis)
    if dev.type == "cpu":
        return cross_count_matrix_plain(prefix, axis)
    p, s, w = prefix.shape
    r = axis.shape[0]
    c = _n_chunks(s)
    out = torch.zeros((c, p, r), dtype=torch.int32, device=dev)
    if p and r and s and w:
        lib = _lib()
        w4 = w // 4
        tile_p = 4 if p <= 4 else 8 if p <= 8 else 16
        tiles = c * -(-p // tile_p) * -(-r // 64)
        steps = -(-min(s, SUM_SHARD_CHUNK) * w4 // 32)
        split = int(max(1, min(steps, -(-2 * _TARGET_BLOCKS // tiles))))
        tok = telemetry.launch_begin(dev)
        rc = lib.pbk_cross_count(prefix.data_ptr(), axis.data_ptr(), p, r,
                                 out.data_ptr(), s, w4, SUM_SHARD_CHUNK, c,
                                 split, _stream(dev))
        _checked(lib, rc, "cross_count_matrix", tok)
        _count_launch("cross_count_matrix", tok, t0, dev, 2)
    return out.sum(dim=0, dtype=torch.int64)


# ---------------------------------------------------------------------------
# Hybrid leaves: sparse_intersect_dense
# ---------------------------------------------------------------------------


def _check_sparse_dense(sp: torch.Tensor, dense: torch.Tensor):
    for name, t in (("sp", sp), ("dense", dense)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{name} must be an int32 [S, N] tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sp.shape[0] != dense.shape[0]:
        raise ValueError(f"{sp.shape[0]} sparse rows for {dense.shape[0]} "
                         "dense shards")
    if sp.device != dense.device:
        raise ValueError("sp and dense on different devices")
    dev = sp.device
    if dev.type == "cuda":
        if dense.shape[1] != WORDS_PER_SHARD:
            raise ValueError(f"dense planes must be {WORDS_PER_SHARD} words "
                             f"wide (every column id indexes one), got "
                             f"{dense.shape[1]}")
        if sp.shape[1] >= 1 << 31:
            raise ValueError("K must fit an int")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def sparse_intersect_dense_plain(sp: torch.Tensor,
                                 dense: torch.Tensor) -> torch.Tensor:
    """_resort(sp, _dense_bit_test(sp, dense)) in plain torch."""
    return hybrid.sparse_intersect_dense(sp, dense)


def sparse_difference_dense_plain(sp: torch.Tensor,
                                  dense: torch.Tensor) -> torch.Tensor:
    """sparse &~ dense in plain torch."""
    return hybrid.sparse_difference_dense(sp, dense)


class SparsePlan(NamedTuple):
    """sparse_intersect_dense's launch for K entries a row over S shards:
    unit "warp" (a warp per shard, SPARSE_WARPS shards a block, K <= 32
    SPARSE_V) or "block" (a block per shard, tiles of threads * SPARSE_V
    entries; a warp owns 32 SPARSE_V consecutive entries of a tile, in
    SPARSE_V stripes of 32); threads per block; grid blocks."""

    unit: str
    threads: int
    grid: int


@functools.lru_cache(maxsize=1024)
def sparse_plan(k: int, s: int) -> SparsePlan:
    if k <= 32 * SPARSE_V:
        return SparsePlan("warp", 32 * SPARSE_WARPS,
                          max(1, -(-s // SPARSE_WARPS)))
    threads = min(_THREADS, 32 * -(-k // (32 * SPARSE_V)))
    return SparsePlan("block", threads, s)


def _sparse_dense_launch(sp: torch.Tensor, dense: torch.Tensor,
                         keep_hits: int, t0: float) -> torch.Tensor:
    s, k = sp.shape
    out = torch.empty_like(sp)
    if s == 0 or k == 0:
        return out
    plan = sparse_plan(k, s)
    lib = _lib()
    tok = telemetry.launch_begin(sp.device)
    rc = lib.pbk_sparse_intersect_dense(
        sp.data_ptr(), dense.data_ptr(), out.data_ptr(), s, k, WORDS_PER_SHARD,
        keep_hits, plan.unit == "block", plan.threads, plan.grid,
        _stream(sp.device))
    _checked(lib, rc, "sparse_intersect_dense", tok)
    _count_launch("sparse_intersect_dense", tok, t0, sp.device, 2)
    return out


@blockwise("map", 0)
def sparse_intersect_dense(sp: torch.Tensor,
                           dense: torch.Tensor) -> torch.Tensor:
    """int32[S, K] sparse rows x int32[S, W] planes -> int32[S, K]: each
    row's entries whose bit is set in its plane, in order, then
    SPARSE_SENTINEL to the end of the row.

    Contract: every row of sp is sorted ascending, its entries below the
    sentinel are unique, and sentinels fill its tail (every sparse leaf
    and every output of ops/hybrid.py is). Compaction in order then gives
    exactly the plain version's sort(where(hit, idx, sentinel)); the
    kernel does not check the contract."""
    t0 = time.perf_counter()
    dev = _check_sparse_dense(sp, dense)
    if dev.type == "cpu":
        return sparse_intersect_dense_plain(sp, dense)
    return _sparse_dense_launch(sp, dense, 1, t0)


@blockwise("map", 0)
def sparse_difference_dense(sp: torch.Tensor,
                            dense: torch.Tensor) -> torch.Tensor:
    """int32[S, K] x int32[S, W] -> int32[S, K]: the entries whose bit is
    clear (sparse &~ dense), under sparse_intersect_dense's contract and
    through its kernel (counted as its launch)."""
    t0 = time.perf_counter()
    dev = _check_sparse_dense(sp, dense)
    if dev.type == "cpu":
        return sparse_difference_dense_plain(sp, dense)
    return _sparse_dense_launch(sp, dense, 0, t0)
