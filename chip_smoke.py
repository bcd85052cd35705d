#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero
                                     # without one, printing no result

Phases, in order; any failure exits non-zero (nothing is caught):

1. Device and build: the card's name and power limit (nvidia-smi), then
   the kernels built from pilosa_tpu_torch/csrc with nvcc, and what
   ptxas -v reported per kernel (lines "ptxas: <kernel><template args>:
   registers, stack frame, spills"), with whether program_count's
   instantiations up to depth 4 keep their operand stack in registers.
2. Server, Count path: the port's Server on a temp data dir; an index
   with existence tracking and a set field of 8 rows over 1024 shards
   (8.5k-40k bits per shard and row) loaded through API.import_bits plus
   one JSON import; PQL over HTTP, including Counts over 40 Rows (40
   leaves), checked against a numpy oracle built from the generated
   columns; then 32 concurrent clients x 64 Count(Intersect) queries.
   Launch counts are zeroed before the server starts and read after the
   last query: every kernel of the path must have launched. With
   --profile, a further concurrent pass runs under torch.profiler and the
   device's idle share over it is printed.
3. Server, BSI path, on the same server and index (BASELINE.json
   configs[3], "BSI int field Range + Sum/Min/Max over 1B rows", the field
   of bench.py:837-842): an int field v with min 0 and max 1023 (depth 10)
   over the same 1024 shards. One reduction: values on 32768 random
   columns per shard (33.5M, uniform 0..1023) instead of every column;
   the device slab (11 planes of 128 MiB) is the same whatever the fill.
   Loaded through API.import_values, one JSON values import and a few
   Set(col, v=x) over HTTP; the cold slab build is timed apart; Sum, Min,
   Max (with and without a filter on f), Range counts, BETWEEN, != null,
   Not, a clamp and a ?shards= column list checked against a numpy
   oracle; then 32 clients x 16 Sum(Range(v > x), field=v) with varying
   thresholds (bench.py:870), every answer checked. Launch counts are
   zeroed before the phase: bsi_compare and bsi_sum_counts must launch,
   and the sum batcher must coalesce.
4. Server, TopN/Rows/GroupBy path, on the same server and index: a ranked
   set field t of 64 rows, row r with about 12000 / (r + 1) random bits
   per shard (a Zipf-like spread of segment sizes, about 58M bits), loaded
   through API.import_bits plus one JSON import, then Set/Clear over HTTP
   that must move the rank caches. TopN (the cache path; a Src Row(f=a) for
   every a; tanimotoThreshold; threshold; ids= with a Src), Rows (plain,
   limit/previous, column) and GroupBy (f x t: 8 x 64 groups, with limit,
   with filter=Range(v > 500); and three axes with limited Rows) checked
   against a numpy oracle; the cold first Src TopN (64 leaves of 128 MiB
   built from the host) and the cold first GroupBy (the 8 GiB rows slab)
   timed apart from warm repeats; then 32 clients x 16 TopN(t, Row(f=a),
   n=10) with varying a, every answer checked. Launch counts are zeroed
   before the phase: topn_counts_packed and cross_count_matrix must launch.
5. Server, hybrid sparse/run path, on the same server and index (Pilosa's
   Getting Started "Star Trace": a stargazer row holds the few
   repositories one user starred), with no rank caches: a set field s of
   32 rows, row a with
   min(4096, 8 * 2^(a mod 10)) random bits per shard (every row plans
   sparse, K = 8..4096; about 25M bits), and a set field r of 4 rows with
   2-16 intervals per shard totalling 5000-8000 bits (they plan run, about
   26M bits). sparse∩dense, sparse∩sparse, union, xor, difference, Not,
   sparse∩run, run∩dense, run∩run, a Range filter, Sum and a TopN Src over
   a sparse row checked against a numpy oracle, the cold first sparse
   leaf timed apart; Count(Row(s=a)) for every a, so that the leaves are
   resident; then 32 clients x 16 Count(Intersect(Row(s=a),
   Row(f=b))) with varying a and b, every answer checked. Launch counts
   are zeroed before the phase: sparse_intersect_dense must launch, and
   the port must have uploaded sparse and run leaves.
6. Server, write path, on the same server and index (bench.py's ingest
   stage, bench.py:1824-1935, cut to a fixed length): 8 keep-alive writers
   each send 40 envelopes of 500 calls, 80 % Set of a column of their own
   (column % 8 = writer) anywhere in the 1024 shards on one of f rows 0-7
   (dense), s rows 1-8 (sparse, K = 16..2048) or r row 0 (run), 20 %
   Clear of a (row, column) the writer set earlier: 160,000 mutations,
   served through the IngestBatcher, Fragment.apply_batch and the
   in-place patches of the resident leaves, while 32 clients run
   Count(Intersect(Row(f=a), Row(f=b))). Every changed flag is checked
   against a numpy oracle updated in each writer's own order (columns are
   disjoint per writer, so the state is exact whatever the interleaving);
   then read-backs (Count of every written row, 8 f pairs, 8 s∩f, a
   3-way Intersect, TopN with and without a Src, Not) are exact, the f
   rows are served from their patched leaves (no dense upload), no dense
   patch was dropped, and pair_stream_counts, program_count,
   sparse_intersect_dense and topn_counts_packed launch after the writes.
   Printed: acked mutations/s, the readers' p50/p99 against a writer-free
   round, the group-commit ratio, batches, patches and drops, the bytes
   uploaded by form after the writes, and the first Count(Intersect)
   after a burst of 5 envelopes a writer with ingest on, then off
   (PILOSA_TPU_TORCH_INGEST=0), with the sparse rows read back after the
   batched burst. Launch counts are zeroed before the phase.
7. Kernels at full width: W = 32768 words, S = 1024 shards (1.07B
   columns), random planes from a seeded torch.Generator on the card. Each
   kernel is held against its plain torch version, exactly (integer
   counts, tolerance 0): pair_stream_counts for all 5 ops at K = 1024 over
   a 32-row slab (4 GiB), over every query and as the CountBatcher
   launches it (over the distinct canonical pairs); then both launches
   timed in turns (every, distinct, distinct, every) at bench.py's headline
   batch (K = 512 pairs of distinct rows among 16), at the batcher's cap
   of 512 and the server's mean batch over its 8 rows; program_count on
   a 4-leaf program with xor/andnot/not, a 40-leaf one and the BSI
   descents' two programs (each timed by CUDA events, on the device by
   torch.profiler and on the host), a balanced 16-leaf one (the deepest
   class) and 300-leaf ones that take the device table at each depth
   class; intersect_count (three times as well); bsi_compare for all 6 ops at depth 10 and gt at depth
   32 (4 GiB of planes); bsi_sum_counts, both forms (grid and staged)
   timed in turns, at K = 1, 2, 32 and the served mean batch at depth 10,
   and K = 1 at depth 32; topn_counts_packed at R = 64
   (the server's launch size) and at R = 130 over 256 shards (past the
   Pallas kernel's 128-row block); cross_count_matrix at P = 8 (the
   GroupBy's valid prefixes) and P = 16 (its chunk), R = 64;
   sparse_intersect_dense, both modes, at K past each edge of its work
   units, at every K the hybrid phase served and at K = 16384 (event,
   device and host times). Times by CUDA events (warm, median).
8. The last lines: nvidia-smi's name and power limit, one JSON object with
   a record per kernel (its launches summed over the five paths, with
   launches_by_path beside; bsi_sum_counts adds its launches by form and
   the form the served shape takes), and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --count-only   # phases 1-2 only, then the Count
                                         # path's numbers as one JSON line

--count-only drives the Count path alone (same data, same clients) and
prints its served rate, latencies and the CountBatcher's host time per
batch. It reads only the Server, its CountBatcher and residency snapshots
and the launch counts, so a copy of this script beside an older checkout
of the port times that checkout the same way.

    python3 chip_smoke.py --kernel-times # phase 1, then program_count,
                                         # intersect_count and
                                         # sparse_intersect_dense alone

--kernel-times runs the program and sparse parts of phase 7 without the
server (8 random planes; K = 8..4096 as the hybrid phase serves them, and
16384) and prints their numbers as one JSON line. It calls only wrapper
functions an older checkout also has, so a copy beside one times it too.

    python3 chip_smoke.py --ingest-only  # phases 1-2, then phase 6 on
                                         # s and r loaded without phase 5

--ingest-only runs the Count path, loads s and r as phase 5 would, and
runs the write path, printing its numbers as one JSON line.

Bounds: the larger of the bytes each input read once over HBM's 3.35 TB/s
and the operations over the card's rate for their type. The integer rates
come from the CUDA C++ Programming Guide's arithmetic-instruction
throughput table for compute capability 9.0 (results per clock per SM: 64
for 32-bit integer add and bitwise ops, 16 for __popc), times the SM count
and the card's maximum SM clock as nvidia-smi reports them.
sparse_intersect_dense's bytes depend on the data: its indices in, its
output out, and the distinct 32-byte plane sectors its entries touch. The
pair stream's bound counts the distinct rows' bytes and the distinct
canonical pairs' operations (what the answers need); the earlier
formula, operations for every query, is printed beside it.
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# results per clock per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput)
INT32_PER_CLK_SM = 64   # 32-bit integer add, and/or/xor/not
POPC_PER_CLK_SM = 16    # __popc
SHARD_WIDTH = 1 << 20
SOURCE = "pilosa_tpu_torch/csrc/bitmap_kernels.cu"
REPLACES = {
    "pair_stream_counts": "pilosa_tpu/ops/pallas_kernels.py:234",
    "program_count": "pilosa_tpu/ops/pallas_kernels.py:108",
    "intersect_count": "pilosa_tpu/ops/pallas_kernels.py:59",
    "bsi_compare": "pilosa_tpu/ops/pallas_kernels.py:451",
    "bsi_sum_counts": "pilosa_tpu/ops/pallas_kernels.py:504",
    "topn_counts_packed": "pilosa_tpu/ops/pallas_kernels.py:364",
    "cross_count_matrix": "pilosa_tpu/ops/pallas_kernels.py:182",
    "sparse_intersect_dense": "pilosa_tpu/ops/pallas_kernels.py:295",
}
COUNT_KERNELS = ("pair_stream_counts", "program_count", "intersect_count")
BSI_KERNELS = ("bsi_compare", "bsi_sum_counts")
TOPN_KERNELS = ("topn_counts_packed", "cross_count_matrix")
HYBRID_KERNELS = ("sparse_intersect_dense",)
# the device kernel of each form of bsi_sum_counts, as the profiler names
# it
SUM_FORM_KERNELS = {"grid": "bsi_sum_kernel",
                    "staged": "bsi_sum_staged_kernel"}
HYBRID_S_ROWS = 32  # rows of the stargazer-like set field s
HYBRID_R_ROWS = 4   # rows of the run field r
HYBRID_CLIENTS, HYBRID_PER_CLIENT = 32, 16  # the hybrid phase's pass
SPARSE_SENTINEL = SHARD_WIDTH
# the write phase (bench.py:1824-1827 and 1830-1935, cut to a fixed length)
INGEST_WRITERS = 8      # keep-alive writer threads (bench.py:1824)
INGEST_CALLS = 500      # Set/Clear calls per envelope (bench.py:1825)
INGEST_ENVELOPES = 40   # envelopes per writer in the measured window
INGEST_TURN_ENVELOPES = 5  # per writer in each ingest on/off turn
INGEST_READERS = 32     # Count(Intersect) clients during the window
INGEST_S_ROWS = tuple(range(1, 9))  # rows of s written: K = 16..2048
INGEST_TURNS = ("on", "off")
# the K of the hybrid phase's rows (min(4096, 8 x 2^(a mod 10)) bits per
# shard, padded as the chooser pads), for runs without the server
SERVED_SPARSE_K = [8 << i for i in range(10)]
SPARSE_EDGE_K = (1, 31, 33, 255, 257, 511, 513, 2049, 4097)
TOPN_ROWS = 64  # rows of the set field t
TOPN_BITS = 12000  # bits per shard of t's row 0; row r holds ~this/(r+1)
TOPN_CLIENTS, TOPN_PER_CLIENT = 32, 16  # the TopN phase's concurrent pass
BSI_DEPTH = 10  # the int field v: min 0, max 1023
# int32 operations per plane word of the compare sweep (lt/gt: and, not,
# or, xor, not, and) and of the sum (and, add; plus one __popc)
CMP_OPS_PER_PLANE_WORD = 6
SUM_OPS_PER_PLANE_WORD = 2
# the 4-leaf program_count case: per word 4 combining ops, a popc, an add
PROGRAM = ("or", ("xor", ("leaf", 0), ("leaf", 1)),
           ("andnot", ("leaf", 2), ("not", ("leaf", 3))))
# 40 leaves, as Count(Union(...)) of 40 Rows gives: 39 combining ops
WIDE_PROGRAM = ("or", ("xor", *[("leaf", i) for i in range(0, 40, 2)]),
                ("andnot", *[("leaf", i) for i in range(1, 40, 2)]))
# the BSI Min descent's program (ops/bsi.py _ANDNOT2), launched D times a
# query, and ("leaf", 0) once
DESCENT_PROGRAM = ("andnot", ("leaf", 0), ("leaf", 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str, *fmt: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader", *fmt))],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def int_rates() -> tuple[float, float]:
    """(32-bit integer ops/s, popc/s) of card 0 at its maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = float(smi("clocks.max.sm", "nounits")) * 1e6
    return sms * clk * INT32_PER_CLK_SM, sms * clk * POPC_PER_CLK_SM


def cuda_ms(fn, runs: int, warm: int = 2) -> float:
    """Median wall time of fn() on the card by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int, kernel, per_call: int = 1) -> float | None:
    """Mean device time per fn() call of the kernels whose name holds
    `kernel` (a string, or a tuple of alternatives), by torch.profiler's
    CUDA activity (CUPTI). A pass counts only if the profiler saw all
    runs x per_call launches; None where no pass of three did. Unlike
    cuda_ms it leaves out the wrapper's host work and the other launches
    of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then drops some of a pass's spans
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(n in e.name for n in names)]
        if len(spans) == runs * per_call:
            return sum(spans) / runs / 1e3
    return None


def host_ms(fn, runs: int) -> float:
    """Mean host time per fn() call: the wrapper's work up to the launch
    being queued (no synchronisation inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t = (time.perf_counter() - t0) / runs * 1e3
    torch.cuda.synchronize()
    return t


def batched_pairs(leaves, ii, jj, op: str, gather: bool = False):
    """pair_stream_counts as the CountBatcher launches it: over the
    queries' distinct canonical pairs (ops/kernels.py plan_pairs). Returns
    the [P, C] partials, or with gather the [K, C] partials of the
    queries."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    plan = kernels.plan_pairs(ii, jj, op)
    out = kernels.pair_stream_counts(leaves, plan.a, plan.b, op)
    if gather:
        inverse = torch.from_numpy(plan.inverse).to(out.device)
        out = out.index_select(0, inverse)
    return out


def bound(nbytes: float, int_ops: float, popcs: float,
          rates: tuple[float, float]) -> tuple[float, str]:
    """Least time in ms: bytes over HBM's rate, or each operation type
    over its own rate (the slower type; the two can issue together)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / rates[0], popcs / rates[1]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _us(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f}"


def max_abs_err(a, b) -> int:
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max().item())


# ---------------------------------------------------------------- kernels


def kernel_phase(device, n_shards: int, words: int, slab_rows: int,
                 k_check: int, k_served: int, seed: int, runs: int) -> dict:
    """Each kernel against its plain version at the main path's shapes;
    returns name -> measurements. The record's ms, plain_ms and bound_ms
    are taken at the shapes the server gave the kernel."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed)
    slab = torch.empty((slab_rows, n_shards, words), dtype=torch.int32,
                       device=device)
    for r in range(slab_rows):
        slab[r] = torch.randint(-2**31, 2**31, (n_shards, words),
                                dtype=torch.int64, device=device,
                                generator=gen).to(torch.int32)
    slab[0, :, :64] = -1           # all-ones words
    slab[1, :, :64] = -2**31       # 0x80000000
    leaves = list(slab.unbind(0))
    plane_bytes = n_shards * words * 4
    n_words = n_shards * words
    n_chunks = -(-n_shards // kernels.SUM_SHARD_CHUNK)
    rng = np.random.default_rng(seed)
    out = {}

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    # pair_stream_counts: all five ops at K = k_check over the whole slab,
    # over every query and as the CountBatcher launches it (over the
    # distinct canonical pairs, mapped back to the queries)
    ii = rng.integers(0, slab_rows, size=k_check)
    jj = rng.integers(0, slab_rows, size=k_check)
    per_op = {}
    for op in kernels.PAIR_OPS:
        want = kernels.pair_stream_counts_plain(leaves, ii, jj, op)
        check(f"pair_stream_counts[{op}] K={k_check}",
              kernels.pair_stream_counts(leaves, ii, jj, op), want)
        check(f"pair_stream_counts[{op}] K={k_check} distinct pairs",
              batched_pairs(leaves, ii, jj, op, gather=True), want)
        per_op[op] = cuda_ms(lambda: batched_pairs(leaves, ii, jj, op), runs)
        log(f"  pair_stream_counts[{op}] K={k_check}: "
            f"{per_op[op] * 1e3:.1f} us over the distinct pairs, exact")

    # ... and "and" at a table of shapes, the launch over every query (the
    # batcher's before it deduplicated) and over the distinct pairs (the
    # batcher's now) timed in turns (every, distinct, distinct, every):
    # bench.py's headline batch (K = 512 pairs of distinct rows among 16,
    # bench.py:295-299), K = 512 and the served mean batch over the
    # server's 8 rows
    bench_rng = np.random.default_rng(23)
    bench = [tuple(bench_rng.choice(16, size=2, replace=False))
             for _ in range(512)]
    # the 8-row batches are drawn in the order (and from the generator
    # state) in which earlier versions of this script drew them, so
    # versions time the same queries
    eight = {}
    for k in sorted({k_served, 512}):
        eight[k] = (rng.integers(0, 8, size=k), rng.integers(0, 8, size=k))
    shapes = {
        "K=512 16 rows i!=j": ([p[0] for p in bench], [p[1] for p in bench]),
        "K=512 8 rows": eight[512],
        f"K={k_served} 8 rows (served)": eight[k_served],
    }
    ways = {"every_query": lambda ii, jj: kernels.pair_stream_counts(
                leaves, ii, jj, "and"),
            "distinct_pairs": lambda ii, jj: batched_pairs(leaves, ii, jj,
                                                           "and")}
    by_shape = {}
    for label, (ii, jj) in shapes.items():
        ii, jj = np.asarray(ii), np.asarray(jj)
        k = ii.size
        plan = kernels.plan_pairs(ii, jj, "and")
        want = kernels.pair_stream_counts_plain(leaves, ii, jj, "and")
        check(f"pair_stream_counts[and] {label}", ways["every_query"](ii, jj),
              want)
        check(f"pair_stream_counts[and] {label} distinct pairs",
              batched_pairs(leaves, ii, jj, "and", gather=True), want)
        turns = {w: [] for w in ways}
        for way in ("every_query", "distinct_pairs", "distinct_pairs",
                    "every_query"):
            turns[way].append(cuda_ms(lambda: ways[way](ii, jj), runs))
        ms = {w: statistics.mean(t) for w, t in turns.items()}
        dev = {w: device_ms(lambda: ways[w](ii, jj), runs,
                            "pair_stream_kernel") for w in ways}
        host = {w: host_ms(lambda: ways[w](ii, jj), runs) for w in ways}
        plain = cuda_ms(
            lambda: kernels.pair_stream_counts_plain(leaves, ii, jj, "and"),
            1 if k > 64 else 3, 1)
        # each input once: the distinct rows, ii/jj, the int32 partials;
        # operations for the distinct pairs (what the answers need) and,
        # labelled apart, for every query (the earlier formula)
        p = plan.a.size
        nbytes = plan.leaves.size * plane_bytes + 2 * k * 8 + k * n_chunks * 4
        b_ms, b_by = bound(nbytes, 2.0 * p * n_words, 1.0 * p * n_words,
                           rates)
        q_ms, q_by = bound(nbytes, 2.0 * k * n_words, 1.0 * k * n_words,
                           rates)
        by_shape[label] = {
            "k": k, "distinct_leaves": int(plan.leaves.size),
            "distinct_pairs": int(p), "ms": ms["distinct_pairs"],
            "ms_by_way": ms, "turns": turns, "device_ms_by_way": dev,
            "host_ms_by_way": host, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_per_query": q_ms,
            "bound_by_per_query": q_by, "bytes_once": nbytes,
            # planes each launch streams (2 per pair it runs over)
            "plane_reads": {"every_query": 2 * k, "distinct_pairs": 2 * p},
            "streamed_bytes_per_query": 2 * k * plane_bytes}
        log(f"  pair_stream_counts[and] {label} ({plan.leaves.size} rows, "
            f"{p} distinct pairs): every query {ms['every_query'] * 1e3:.1f} "
            f"us, distinct pairs {ms['distinct_pairs'] * 1e3:.1f} us (turns "
            f"{[round(x * 1e3, 1) for x in turns['every_query']]} / "
            f"{[round(x * 1e3, 1) for x in turns['distinct_pairs']]}); "
            f"device {_us(dev['every_query'])} / "
            f"{_us(dev['distinct_pairs'])} us, host "
            f"{_us(host['every_query'])} / {_us(host['distinct_pairs'])} us; "
            f"bound {b_ms * 1e3:.1f} us by {b_by} (distinct pairs), "
            f"{q_ms * 1e3:.1f} us by {q_by} (every query); plain "
            f"{plain:.2f} ms; both exact")
    served = by_shape[f"K={k_served} 8 rows (served)"]
    out["pair_stream_counts"] = {**served, "max_abs_err": 0,
                                 "per_op_ms_k_check": per_op,
                                 "k_check": k_check, "by_shape": by_shape}

    out.update(program_kernel_phase(leaves[:8], rates, runs))
    del slab, leaves
    torch.cuda.empty_cache()
    return out


def balanced(lo: int, hi: int):
    """A complete binary tree of and/or/xor over leaves lo..hi-1 (hi - lo
    a power of 2): stack depth log2(hi - lo) + 1."""
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    op = ("and", "or", "xor")[(hi - lo).bit_length() % 3]
    return (op, balanced(lo, mid), balanced(mid, hi))


def time_three(fn, runs: int, kernel) -> dict:
    """Event, device and host ms of fn() (see cuda_ms, device_ms, host_ms)."""
    return {"ms": cuda_ms(fn, runs), "device_ms": device_ms(fn, runs, kernel),
            "host_ms": host_ms(fn, runs)}


def program_kernel_phase(leaves: list, rates: tuple, runs: int) -> dict:
    """program_count and intersect_count against their plain versions over
    8 random [S, W] planes: the 4-leaf PROGRAM (xor/andnot/not), the
    40-leaf WIDE_PROGRAM over the 8 planes, the BSI descents' ("andnot",
    0, 1) and ("leaf", 0), a balanced 16-leaf program (stack depth 5, the
    deepest class), and programs too long for the kernel's parameter (a
    300-leaf chain, alone and combined with balanced trees of depth 3 and
    5), which take the device table at each depth class. Event, device and
    host ms of each served program, and of intersect_count."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    n_shards, words = leaves[0].shape
    plane_bytes = n_shards * words * 4
    n_words = n_shards * words

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    def count(progleaves, program):
        return kernels.program_count(progleaves, program)

    long_chain = ("or", *[("leaf", i) for i in range(300)])
    chain_leaves = [leaves[i % 8] for i in range(300)]
    cases = (
        ("4 leaves", PROGRAM, leaves[:4], True),
        ("40 leaves", WIDE_PROGRAM, [leaves[i % 8] for i in range(40)], True),
        ("descent andnot", DESCENT_PROGRAM, leaves[:2], True),
        ("descent leaf", ("leaf", 0), leaves[:1], True),
        ("16 leaves balanced", balanced(0, 16),
         [leaves[i % 8] for i in range(16)], False),
        ("300-leaf chain", long_chain, chain_leaves, False),
        ("300-leaf chain xor balanced(0, 4)",
         ("xor", long_chain, balanced(0, 4)), chain_leaves, False),
        ("300-leaf chain xor balanced(0, 16)",
         ("xor", long_chain, balanced(0, 16)), chain_leaves, False),
    )
    progs = {}
    for label, program, progleaves, timed in cases:
        want = kernels.program_count_plain(progleaves, program)
        plan = (kernels.program_plan(program, len(progleaves))
                if hasattr(kernels, "program_plan") else None)
        check(f"program_count {label}", count(progleaves, program), want)
        del want
        codes, _, depth = kernels.encode_program(program)
        rec = {"leaves": len(progleaves), "instructions": len(codes),
               "depth": depth}
        if plan is not None:
            rec.update(depth_class=plan.depth_class, form=plan.form)
        if timed:
            rec.update(time_three(lambda: count(progleaves, program), runs,
                                  "program_count"))
            rec["plain_ms"] = cuda_ms(
                lambda: kernels.program_count_plain(progleaves, program), 3, 1)
            combining = sum(c != kernels.LEAF for c in codes)
            distinct = len({t.data_ptr() for t in progleaves})
            nbytes = distinct * plane_bytes + n_shards * 4
            b_ms, b_by = bound(nbytes, (combining + 1.0) * n_words,
                               1.0 * n_words, rates)
            rec.update(bound_ms=b_ms, bound_by=b_by, bytes_once=nbytes)
            log(f"  program_count {label}: {rec['ms'] * 1e3:.1f} us, device "
                f"{_us(rec['device_ms'])} us, host {_us(rec['host_ms'])} us "
                f"(bound {b_ms * 1e3:.1f} us by {b_by}; depth {depth}"
                + (f", class {plan.depth_class}, {plan.form}" if plan else "")
                + "), exact")
        else:
            log(f"  program_count {label}: depth {depth}"
                + (f", class {plan.depth_class}, {plan.form}" if plan else "")
                + ", exact")
        progs[label] = rec
    out = {"program_count": {**progs["4 leaves"], "max_abs_err": 0,
                             "shape": "4 leaves", "all": progs,
                             "wide": progs["40 leaves"]}}

    err = check("intersect_count", kernels.intersect_count(leaves[0], leaves[1]),
                kernels.intersect_count_plain(leaves[0], leaves[1]))
    rec = time_three(lambda: kernels.intersect_count(leaves[0], leaves[1]),
                     runs, ("intersect_count", "program_count"))
    plain = cuda_ms(
        lambda: kernels.intersect_count_plain(leaves[0], leaves[1]), 3, 1)
    nbytes = 2 * plane_bytes + n_shards * 4
    b_ms, b_by = bound(nbytes, 2.0 * n_words, 1.0 * n_words, rates)
    out["intersect_count"] = {**rec, "plain_ms": plain, "bound_ms": b_ms,
                              "bound_by": b_by, "max_abs_err": err,
                              "bytes_once": nbytes}
    log(f"  intersect_count: {rec['ms'] * 1e3:.1f} us, device "
        f"{_us(rec['device_ms'])} us, host {_us(rec['host_ms'])} us (bound "
        f"{b_ms * 1e3:.1f} us by {b_by}), exact")
    return out


def bsi_kernel_phase(device, n_shards: int, words: int, k_served: int,
                     seed: int, runs: int) -> dict:
    """bsi_compare and bsi_sum_counts against their plain versions at
    depth 10 (the served field) and depth 32; the record's numbers are
    taken at the shapes the server gave each kernel (gt over depth 10, the
    sum batcher's mean batch)."""
    import torch

    from pilosa_tpu_torch.ops import bsi, kernels

    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    plane_bytes = n_shards * words * 4
    n_words = n_shards * words

    def rand(*shape):
        t = torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                          device=device, generator=gen).to(torch.int32)
        t[..., :64] = -1           # all-ones words
        t[..., 64:96] = -2**31     # 0x80000000
        return t

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    out = {"bsi_compare": {}, "bsi_sum_counts": {}}
    for depth in (BSI_DEPTH, 32):
        planes = torch.empty((depth, n_shards, words), dtype=torch.int32,
                             device=device)
        for d in range(depth):
            planes[d] = rand(n_shards, words)
        exists = rand(n_shards, words)
        bits = bsi.value_to_bits(
            int(np.random.default_rng(seed).integers(1, 1 << depth)), depth)
        ops = kernels.BSI_OPS if depth == BSI_DEPTH else ("gt",)
        for op in ops:
            name = f"bsi_compare[{op}] D={depth}"
            check(name, kernels.bsi_compare(planes, exists, bits, op),
                  kernels.bsi_compare_plain(planes, exists, bits, op))
            ms = cuda_ms(lambda: kernels.bsi_compare(planes, exists, bits, op),
                         runs)
            plain = cuda_ms(
                lambda: kernels.bsi_compare_plain(planes, exists, bits, op),
                3, 1)
            # each input once (planes, exists, predicate), the mask out
            nbytes = (depth + 2) * plane_bytes + depth * 4
            b_ms, b_by = bound(nbytes,
                               CMP_OPS_PER_PLANE_WORD * depth * n_words, 0.0,
                               rates)
            out["bsi_compare"][f"{op} D={depth}"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "bytes_once": nbytes}
            log(f"  {name}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by "
                f"{b_by}), plain {plain:.2f} ms, exact")
        for k in sorted({1, 2, 32, k_served} if depth == BSI_DEPTH
                        else {1}):
            filters = [exists] + [rand(n_shards, words) for _ in range(k - 1)]
            name = f"bsi_sum_counts K={k} D={depth}"
            want = kernels.bsi_sum_counts_plain(planes, filters)
            for form in kernels.SUM_FORMS:
                check(f"{name} [{form}]",
                      kernels.bsi_sum_counts(planes, filters, form=form),
                      want)
            del want
            # both forms in turns (grid, staged, staged, grid)
            turns = {f: [] for f in kernels.SUM_FORMS}
            for form in ("grid", "staged", "staged", "grid"):
                turns[form].append(cuda_ms(
                    lambda: kernels.bsi_sum_counts(planes, filters,
                                                   form=form), runs))
            ms = {f: statistics.mean(t) for f, t in turns.items()}
            dev = {f: device_ms(
                lambda: kernels.bsi_sum_counts(planes, filters, form=f), runs,
                SUM_FORM_KERNELS[f])
                for f in kernels.SUM_FORMS}
            form = kernels.sum_form(k)  # the wrapper's default
            plain = cuda_ms(
                lambda: kernels.bsi_sum_counts_plain(planes, filters),
                3 if k < 8 else 1, 1)
            nbytes = (depth + k) * plane_bytes + k * (depth + 1) * n_shards * 4
            b_ms, b_by = bound(nbytes,
                               SUM_OPS_PER_PLANE_WORD * k * depth * n_words,
                               1.0 * k * (depth + 1) * n_words, rates)
            out["bsi_sum_counts"][f"K={k} D={depth}"] = {
                "k": k, "form": form, "ms": ms[form], "ms_by_form": ms,
                "turns": turns, "device_ms_by_form": dev, "plain_ms": plain,
                "bound_ms": b_ms,
                "bound_by": b_by, "bytes_once": nbytes,
                # planes (and filters) each form reads from HBM
                "plane_reads": {"grid": k * depth + k,
                                "staged": -(-k // 32) * depth + k}}
            log(f"  {name}: grid {ms['grid'] * 1e3:.1f} us, staged "
                f"{ms['staged'] * 1e3:.1f} us (turns "
                f"{[round(x * 1e3, 1) for x in turns['grid']]} / "
                f"{[round(x * 1e3, 1) for x in turns['staged']]}); device "
                f"{_us(dev['grid'])} / {_us(dev['staged'])} us; default "
                f"{form}; bound {b_ms * 1e3:.1f} us by {b_by}; plain "
                f"{plain:.2f} ms; both forms exact")
            del filters
        del planes, exists
        torch.cuda.empty_cache()
    cmp_ = out["bsi_compare"]
    sums = out["bsi_sum_counts"]
    return {
        "bsi_compare": {**cmp_[f"gt D={BSI_DEPTH}"], "max_abs_err": 0,
                        "shape": f"gt D={BSI_DEPTH}", "all": cmp_},
        "bsi_sum_counts": {**sums[f"K={k_served} D={BSI_DEPTH}"],
                           "max_abs_err": 0,
                           "shape": f"K={k_served} D={BSI_DEPTH}",
                           "all": sums},
    }


def topn_kernel_phase(device, n_shards: int, words: int, seed: int,
                      runs: int) -> dict:
    """topn_counts_packed at R = 64 over n_shards and R = 130 over 256
    shards, cross_count_matrix at P = 8 and 16 against R = 64 rows, each
    against its plain version; the records' numbers are taken at the
    shapes the server gave each kernel (R = 64; P = 8, R = 64)."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed + 2)

    def rand(*shape):
        t = torch.empty(shape, dtype=torch.int32, device=device)
        for i in range(shape[0]):  # one plane at a time: int64 staging
            t[i] = torch.randint(-2**31, 2**31, shape[1:], dtype=torch.int64,
                                 device=device, generator=gen).to(torch.int32)
        t[..., :64] = -1           # all-ones words
        t[..., 64:96] = -2**31     # 0x80000000
        return t

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    out = {"topn_counts_packed": {}, "cross_count_matrix": {}}
    for r, s in ((TOPN_ROWS, n_shards), (130, min(256, n_shards))):
        rows = rand(r, s, words)
        src = rand(1, s, words)[0]
        leaves = list(rows.unbind(0))
        name = f"topn_counts_packed R={r} S={s}"
        check(name, kernels.topn_counts_packed(leaves, src),
              kernels.topn_counts_packed_plain(leaves, src))
        ms = cuda_ms(lambda: kernels.topn_counts_packed(leaves, src), runs)
        plain = cuda_ms(lambda: kernels.topn_counts_packed_plain(leaves, src),
                        2, 1)
        n_words = s * words
        chunks = -(-s // kernels.SUM_SHARD_CHUNK)
        # each row and src once, the R leaf pointers, the int32 partials
        nbytes = (r + 1) * n_words * 4 + r * 8 + chunks * 3 * r * 4
        b_ms, b_by = bound(nbytes, 2.0 * r * n_words,
                           (2.0 * r + 1) * n_words, rates)
        out["topn_counts_packed"][f"R={r} S={s}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bytes_once": nbytes}
        log(f"  {name}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by "
            f"{b_by}), plain {plain:.2f} ms, exact")
        del rows, src, leaves
        torch.cuda.empty_cache()
    axis = rand(TOPN_ROWS, n_shards, words)
    prefix = rand(16, n_shards, words)
    n_words = n_shards * words
    chunks = -(-n_shards // kernels.SUM_SHARD_CHUNK)
    for p in (8, 16):
        pre = prefix[:p]
        name = f"cross_count_matrix P={p} R={TOPN_ROWS}"
        check(name, kernels.cross_count_matrix(pre, axis),
              kernels.cross_count_matrix_plain(pre, axis))
        ms = cuda_ms(lambda: kernels.cross_count_matrix(pre, axis), runs)
        plain = cuda_ms(lambda: kernels.cross_count_matrix_plain(pre, axis),
                        1, 1)
        nbytes = (p + TOPN_ROWS) * n_words * 4 + chunks * p * TOPN_ROWS * 4
        ops = 1.0 * p * TOPN_ROWS * n_words
        b_ms, b_by = bound(nbytes, 2.0 * ops, ops, rates)
        out["cross_count_matrix"][f"P={p} R={TOPN_ROWS}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bytes_once": nbytes}
        log(f"  {name}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by "
            f"{b_by}), plain {plain:.2f} ms, exact")
    del axis, prefix
    torch.cuda.empty_cache()
    log(f"  TopN/GroupBy kernels: {time.perf_counter() - t_phase:.1f} s")
    tn, cc = out["topn_counts_packed"], out["cross_count_matrix"]
    first = f"R={TOPN_ROWS} S={n_shards}"
    return {
        "topn_counts_packed": {**tn[first], "max_abs_err": 0,
                               "shape": first, "all": tn},
        "cross_count_matrix": {**cc[f"P=8 R={TOPN_ROWS}"], "max_abs_err": 0,
                               "shape": f"P=8 R={TOPN_ROWS}", "all": cc},
    }


def hybrid_kernel_phase(device, n_shards: int, words: int, served_k: list,
                        seed: int, runs: int) -> dict:
    """sparse_intersect_dense (and its keep-misses mode) against its plain
    version at every K the server gave it and at K = 16384 (the JAX
    package's union cap), over n_shards random planes; the record's
    numbers are taken at the largest served K."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    dense = torch.randint(-2**31, 2**31, (n_shards, words), dtype=torch.int64,
                          device=device, generator=gen).to(torch.int32)
    dense[:, :64] = -1  # all-ones words: every entry there hits

    def sparse_rows(k: int):
        """[n_shards, k] sorted unique ids, sentinel-padded after dedup;
        the last row sentinel only, the one before it half full."""
        idx = torch.randint(0, SHARD_WIDTH, (n_shards, k), dtype=torch.int32,
                            device=device, generator=gen)
        idx = torch.sort(idx, dim=1).values
        dup = torch.zeros_like(idx, dtype=torch.bool)
        dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
        idx = torch.where(dup, SPARSE_SENTINEL, idx)
        idx[-2, k // 2:] = SPARSE_SENTINEL
        idx[-1] = SPARSE_SENTINEL
        return torch.sort(idx, dim=1).values.contiguous()

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    # K past each edge of the kernel's work units (warp: 32 x 8 entries;
    # block: thread steps of 256 entries, tiles of 2048), odd K: exact only
    for k in SPARSE_EDGE_K:
        sp = sparse_rows(k)
        for fn, plain in ((kernels.sparse_intersect_dense,
                           kernels.sparse_intersect_dense_plain),
                          (kernels.sparse_difference_dense,
                           kernels.sparse_difference_dense_plain)):
            check(f"{fn.__name__} K={k}", fn(sp, dense), plain(sp, dense))
    log(f"  sparse_intersect_dense K={list(SPARSE_EDGE_K)}: both modes exact")
    out = {}
    for k in sorted(set(served_k) | {16384}):
        sp = sparse_rows(k)
        check(f"sparse_intersect_dense K={k}",
              kernels.sparse_intersect_dense(sp, dense),
              kernels.sparse_intersect_dense_plain(sp, dense))
        check(f"sparse_difference_dense K={k}",
              kernels.sparse_difference_dense(sp, dense),
              kernels.sparse_difference_dense_plain(sp, dense))
        rec = time_three(lambda: kernels.sparse_intersect_dense(sp, dense),
                         runs, "sparse_dense_kernel")
        plain = cuda_ms(
            lambda: kernels.sparse_intersect_dense_plain(sp, dense), 3, 1)
        # each index read once, each slot written once, and the distinct
        # 32-byte plane sectors the entries below the sentinel touch
        live = sp < SPARSE_SENTINEL
        shard = torch.arange(n_shards, device=device,
                             dtype=torch.int64)[:, None].expand_as(sp)
        sector = shard * (words // 8) + (sp.to(torch.int64) >> 8)
        sectors = int(torch.unique(sector[live]).numel())
        entries = n_shards * k
        nbytes = 2 * entries * 4 + 32 * sectors
        b_ms, b_by = bound(nbytes, 8.0 * entries, 1.0 * entries, rates)
        plan = (kernels.sparse_plan(k, n_shards)._asdict()
                if hasattr(kernels, "sparse_plan") else None)
        out[f"K={k}"] = {**rec, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes_once": nbytes,
                         "sectors": sectors, "plan": plan}
        log(f"  sparse_intersect_dense K={k} S={n_shards}: "
            f"{rec['ms'] * 1e3:.1f} us, device {_us(rec['device_ms'])} us, "
            f"host {_us(rec['host_ms'])} us (bound {b_ms * 1e3:.1f} us by "
            f"{b_by}; {plan}), plain {plain:.2f} ms, both modes exact")
        del sp, shard, sector, live
    del dense
    torch.cuda.empty_cache()
    log(f"  hybrid kernels: {time.perf_counter() - t_phase:.1f} s")
    first = f"K={max(served_k)}"
    return {"sparse_intersect_dense": {**out[first], "max_abs_err": 0,
                                       "shape": first, "all": out}}


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    program_count_kernel<4> (the kernels live in one anonymous namespace:
    _ZN <len> <namespace> <len> <name> [I <args> E] ...)."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    pos = m.end() + int(m.group(1))
    m = re.match(r"(\d+)", mangled[pos:])
    if not m:
        return mangled
    end = pos + m.end() + int(m.group(1))
    name, rest = mangled[pos + m.end():end], mangled[end:]
    args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0]) \
        if rest.startswith("I") else []
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_phase(build) -> dict:
    """Print what ptxas -v reported per kernel (registers, stack frame,
    spills) and whether every program_count instantiation of the classes
    up to depth 4 keeps its stack in registers (0-byte frame, no spills);
    the deepest class keeps a local stack by design."""
    if not hasattr(build, "ptxas_report"):  # an older checkout
        for line in build.build_info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        return {}
    report = {}
    for mangled, r in build.ptxas_report(build.build_log()).items():
        if "registers" in r:
            report[kernel_label(mangled)] = r
    for label, r in sorted(report.items()):
        log(f"  ptxas: {label}: {r.get('registers')} registers, "
            f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} / "
            f"{r.get('spill_loads')} bytes spill stores / loads")
    shallow = {k: r for k, r in report.items()
               if k.startswith("program_count") and k.endswith(("<2>", "<4>"))}
    ok = bool(shallow) and all(
        r.get("stack") == 0 and r.get("spill_stores") == 0
        and r.get("spill_loads") == 0 for r in shallow.values())
    log(f"  program_count classes up to depth 4 ({len(shallow)} "
        f"instantiations): stack in registers "
        + ("(0-byte frames, no spills)" if ok else "NOT confirmed"))
    return {"kernels": report, "program_count_register_stack": ok}


def kernel_times(device, n_shards: int, words: int, seed: int,
                 runs: int) -> dict:
    """program_count, intersect_count and sparse_intersect_dense alone, at
    the shapes the server phases give them: 8 random planes for the
    programs, the hybrid phase's K for the sparse rows."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    slab = torch.empty((8, n_shards, words), dtype=torch.int32, device=device)
    for r in range(8):
        slab[r] = torch.randint(-2**31, 2**31, (n_shards, words),
                                dtype=torch.int64, device=device,
                                generator=gen).to(torch.int32)
    log("phase 7: program_count and intersect_count")
    out = program_kernel_phase(list(slab.unbind(0)), int_rates(), runs)
    del slab
    torch.cuda.empty_cache()
    log("phase 7: sparse_intersect_dense")
    out.update(hybrid_kernel_phase(device, n_shards, words, SERVED_SPARSE_K,
                                   seed, runs))
    return out


# ----------------------------------------------------------------- server


def _http(uri_port: int, method: str, path: str, body: bytes = b"",
          conn=None):
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("localhost", uri_port, timeout=600)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        payload = json.loads(resp.read() or b"null")
        if resp.status != 200:
            raise AssertionError(f"{method} {path} -> {resp.status}: {payload}")
        return payload
    finally:
        if own:
            conn.close()


def _and_count(*packed: np.ndarray) -> int:
    """Set bits of the AND of packed rows, in 16 MiB slices (no
    full-size temporary)."""
    step = 1 << 24
    buf = np.empty(min(step, packed[0].size), dtype=np.uint8)
    total = 0
    for lo in range(0, packed[0].size, step):
        n = min(step, packed[0].size - lo)
        out = buf[:n]
        np.copyto(out, packed[0][lo:lo + n])
        for x in packed[1:]:
            np.bitwise_and(out, x[lo:lo + n], out=out)
        total += _popcount(out)
    return total


def _popcount(packed: np.ndarray) -> int:
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(packed).sum(dtype=np.int64))
    table = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
    return int(table[packed].sum())


def make_rows(n_rows: int, n_shards: int, seed: int) -> list[np.ndarray]:
    """Per row, sorted unique global columns with 8.5k-40k bits per shard
    (after dedup at least 8k: every row stays above the JAX planner's
    4096-bit sparse threshold, so its leaves are dense planes)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        cards = rng.integers(8500, 40001, size=n_shards)
        shard_of = np.repeat(np.arange(n_shards, dtype=np.int64), cards)
        cols = shard_of * SHARD_WIDTH + rng.integers(
            0, SHARD_WIDTH, size=int(cards.sum()))
        cols.sort()
        keep = np.concatenate(([True], cols[1:] != cols[:-1]))
        rows.append(cols[keep])
    return rows


def shard_major(rows: list, n_shards: int) -> tuple:
    """(row ids, columns) of sorted per-row column arrays, ordered by shard
    and then by row: one import call whose shard grouping is a no-op
    sort, and one snapshot per fragment."""
    edges = np.arange(n_shards + 1, dtype=np.int64) * SHARD_WIDTH
    bounds = [np.searchsorted(r, edges) for r in rows]
    ids, cols = [], []
    for s in range(n_shards):
        for i, r in enumerate(rows):
            seg = r[bounds[i][s]:bounds[i][s + 1]]
            ids.append(np.full(seg.size, i, dtype=np.int64))
            cols.append(seg)
    return np.concatenate(ids), np.concatenate(cols)


def packed_row(cols: np.ndarray, n_shards: int) -> np.ndarray:
    bits = np.zeros(n_shards * SHARD_WIDTH, dtype=bool)
    bits[cols] = True
    return np.packbits(bits, bitorder="little")


def _bit_test(packed: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Whether each global column is set in a little-endian packed row."""
    return ((packed[cols >> 3] >> (cols & 7).astype(np.uint8)) & 1).astype(bool)


def make_values(n_shards: int, per_shard: int, seed: int):
    """(sorted global columns, values): per_shard distinct random columns
    in every shard, values uniform in 0..1023."""
    rng = np.random.default_rng(seed + 7)
    offs = np.stack([rng.choice(SHARD_WIDTH, size=per_shard, replace=False)
                     for _ in range(n_shards)])
    offs.sort(axis=1)
    cols = (np.arange(n_shards, dtype=np.int64)[:, None] * SHARD_WIDTH
            + offs).reshape(-1)
    vals = rng.integers(0, 1 << BSI_DEPTH, size=cols.size, dtype=np.int64)
    return cols, vals


def last_wins(cols: np.ndarray, vals: np.ndarray) -> tuple:
    """Sorted unique columns with the last value written to each."""
    order = np.argsort(cols, kind="stable")
    cols, vals = cols[order], vals[order]
    last = np.concatenate([cols[1:] != cols[:-1], [True]])
    return cols[last], vals[last]


def bsi_phase(srv, port: int, packed: list, exists: np.ndarray,
              n_shards: int, per_shard: int, seed: int, clients: int,
              per_client: int) -> dict:
    """The BSI path on the Count phase's server and index; its own launch
    counts (zeroed before its first query, read after its last)."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    cols, vals = make_values(n_shards, per_shard, seed)
    log(f"  bsi data: {cols.size} values over {n_shards} shards "
        f"({per_shard} columns per shard, reduced from {SHARD_WIDTH}) "
        f"({time.perf_counter() - t0:.1f} s)")
    _http(port, "POST", "/index/i/field/v", json.dumps(
        {"options": {"type": "int", "min": 0,
                     "max": (1 << BSI_DEPTH) - 1}}).encode())
    t0 = time.perf_counter()
    srv.api.import_values("i", "v", cols, vals)
    rng = np.random.default_rng(seed + 8)
    n_total = n_shards * SHARD_WIDTH
    json_cols = np.concatenate([rng.choice(cols, size=500, replace=False),
                                rng.integers(0, n_total, size=500)])
    json_vals = rng.integers(0, 1 << BSI_DEPTH, size=json_cols.size)
    _http(port, "POST", "/index/i/field/v/import", json.dumps(
        {"columnIDs": json_cols.tolist(),
         "values": json_vals.tolist()}).encode())
    set_cols = np.array([int(cols[0]), int(cols[-1]), 3, n_total - 1],
                        dtype=np.int64)
    set_vals = np.array([1023, 0, 7, 512], dtype=np.int64)
    for c, x in zip(set_cols.tolist(), set_vals.tolist()):
        _http(port, "POST", "/index/i/query", f"Set({c}, v={x})".encode())
    import_s = time.perf_counter() - t0
    log(f"  bsi import: {import_s:.1f} s")
    cols, vals = last_wins(np.concatenate([cols, json_cols, set_cols]),
                           np.concatenate([vals, json_vals, set_vals]))
    hist = np.bincount(vals, minlength=1 << BSI_DEPTH).astype(np.int64)
    wsum = hist * np.arange(hist.size, dtype=np.int64)
    in_f1 = _bit_test(packed[1], cols)
    in_f0 = _bit_test(packed[0], cols)
    n_exists = _popcount(exists) + int((~_bit_test(exists, cols)).sum())

    def vc(sel) -> dict:
        return {"value": int(vals[sel].sum()), "count": int(sel.sum())}

    def extreme(sel, fn) -> dict:
        if not sel.any():
            return {"value": 0, "count": 0}
        x = int(fn(vals[sel]))
        return {"value": x, "count": int((vals[sel] == x).sum())}

    def query(pql: str, path: str = "/index/i/query"):
        return _http(port, "POST", path, pql.encode())["results"][0]

    kernels.reset_launch_counts()  # the BSI path starts here
    t0 = time.perf_counter()
    got = query("Sum(field=v)")
    cold_ms = (time.perf_counter() - t0) * 1e3
    if got != vc(np.ones(vals.size, bool)):
        raise AssertionError(f"Sum(field=v): port {got}")
    log(f"  cold Sum(field=v) (plane slab built from the fragments): "
        f"{cold_ms:.1f} ms")
    everything = np.ones(vals.size, bool)
    checks = [
        ("Sum(field=v)", vc(everything)),
        ("Sum(Range(v > 511), field=v)",
         {"value": int(wsum[512:].sum()), "count": int(hist[512:].sum())}),
        ("Sum(Row(f=1), field=v)", vc(in_f1)),
        ("Min(field=v)", extreme(everything, np.min)),
        ("Max(field=v)", extreme(everything, np.max)),
        ("Min(Row(f=1), field=v)", extreme(in_f1, np.min)),
        ("Max(Intersect(Row(f=0), Row(f=1)), field=v)",
         extreme(in_f0 & in_f1, np.max)),
        ("Count(Range(v >< [100, 200]))", int(hist[100:201].sum())),
        ("Count(Intersect(Row(f=0), Range(v < 300)))",
         int((in_f0 & (vals < 300)).sum())),
        ("Count(Range(v != null))", int(vals.size)),
        ("Count(Not(Range(v == 7)))", n_exists - int(hist[7])),
        ("Count(Range(v > 5000))", 0),
    ]
    t0 = time.perf_counter()
    for pql, want in checks:
        got = query(pql)
        if got != want:
            raise AssertionError(f"{pql}: port {got} != oracle {want}")
        log(f"  {pql} = {got} (oracle agrees)")
    sub = [s for s in (0, 1) if s < n_shards]
    got = query("Range(v == 7)", "/index/i/query?shards="
                + ",".join(map(str, sub)))
    want_cols = cols[(vals == 7) & (cols < (max(sub) + 1) * SHARD_WIDTH)]
    if got["columns"] != want_cols.tolist():
        raise AssertionError("Range(v == 7) ?shards=0,1 differs from the "
                             "oracle")
    log(f"  Range(v == 7) ?shards={sub}: {want_cols.size} columns "
        "(oracle agrees)")
    single_s = time.perf_counter() - t0

    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for i in range(per_client):
                x = 128 + 8 * ((cid * per_client + i) % 96)
                q = f"Sum(Range(v > {x}), field=v)"
                t = time.perf_counter()
                got = _http(port, "POST", "/index/i/query", q.encode(),
                            conn)["results"][0]
                dt = time.perf_counter() - t
                want = {"value": int(wsum[x + 1:].sum()),
                        "count": int(hist[x + 1:].sum())}
                with lock:
                    lat.append(dt)
                    if got != want:
                        errors.append((q, got, want))
        finally:
            conn.close()

    batcher = srv.executor.sum_batcher
    before = batcher.snapshot()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * per_client:
        raise AssertionError(
            f"{len(errors)} concurrent Sums differ, "
            f"{clients * per_client - len(lat)} missing; first {errors[:1]}")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the BSI path ends here
    forms = kernels.form_launch_counts()
    after = batcher.snapshot()
    res = srv.executor.residency.snapshot()
    stats = {
        "queries": len(lat), "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "max_batch_seen": after["max_batch_seen"],
        "batches": after["batches"] - before["batches"],
        "batched_queries": after["batched_queries"]
        - before["batched_queries"],
        "values": int(vals.size), "per_shard": per_shard,
        "import_s": import_s, "cold_slab_query_ms": cold_ms,
        "single_queries_s": single_s, "resident_bytes": res["bytes"],
        "resident_entries": res["entries"],
    }
    log(f"  concurrent: {clients} clients x {per_client} Sum(Range(v > x), "
        f"field=v): {stats['qps']:.1f} q/s, p50 {stats['p50_ms']:.2f} ms, "
        f"p99 {stats['p99_ms']:.2f} ms, max_batch_seen "
        f"{stats['max_batch_seen']} ({stats['batches']} batches)")
    log(f"  resident leaves: {res['entries']} entries, {res['bytes']} bytes")
    log(f"  launches on the BSI path: {launches}; by form: {forms}")
    for name in BSI_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the BSI path")
    if stats["max_batch_seen"] < 2:
        raise AssertionError("the PlaneSumBatcher never coalesced")
    return {"launches": launches, "forms": forms, "stats": stats}, (cols, vals)


def make_topn_rows(n_shards: int, top_bits: int, seed: int) -> list:
    """Sorted unique global columns of the TOPN_ROWS rows of t: row r with
    about top_bits / (r + 1) random bits per shard."""
    rng = np.random.default_rng(seed + 11)
    rows = []
    for r in range(TOPN_ROWS):
        card = max(top_bits // (r + 1), 1)
        cols = (np.repeat(np.arange(n_shards, dtype=np.int64), card)
                * SHARD_WIDTH
                + rng.integers(0, SHARD_WIDTH, size=card * n_shards))
        cols.sort()
        rows.append(cols[np.concatenate(([True], cols[1:] != cols[:-1]))])
    return rows


def _pairs(counts, ids=None) -> list:
    """TopN JSON of {row: count}: count desc, id asc, zeros dropped."""
    ids = range(len(counts)) if ids is None else ids
    got = sorted(((int(counts[i]), int(i)) for i in ids if counts[i] > 0),
                 key=lambda x: (-x[0], x[1]))
    return [{"id": i, "count": c} for c, i in got]


def _groups(names: list, counts: dict) -> list:
    """GroupBy JSON of {(row, ...): count}, lexicographic, zeros dropped."""
    return [{"group": [{"field": f, "rowID": int(r)}
                       for f, r in zip(names, key)], "count": int(c)}
            for key, c in sorted(counts.items()) if c > 0]


def topn_phase(srv, port: int, packed: list, values: tuple, rows: list,
               n_shards: int, seed: int, clients: int,
               per_client: int) -> dict:
    """TopN, Rows and GroupBy on the Count phase's server and index; its
    own launch counts (zeroed before its first query, read after its
    last). packed = the packed rows of f; values = (columns, values) of
    the int field v; rows = the columns of t's rows (make_topn_rows)."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    _http(port, "POST", "/index/i/field/t",
          json.dumps({"options": {"cacheType": "ranked"}}).encode())
    t0 = time.perf_counter()
    srv.api.import_bits("i", "t", *shard_major(rows, n_shards))
    rng = np.random.default_rng(seed + 12)
    n_total = n_shards * SHARD_WIDTH
    extra = np.unique(rng.integers(0, n_total, size=5000))
    _http(port, "POST", "/index/i/field/t/import", json.dumps(
        {"rowIDs": [TOPN_ROWS - 1] * extra.size,
         "columnIDs": extra.tolist()}).encode())
    rows[-1] = np.union1d(rows[-1], extra)
    # single bits: row 40 gains four columns of shard 0, row 0 loses one
    gain = np.setdiff1d(np.arange(100, 1100, 250), rows[40])[:4]
    for c in gain.tolist():
        _http(port, "POST", "/index/i/query", f"Set({c}, t=40)".encode())
    lose = int(rows[0][0])
    _http(port, "POST", "/index/i/query", f"Clear({lose}, t=0)".encode())
    rows[40] = np.union1d(rows[40], gain)
    rows[0] = rows[0][1:]
    import_s = time.perf_counter() - t0
    log(f"  topn import: {import_s:.1f} s")
    view = srv.holder.index("i").field("t").view("standard")
    frag0, cache0 = view.fragment(0), view.rank_caches[0]
    for r in (0, 40):
        want = int((rows[r] < SHARD_WIDTH).sum())
        if cache0.counts.get(r) != want or frag0.row_count(r) != want:
            raise AssertionError(f"rank cache of shard 0 row {r}: "
                                 f"{cache0.counts.get(r)} != {want}")
    log("  Set/Clear moved the rank cache of shard 0 (rows 0 and 40)")

    t0 = time.perf_counter()
    sizes = np.array([r.size for r in rows], dtype=np.int64)
    inter = np.array([[int(_bit_test(packed[a], rows[r]).sum())
                       for r in range(TOPN_ROWS)] for a in range(len(packed))])
    vcols, vvals = values
    packed_v = packed_row(vcols[vvals > 500], n_shards)
    log(f"  topn oracle: {time.perf_counter() - t0:.1f} s")

    def query(pql: str):
        return _http(port, "POST", "/index/i/query", pql.encode())["results"][0]

    def timed(pql: str, want, what: str) -> float:
        t = time.perf_counter()
        got = query(pql)
        ms = (time.perf_counter() - t) * 1e3
        if got != want:
            raise AssertionError(f"{pql}: port {str(got)[:300]} != oracle "
                                 f"{str(want)[:300]}")
        log(f"  {what}{pql[:100]}: {ms:.1f} ms (oracle agrees)")
        return ms

    kernels.reset_launch_counts()  # the TopN/GroupBy path starts here
    times = {
        "topn_cache_cold_ms": timed("TopN(t, n=10)", _pairs(sizes)[:10],
                                    "cold "),
        "topn_src_cold_ms": timed("TopN(t, Row(f=0), n=10)",
                                  _pairs(inter[0])[:10], "cold "),
        "topn_src_warm_ms": timed("TopN(t, Row(f=0), n=10)",
                                  _pairs(inter[0])[:10], "warm "),
    }
    fxt = {(a, r): inter[a, r] for a in range(len(packed))
           for r in range(TOPN_ROWS)}
    names = ["f", "t"]
    times["groupby_cold_ms"] = timed("GroupBy(Rows(field=f), Rows(field=t))",
                                     _groups(names, fxt), "cold ")
    times["groupby_warm_ms"] = timed("GroupBy(Rows(field=f), Rows(field=t))",
                                     _groups(names, fxt), "warm ")

    # Tanimoto against row 5 itself: only rows near |t_5| are recounted
    packed5 = packed_row(rows[5], n_shards)
    with5 = np.array([int(_bit_test(packed5, rows[r]).sum())
                      for r in range(TOPN_ROWS)])
    union = sizes + sizes[5] - with5
    tani = np.where(100 * with5 > 50 * union, with5, 0)
    band = (sizes > sizes[5] * 0.5) & (sizes < sizes[5] * 2)
    tani = np.where(band, tani, 0)
    x = int(np.sort(inter[1])[TOPN_ROWS // 2])  # a threshold mid-way
    thr = np.where(inter[1] >= x, inter[1], 0)
    ids = [0, 5, 17, TOPN_ROWS - 1, 99]
    probe = int(rows[3][len(rows[3]) // 2])
    with_col = [r for r in range(TOPN_ROWS)
                if np.searchsorted(rows[r], probe) < rows[r].size
                and rows[r][np.searchsorted(rows[r], probe)] == probe]
    filt = {}
    for r in range(TOPN_ROWS):
        sel = rows[r][_bit_test(packed_v, rows[r])]
        for a in range(len(packed)):
            filt[(a, r)] = int(_bit_test(packed[a], sel).sum())
    three = {}
    for r in range(3):
        for a in range(2):
            in_a = _bit_test(packed[a], rows[r])
            for b in (6, 7):
                three[(a, r, b)] = int((in_a & _bit_test(packed[b],
                                                         rows[r])).sum())
    checks = [
        ("TopN(t, n=0)", _pairs(sizes)),
        ("TopN(t, Row(t=5), n=5, tanimotoThreshold=50)", _pairs(tani)[:5]),
        (f"TopN(t, Row(f=1), threshold={x}, n=10)", _pairs(thr)[:10]),
        ("TopN(t, Row(f=2), ids=[" + ", ".join(map(str, ids)) + "])",
         _pairs(np.append(inter[2], [0] * (100 - TOPN_ROWS)), ids)),
        ("Rows(field=t)", {"rows": list(range(TOPN_ROWS))}),
        ("Rows(field=t, limit=5, previous=3)", {"rows": [4, 5, 6, 7, 8]}),
        (f"Rows(field=t, column={probe})", {"rows": with_col}),
        ("GroupBy(Rows(field=f), Rows(field=t), limit=20)",
         _groups(names, fxt)[:20]),
        ("GroupBy(Rows(field=f), Rows(field=t), filter=Range(v > 500))",
         _groups(names, filt)),
        ("GroupBy(Rows(field=f, limit=2), Rows(field=t, limit=3), "
         "Rows(field=f, previous=5), limit=7)",
         _groups(["f", "t", "f"], three)[:7]),
    ]
    for a in range(1, len(packed)):
        checks.append((f"TopN(t, Row(f={a}), n=10)", _pairs(inter[a])[:10]))
    t0 = time.perf_counter()
    for pql, want in checks:
        timed(pql, want, "")
    single_s = time.perf_counter() - t0

    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for i in range(per_client):
                a = (cid + i) % len(packed)
                q = f"TopN(t, Row(f={a}), n=10)"
                t = time.perf_counter()
                got = _http(port, "POST", "/index/i/query", q.encode(),
                            conn)["results"][0]
                dt = time.perf_counter() - t
                with lock:
                    lat.append(dt)
                    if got != _pairs(inter[a])[:10]:
                        errors.append((q, got))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * per_client:
        raise AssertionError(
            f"{len(errors)} concurrent TopNs differ, "
            f"{clients * per_client - len(lat)} missing; first {errors[:1]}")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the TopN/GroupBy path ends here
    res = srv.executor.residency.snapshot()
    stats = {
        "queries": len(lat), "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "bits": int(sizes.sum()), "import_s": import_s,
        "single_queries_s": single_s, **times,
        "topn_recount_rows": srv.executor.topn_recount_rows,
        "groupby_host_syncs": srv.executor.groupby_host_syncs,
        "resident_bytes": res["bytes"], "resident_entries": res["entries"],
        "evictions": res["evictions"],
    }
    log(f"  concurrent: {clients} clients x {per_client} TopN(t, Row(f=a), "
        f"n=10): {stats['qps']:.1f} q/s, p50 {stats['p50_ms']:.2f} ms, p99 "
        f"{stats['p99_ms']:.2f} ms")
    log(f"  resident leaves: {res['entries']} entries, {res['bytes']} bytes, "
        f"{res['evictions']} evictions")
    log(f"  launches on the TopN/GroupBy path: {launches}")
    for name in TOPN_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the TopN/GroupBy "
                                 "path")
    stats["phase_s"] = time.perf_counter() - t_phase
    stats["cleared_t0_column"] = lose
    log(f"  TopN/GroupBy phase: {stats['phase_s']:.1f} s")
    return {"launches": launches, "stats": stats}


def make_hybrid_rows(n_shards: int, seed: int) -> tuple:
    """(s rows, r rows): sorted unique global columns. Row a of s holds
    min(4096, 8 * 2^(a mod 10)) random bits in every shard (after dedup a
    few fewer), so it plans sparse with K = 8..4096; each row of r holds
    2-16 intervals per shard totalling 5000-8000 bits (over the sparse
    threshold, far under 2048 intervals), so it plans run. Interval i of a
    shard starts at a distinct multiple of 8192 and is at most 8000 long:
    the intervals are disjoint and never adjacent."""
    rng = np.random.default_rng(seed + 21)
    shard_base = np.arange(n_shards, dtype=np.int64) * SHARD_WIDTH
    s_rows = []
    for a in range(HYBRID_S_ROWS):
        card = min(4096, 8 << (a % 10))
        cols = (np.repeat(shard_base, card)
                + rng.integers(0, SHARD_WIDTH, size=card * n_shards))
        cols.sort()
        s_rows.append(cols[np.concatenate(([True], cols[1:] != cols[:-1]))])
    r_rows = []
    slots = SHARD_WIDTH // 8192
    for _ in range(HYBRID_R_ROWS):
        parts = []
        for base in shard_base.tolist():
            n_iv = int(rng.integers(2, 17))
            total = int(rng.integers(5000, 8001))
            cuts = np.sort(rng.choice(np.arange(1, total), size=n_iv - 1,
                                      replace=False))
            lengths = np.diff(np.concatenate(([0], cuts, [total])))
            starts = np.sort(rng.choice(slots, size=n_iv,
                                        replace=False)) * 8192 + base
            parts += [np.arange(st, st + ln, dtype=np.int64)
                      for st, ln in zip(starts.tolist(), lengths.tolist())]
        r_rows.append(np.concatenate(parts))
    return s_rows, r_rows


def _contains(sorted_cols: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Whether each of cols lies in the sorted array sorted_cols."""
    i = np.searchsorted(sorted_cols, cols)
    i_c = np.minimum(i, max(sorted_cols.size - 1, 0))
    return (i < sorted_cols.size) & (sorted_cols[i_c] == cols)


def load_hybrid_fields(srv, port: int, n_shards: int, seed: int) -> tuple:
    """Create the set fields s and r and import make_hybrid_rows' rows ->
    (s rows, r rows, import seconds)."""
    t0 = time.perf_counter()
    s_rows, r_rows = make_hybrid_rows(n_shards, seed)
    log(f"  hybrid data: {HYBRID_S_ROWS} rows of s, "
        f"{sum(r.size for r in s_rows)} bits; {HYBRID_R_ROWS} rows of r, "
        f"{sum(r.size for r in r_rows)} bits "
        f"({time.perf_counter() - t0:.1f} s)")
    # no rank caches: no query ranks s or r, and the import skips the
    # per-shard cache rebuild
    for name in ("s", "r"):
        _http(port, "POST", f"/index/i/field/{name}",
              json.dumps({"options": {"cacheType": "none"}}).encode())
    t0 = time.perf_counter()
    srv.api.import_bits("i", "s", *shard_major(s_rows, n_shards))
    srv.api.import_bits("i", "r", *shard_major(r_rows, n_shards))
    import_s = time.perf_counter() - t0
    log(f"  hybrid import: {import_s:.1f} s")
    return s_rows, r_rows, import_s


def hybrid_phase(srv, port: int, packed: list, exists: np.ndarray,
                 values: tuple, t_rows: list, t_cleared: int,
                 n_shards: int, seed: int, clients: int,
                 per_client: int) -> dict:
    """Sparse and run leaves on the Count phase's server and index: a
    stargazer-like set field s and a run field r, checked against a numpy
    oracle, then clients x per_client Count(Intersect(Row(s=a), Row(f=b)));
    its own launch counts (zeroed before its first query, read after its
    last). packed = the packed rows of f; exists = their union; values =
    (columns, values) of v; t_rows = the columns of t's rows and
    t_cleared the column cleared from t's row 0 (still existent)."""
    import torch

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel.residency import HybridManager

    t_phase = time.perf_counter()
    s_rows, r_rows, import_s = load_hybrid_fields(srv, port, n_shards, seed)

    t0 = time.perf_counter()
    vcols, vvals = values
    bits = np.zeros(n_shards * SHARD_WIDTH, dtype=bool)
    for cols in [vcols, *t_rows, [t_cleared], *s_rows, *r_rows]:
        bits[cols] = True
    exists_all = np.packbits(bits, bitorder="little") | exists
    del bits
    n_exists = _popcount(exists_all)
    packed_r = [packed_row(c, n_shards) for c in r_rows[:2]]
    packed_v500 = packed_row(vcols[vvals > 500], n_shards)
    pair = np.array([[int(_bit_test(packed[b], s_rows[a]).sum())
                      for b in range(len(packed))]
                     for a in range(HYBRID_S_ROWS)])
    log(f"  hybrid oracle: {time.perf_counter() - t0:.1f} s")

    def query(pql: str):
        return _http(port, "POST", "/index/i/query", pql.encode())["results"][0]

    def inter(a_cols: np.ndarray, b_cols: np.ndarray) -> int:
        return int(_contains(b_cols, a_cols).sum())

    a, c, b = 3, 7, 1  # s rows of 64 and 1024 bits per shard, f row 1
    in_v = _contains(s_rows[5], vcols)
    packed_s5 = packed_row(s_rows[5], n_shards)
    tcounts = np.array([int(_bit_test(packed_s5, rows).sum())
                        for rows in t_rows])
    want_cols = s_rows[a][_bit_test(packed[b], s_rows[a])]
    checks = [
        (f"Count(Intersect(Row(s={a}), Row(f={b})))", int(pair[a, b])),
        (f"Count(Intersect(Row(f={b}), Row(s={a})))", int(pair[a, b])),
        (f"Intersect(Row(s={a}), Row(f={b}))",
         {"attrs": {}, "columns": want_cols.tolist()}),
        (f"Count(Intersect(Row(s={a}), Row(s={c})))",
         inter(s_rows[a], s_rows[c])),
        (f"Count(Union(Row(s={a}), Row(s={c})))",
         int(np.union1d(s_rows[a], s_rows[c]).size)),
        (f"Count(Xor(Row(s={a}), Row(s={c})))",
         int(np.setxor1d(s_rows[a], s_rows[c], assume_unique=True).size)),
        (f"Count(Difference(Row(s=9), Row(f={b})))",
         int(s_rows[9].size - pair[9, b])),
        (f"Count(Not(Row(s={c})))", n_exists - int(s_rows[c].size)),
        (f"Count(Intersect(Row(s=9), Row(r=0)))", inter(s_rows[9], r_rows[0])),
        (f"Count(Intersect(Row(r=0), Row(f={b})))",
         int(_bit_test(packed[b], r_rows[0]).sum())),
        ("Count(Intersect(Row(r=0), Row(r=1)))",
         int(_bit_test(packed_r[1], r_rows[0]).sum())),
        ("Count(Row(r=2))", int(r_rows[2].size)),
        ("Count(Intersect(Row(s=9), Range(v > 500)))",
         int(_bit_test(packed_v500, s_rows[9]).sum())),
        ("Sum(Row(s=5), field=v)",
         {"value": int(vvals[in_v].sum()), "count": int(in_v.sum())}),
        ("TopN(t, Row(s=5), n=5)", _pairs(tcounts)[:5]),
    ]
    kernels.reset_launch_counts()  # the hybrid path starts here
    t0 = time.perf_counter()
    got = query("Count(Row(s=9))")
    cold_ms = (time.perf_counter() - t0) * 1e3
    if got != int(s_rows[9].size):
        raise AssertionError(f"Count(Row(s=9)): port {got} != oracle "
                             f"{s_rows[9].size}")
    log(f"  cold Count(Row(s=9)) (one sparse leaf, K = 4096, built from "
        f"{n_shards} fragments): {cold_ms:.1f} ms (oracle agrees)")
    t0 = time.perf_counter()
    for pql, want in checks:
        got = query(pql)
        if got != want:
            raise AssertionError(f"{pql}: port {str(got)[:300]} != oracle "
                                 f"{str(want)[:300]}")
        log(f"  {pql[:100]} = {str(got)[:60]} (oracle agrees)")
    single_s = time.perf_counter() - t0
    # every row of s once, so the concurrent pass runs on resident leaves
    # (a burst of cold misses would build each leaf once per thread)
    t0 = time.perf_counter()
    for sa in range(HYBRID_S_ROWS):
        got = query(f"Count(Row(s={sa}))")
        if got != int(s_rows[sa].size):
            raise AssertionError(f"Count(Row(s={sa})): port {got} != oracle "
                                 f"{s_rows[sa].size}")
    warm_s = time.perf_counter() - t0
    log(f"  Count(Row(s=a)) for all {HYBRID_S_ROWS} rows (the leaves not yet "
        f"resident built from the host): {warm_s:.1f} s (oracle agrees)")

    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        rng = np.random.default_rng(seed + 3000 + cid)
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for _ in range(per_client):
                sa = int(rng.integers(HYBRID_S_ROWS))
                fb = int(rng.integers(len(packed)))
                q = f"Count(Intersect(Row(s={sa}), Row(f={fb})))"
                t = time.perf_counter()
                got = _http(port, "POST", "/index/i/query", q.encode(),
                            conn)["results"][0]
                dt = time.perf_counter() - t
                with lock:
                    lat.append(dt)
                    if got != int(pair[sa, fb]):
                        errors.append((q, got, int(pair[sa, fb])))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * per_client:
        raise AssertionError(
            f"{len(errors)} concurrent hybrid Counts differ, "
            f"{clients * per_client - len(lat)} missing; first {errors[:1]}")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the hybrid path ends here
    hyb = srv.executor.hybrid_snapshot()
    dense_equiv = HYBRID_S_ROWS * n_shards * SHARD_WIDTH // 8
    # the K of each row of s: its largest shard, padded as the chooser pads
    served_k = sorted({HybridManager.pad_slots(int(np.bincount(
        r // SHARD_WIDTH, minlength=n_shards).max())) for r in s_rows})
    stats = {
        "queries": len(lat), "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "s_bits": int(sum(r.size for r in s_rows)),
        "r_bits": int(sum(r.size for r in r_rows)),
        "import_s": import_s, "cold_sparse_leaf_ms": cold_ms,
        "single_queries_s": single_s, "warm_s_rows_s": warm_s,
        "hybrid": hyb,
        "s_rows_as_dense_bytes": dense_equiv, "served_k": served_k,
    }
    log(f"  concurrent: {clients} clients x {per_client} Count(Intersect("
        f"Row(s=a), Row(f=b))): {stats['qps']:.1f} q/s, p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms")
    log(f"  resident by form: sparse {hyb['residentSparseLeaves']} leaves, "
        f"{hyb['residentSparseBytes']} bytes (the {HYBRID_S_ROWS} rows of s "
        f"as planes: {dense_equiv} bytes); run {hyb['residentRunLeaves']} "
        f"leaves, {hyb['residentRunBytes']} bytes; dense "
        f"{hyb['residentDenseLeaves']} leaves, {hyb['residentDenseBytes']} "
        f"bytes")
    log(f"  hybrid uploads: sparse {hyb['sparseUploads']}, run "
        f"{hyb['runUploads']}, dense {hyb['denseUploads']}; expanded on the "
        f"device {hyb['materialized']}")
    log(f"  launches on the hybrid path: {launches}")
    if launches["sparse_intersect_dense"] < 1:
        raise AssertionError("sparse_intersect_dense never launched on the "
                             "hybrid path")
    if hyb["sparseUploads"] < 1 or hyb["runUploads"] < 1:
        raise AssertionError(f"no sparse or no run upload: {hyb}")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"  hybrid phase: {stats['phase_s']:.1f} s")
    return {"launches": launches, "stats": stats,
            "data": (exists_all, s_rows, r_rows)}


def make_ingest_ops(n_shards: int, seed: int, writers: int, n_env: int,
                    calls: int, targets: list) -> list:
    """Per writer, n_env envelopes of `calls` (is_set, field, row, col)
    ops: 80 % Set of a random column of its own (col % writers ==
    writer) over all shards on a random target row, 20 % Clear of a
    (row, column) it set earlier (bench.py:1888-1897)."""
    n_cols = n_shards * SHARD_WIDTH
    out = []
    for w in range(writers):
        rng = np.random.default_rng(seed + 5000 + w)
        n = n_env * calls
        is_set = (rng.random(n) >= 0.2).tolist()
        tgt = rng.integers(len(targets), size=n).tolist()
        cols = (rng.integers(n_cols // writers, size=n) * writers
                + w).tolist()
        pick = rng.random(n).tolist()
        ops, done = [], []
        for k in range(n):
            if is_set[k] or not done:
                f, r = targets[tgt[k]]
                ops.append((True, f, r, cols[k]))
                done.append((f, r, cols[k]))
            else:
                f, r, c = done[int(pick[k] * len(done))]
                ops.append((False, f, r, c))
        out.append([ops[e * calls:(e + 1) * calls] for e in range(n_env)])
    return out


def envelope_pql(ops: list) -> bytes:
    return "".join(f"{'Set' if s else 'Clear'}({c}, {f}={r})"
                   for s, f, r, c in ops).encode()


class WriteOracle:
    """The bits the writers leave, updated in each writer's own order:
    columns are disjoint per writer, so the final state and every changed
    flag are exact whatever the interleaving."""

    def __init__(self, packed_f: list, exists: np.ndarray, sorted_rows: dict):
        self.packed_f = packed_f        # f row -> packed bits (updated)
        self.exists = exists            # packed existence (updated)
        self.base = sorted_rows         # (field, row) -> sorted columns
        self.rows = dict(sorted_rows)   # (field, row) -> current columns
        self.state: dict = {}           # (field, row, col) -> bit

    def _base_bits(self, keys: list) -> list:
        by_row: dict = {}
        for i, (f, r, c) in enumerate(keys):
            by_row.setdefault((f, r), []).append((i, c))
        out = [False] * len(keys)
        for (f, r), items in by_row.items():
            cols = np.array([c for _, c in items], dtype=np.int64)
            hit = (_bit_test(self.packed_f[r], cols) if f == "f"
                   else _contains(self.base[(f, r)], cols))
            for (i, _), h in zip(items, hit.tolist()):
                out[i] = h
        return out

    def flags(self, ops: list) -> list:
        """Each op's changed flag, in order; records the new state."""
        new = list({(f, r, c) for _, f, r, c in ops} - self.state.keys())
        self.state.update(zip(new, self._base_bits(new)))
        out = []
        for is_set, f, r, c in ops:
            key = (f, r, c)
            out.append(self.state[key] != is_set)
            self.state[key] = is_set
        return out

    def settle(self, set_cols: list) -> None:
        """Fold the state flags() recorded so far into the rows; set_cols:
        every column a Set named since the last settle (existence is never
        cleared)."""
        on: dict = {}
        off: dict = {}
        for (f, r, c), bit in self.state.items():
            (on if bit else off).setdefault((f, r), []).append(c)
        for key in set(on) | set(off):
            f, r = key
            a = np.array(on.get(key, []), dtype=np.int64)
            b = np.array(off.get(key, []), dtype=np.int64)
            if f == "f":
                p = self.packed_f[r]
                np.bitwise_or.at(p, a >> 3,
                                 np.left_shift(1, a & 7).astype(np.uint8))
                np.bitwise_and.at(p, b >> 3, ~np.left_shift(
                    1, b & 7).astype(np.uint8))
            else:
                self.rows[key] = np.union1d(
                    np.setdiff1d(self.base[key], b), a)
        if set_cols:
            c = np.asarray(set_cols, dtype=np.int64)
            np.bitwise_or.at(self.exists, c >> 3,
                             np.left_shift(1, c & 7).astype(np.uint8))

    def count(self, field: str, row: int) -> int:
        if field == "f":
            return _popcount(self.packed_f[row])
        return int(self.rows[(field, row)].size)


def _percentiles(lat: list) -> tuple:
    return (statistics.median(lat) * 1e3,
            float(np.percentile(lat, 99)) * 1e3)


def ingest_phase(srv, port: int, packed: list, exists: np.ndarray,
                 s_rows: list, r_rows: list, n_shards: int, seed: int,
                 writers: int, envelopes: int, calls: int, readers: int,
                 turn_envelopes: int) -> dict:
    """The coalesced write path on the earlier phases' server and index:
    `writers` keep-alive writers send `envelopes` envelopes of `calls`
    Set/Clear each (80/20) on f rows 0-7 (dense), the s rows
    INGEST_S_ROWS (sparse) and r row 0 (run), all resident, while
    `readers` clients run Count(Intersect(Row(f=a), Row(f=b))); then exact
    read-backs against the numpy oracle, and the first Count(Intersect)
    after a burst with ingest on, then off (PILOSA_TPU_TORCH_INGEST=0).
    Its own launch counts (zeroed before its first query). packed =
    the packed rows of f; exists = the packed existence row; s_rows /
    r_rows = the columns of s's and r's rows."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    ex = srv.executor
    n_f = len(packed)
    # the interpreter's collector pauses, by generation, over the phase
    gc_pause = {0: 0.0, 1: 0.0, 2: 0.0}
    gc_t0: list = [0.0]

    def gc_watch(phase: str, info: dict) -> None:
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_pause[info["generation"]] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(gc_watch)
    targets = ([("f", a) for a in range(n_f)]
               + [("s", a) for a in INGEST_S_ROWS] + [("r", 0)])
    t0 = time.perf_counter()
    n_env = envelopes + len(INGEST_TURNS) * turn_envelopes
    ops = make_ingest_ops(n_shards, seed, writers, n_env, calls, targets)
    bodies = [[envelope_pql(e) for e in w] for w in ops]
    oracle = WriteOracle(packed, exists,
                         {**{("s", a): s_rows[a] for a in INGEST_S_ROWS},
                          ("r", 0): r_rows[0]})
    want_flags: list = [[None] * n_env for _ in ops]
    log(f"  write traffic: {writers} writers x {n_env} envelopes x {calls} "
        f"calls, {sum(f[0] for w in ops for e in w for f in e)} Sets "
        f"({time.perf_counter() - t0:.1f} s)")

    def query(pql: str, conn=None):
        return _http(port, "POST", "/index/i/query", pql.encode(),
                     conn)["results"]

    def send(w: int, lo: int, hi: int, acked: list, errors: list) -> None:
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for e in range(lo, hi):
                got = query(bodies[w][e].decode(), conn)
                if got != want_flags[w][e]:
                    errors.append(f"writer {w} envelope {e}: changed flags "
                                  "differ from the oracle")
                acked[w] += len(got)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"writer {w}: {e!r}")
        finally:
            conn.close()

    def write_burst(lo: int, hi: int) -> tuple:
        """Every writer sends its envelopes lo..hi-1 -> (acked, seconds);
        their flags are simulated first, the oracle updated after."""
        for w in range(writers):
            for e in range(lo, hi):
                want_flags[w][e] = oracle.flags(ops[w][e])
        acked = [0] * writers
        errors: list = []
        ts = [threading.Thread(target=send, args=(w, lo, hi, acked, errors))
              for w in range(writers)]
        log(f"  writers start: envelopes {lo}..{hi - 1} each "
            f"({time.perf_counter() - t_phase:.1f} s into the phase)")
        t = time.perf_counter()
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        wall = time.perf_counter() - t
        log(f"  writers done in {wall:.2f} s")
        if errors:
            raise AssertionError(f"{len(errors)} writer errors: {errors[:3]}")
        oracle.settle([c for w in ops for e in w[lo:hi]
                       for s, _, _, c in e if s])
        return sum(acked), wall

    kernels.reset_launch_counts()  # the write path starts here
    # every written row resident before the writes
    for f, r in targets:
        if query(f"Count(Row({f}={r}))")[0] != oracle.count(f, r):
            raise AssertionError(f"Count(Row({f}={r})) differs before writes")
    pair = np.zeros((n_f, n_f), dtype=np.int64)
    for a in range(n_f):
        for b in range(a, n_f):
            pair[a, b] = pair[b, a] = _and_count(packed[a], packed[b])

    def reader(rid: int, stop, n: int, lat: list, errors: list,
               check: bool) -> None:
        rng = np.random.default_rng(seed + 9000 + rid)
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            k = 0
            while (stop is None and k < n) or (stop is not None
                                               and not stop.is_set()):
                a, b = (int(x) for x in rng.integers(n_f, size=2))
                t = time.perf_counter()
                got = query(f"Count(Intersect(Row(f={a}), Row(f={b})))",
                            conn)[0]
                lat.append(time.perf_counter() - t)
                if check and got != int(pair[a, b]):
                    errors.append((a, b, got, int(pair[a, b])))
                k += 1
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            conn.close()

    def read_round(stop=None, n: int = 16, check: bool = True) -> list:
        lat: list = []
        errors: list = []
        ts = [threading.Thread(target=reader,
                               args=(i, stop, n, lat, errors, check))
              for i in range(readers)]
        for t in ts:
            t.start()
        return ts, lat, errors

    ts, base_lat, errors = read_round()
    for t in ts:
        t.join()
    if errors:
        raise AssertionError(f"writer-free round: {errors[:3]}")
    base_p50, base_p99 = _percentiles(base_lat)

    # -- the measured window: writers and readers together -------------
    before = ex.ingest_snapshot()
    hyb_before = ex.hybrid_snapshot()
    stop = threading.Event()
    ts, win_lat, errors = read_round(stop=stop, check=False)
    acked, wall = write_burst(0, envelopes)
    stop.set()
    for t in ts:
        t.join()
    if errors:
        raise AssertionError(f"readers during the writes: {errors[:3]}")
    after = ex.ingest_snapshot()
    win_uploads = ex.hybrid_snapshot()["denseUploads"] - hyb_before[
        "denseUploads"]
    win_p50, win_p99 = _percentiles(win_lat)
    delta = {k: after[k] - before[k]
             for k in ("batches", "batched_queries", "mutations",
                       "setMutations", "clearMutations", "appliedBatches",
                       "walAppends", "walOps", "errors", "patchedDense",
                       "patchedSparse", "patchDropped", "patchDroppedDense",
                       "patchDroppedSparse", "hybridEvals", "applySeconds")}
    commit_ratio = ((delta["mutations"] + delta["setMutations"])
                    / max(delta["walAppends"], 1))
    log(f"  window: {acked} mutations acked in {wall:.2f} s = "
        f"{acked / wall:.1f} mutations/s; {len(win_lat)} reads, p50 "
        f"{win_p50:.2f} ms, p99 {win_p99:.2f} ms (writer-free round: p50 "
        f"{base_p50:.2f} ms, p99 {base_p99:.2f} ms); {win_uploads} dense "
        "leaves built from the host during the window")
    log(f"  apply: {delta['applySeconds']:.2f} s of host time in "
        f"{delta['batches']} batches (max_batch_seen "
        f"{after['max_batch_seen']} requests), fragment applies "
        f"{delta['appliedBatches']}, WAL appends {delta['walAppends']}, "
        f"group-commit ratio {commit_ratio:.2f}; patchedDense "
        f"{delta['patchedDense']}, patchedSparse {delta['patchedSparse']}, "
        f"patchDropped {delta['patchDropped']} (sparse bucket moves "
        f"{delta['patchDroppedSparse']}, dense {delta['patchDroppedDense']})")

    # -- read-backs: the f rows first, which must not be re-uploaded -----
    torch.cuda.synchronize()
    launches_writes = kernels.launch_counts()
    shards = srv.holder.index("i").available_shards_list()
    fview = srv.holder.index("i").field("f").view("standard")
    for a in range(n_f):
        gens = tuple(fview.fragment(s).row_generation(a) for s in shards)
        if ex.residency.peek(("row", "i", "f", "standard", a, tuple(shards),
                              gens)) is None:
            raise AssertionError(f"f row {a}: no resident leaf under its "
                                 "post-write generations (a patch missed)")
    p = packed
    pairs = [(a, (a + 1 + a // 4) % n_f) for a in range(n_f)]
    f_checks = ([(f"Count(Row(f={a}))", _popcount(p[a])) for a in range(n_f)]
                + [(f"Count(Intersect(Row(f={a}), Row(f={b})))",
                    _and_count(p[a], p[b])) for a, b in pairs]
                + [("Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))",
                    _and_count(p[0], p[1], p[2])),
                   ("TopN(f, Row(f=0), n=8)",
                    _pairs([_and_count(p[a], p[0]) for a in range(n_f)])[:8])])
    s_list = list(INGEST_S_ROWS)
    other_checks = (
        [(f"Count(Row(s={a}))", oracle.count("s", a)) for a in s_list]
        + [("Count(Row(r=0))", oracle.count("r", 0))]
        + [(f"Count(Intersect(Row(s={a}), Row(f={a % n_f})))",
            int(_bit_test(p[a % n_f], oracle.rows[("s", a)]).sum()))
           for a in s_list]
        + [("TopN(f, n=8)", _pairs([_popcount(x) for x in p])[:8]),
           ("Count(Not(Row(f=0)))", _popcount(oracle.exists & ~p[0]))])
    hyb0 = ex.hybrid_snapshot()
    for i, (pql, want) in enumerate(f_checks + other_checks):
        if i == len(f_checks):
            hyb1 = ex.hybrid_snapshot()
            if hyb1["denseUploads"] != hyb0["denseUploads"]:
                raise AssertionError(
                    f"{hyb1['denseUploads'] - hyb0['denseUploads']} dense "
                    "uploads while reading the written f rows: a patch was "
                    "missed")
        got = query(pql)[0]
        if got != want:
            raise AssertionError(f"{pql} after the writes: port "
                                 f"{str(got)[:200]} != oracle "
                                 f"{str(want)[:200]}")
        log(f"  {pql} = {str(got)[:60]} (oracle agrees)")
    torch.cuda.synchronize()
    launches_reads = kernels.launch_counts()
    hyb2 = ex.hybrid_snapshot()
    uploads_after = {
        form: {"uploads": hyb2[f"{form}Uploads"] - hyb0[f"{form}Uploads"],
               "bytes": (hyb2[f"{form}BytesUploaded"]
                         - hyb0[f"{form}BytesUploaded"])}
        for form in ("dense", "sparse", "run")}
    log(f"  read-backs done ({time.perf_counter() - t_phase:.1f} s into "
        "the phase)")
    log(f"  uploaded by form after the writes: {uploads_after} (the "
        "existence row and the dropped sparse and run leaves)")
    for name in ("pair_stream_counts", "program_count",
                 "sparse_intersect_dense", "topn_counts_packed"):
        if launches_reads[name] <= launches_writes[name]:
            raise AssertionError(f"{name} never launched after the writes")
    if delta["patchedDense"] < 1:
        raise AssertionError("no resident dense leaf was patched")
    if after["patchDroppedDense"]:
        raise AssertionError(f"{after['patchDroppedDense']} dense patches "
                             "raised and were dropped")

    # -- the first read after a burst, ingest on, then off --------------
    turns = []
    lo = envelopes
    pair_q = "Count(Intersect(Row(f=0), Row(f=1)))"
    for mode in INGEST_TURNS:
        hi = lo + turn_envelopes
        if mode == "off":
            os.environ["PILOSA_TPU_TORCH_INGEST"] = "0"
        try:
            n_acked, burst_s = write_burst(lo, hi)
        finally:
            os.environ.pop("PILOSA_TPU_TORCH_INGEST", None)
        lo = hi
        hyb_a = ex.hybrid_snapshot()
        t = time.perf_counter()
        got = query(pair_q)[0]
        first_ms = (time.perf_counter() - t) * 1e3
        hyb_b = ex.hybrid_snapshot()
        want = _and_count(p[0], p[1])
        if got != want:
            raise AssertionError(f"{pair_q} after an ingest-{mode} burst: "
                                 f"port {got} != oracle {want}")
        # after a batched burst, the sparse rows the read-backs made
        # resident were patched (or dropped on a bucket move): check them
        for a in s_list if mode == "on" else ():
            if query(f"Count(Row(s={a}))")[0] != oracle.count("s", a):
                raise AssertionError(f"Count(Row(s={a})) after an "
                                     f"ingest-{mode} burst")
        turns.append({"ingest": mode, "mutations": n_acked,
                      "mutations_per_s": n_acked / burst_s,
                      "first_read_ms": first_ms,
                      "first_read_dense_uploads": (hyb_b["denseUploads"]
                                                   - hyb_a["denseUploads"])})
        log(f"  ingest {mode}: {n_acked} mutations in {burst_s:.2f} s "
            f"({n_acked / burst_s:.1f} /s); first {pair_q} "
            f"{first_ms:.2f} ms, {turns[-1]['first_read_dense_uploads']} "
            "dense uploads (oracle agrees)")
    for a in range(n_f):
        if query(f"Count(Row(f={a}))")[0] != _popcount(p[a]):
            raise AssertionError(f"Count(Row(f={a})) after the turns")
    if query("Count(Not(Row(f=0)))")[0] != _popcount(oracle.exists & ~p[0]):
        raise AssertionError("Count(Not(Row(f=0))) after the turns")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the write path ends here
    final = ex.ingest_snapshot()
    log(f"  launches on the write path: {launches}")
    stats = {
        "mutations": acked, "window_s": wall,
        "mutations_per_s": acked / wall, "group_commit_ratio": commit_ratio,
        "reads_in_window": len(win_lat), "read_p50_ms": win_p50,
        "read_p99_ms": win_p99, "base_read_p50_ms": base_p50,
        "base_read_p99_ms": base_p99, "window": delta,
        "max_batch_seen": after["max_batch_seen"],
        "dense_uploads_in_window": win_uploads,
        "uploads_after_writes": uploads_after, "turns": turns,
        "patched_sparse_total": final["patchedSparse"],
        "patch_dropped_sparse_total": final["patchDroppedSparse"],
    }
    gc.callbacks.remove(gc_watch)
    stats["gc_pause_s"] = gc_pause
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"  write phase: {stats['phase_s']:.1f} s (garbage-collector "
        f"pauses by generation: {gc_pause})")
    return {"launches": launches, "stats": stats}


def device_busy_ms(prof) -> float | None:
    """Union of the device intervals a torch.profiler run recorded, in ms
    (None where it recorded none)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def server_phase(device, n_shards: int, n_rows: int, seed: int,
                 clients: int, per_client: int, profile: bool,
                 bsi: tuple, topn: tuple, hybrid: tuple, ingest: tuple,
                 count_only: bool = False, ingest_only: bool = False) -> dict:
    """The Count path, then (unless count_only or ingest_only) the BSI
    path, the TopN/GroupBy path and the hybrid path, then (unless
    count_only) the write path, on the same server and index (bsi = values
    per shard, seed, clients, queries per client; topn = bits per shard of
    t's row 0, seed, clients, queries per client; hybrid = seed, clients,
    queries per client; ingest = writers, envelopes per writer, calls per
    envelope, readers, envelopes per writer in each on/off turn).
    ingest_only loads s and r without the hybrid phase's checks."""
    import torch

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import Server

    t0 = time.perf_counter()
    rows = make_rows(n_rows, n_shards, seed)
    extra = np.array([3, 99, SHARD_WIDTH + 5, 2 * SHARD_WIDTH + 7],
                     dtype=np.int64) % (n_shards * SHARD_WIDTH)
    t_rows = ([] if count_only or ingest_only
              else make_topn_rows(n_shards, *topn[:2]))
    log(f"  data: {n_rows} rows x {n_shards} shards, "
        f"{sum(r.size for r in rows)} bits; {len(t_rows)} rows of t, "
        f"{sum(r.size for r in t_rows)} bits "
        f"({time.perf_counter() - t0:.1f} s)")

    kernels.reset_launch_counts()  # the main path starts here
    with tempfile.TemporaryDirectory(prefix="pilosa_torch_smoke_") as tmp:
        srv = Server(os.path.join(tmp, "data"), port=0, device=device).open()
        port = srv.http.port
        try:
            _http(port, "POST", "/index/i",
                  json.dumps({"options": {"trackExistence": True}}).encode())
            _http(port, "POST", "/index/i/field/f", b"{}")
            t0 = time.perf_counter()
            srv.api.import_bits("i", "f", *shard_major(rows, n_shards))
            _http(port, "POST", "/index/i/field/f/import", json.dumps(
                {"rowIDs": [0] * extra.size,
                 "columnIDs": extra.tolist()}).encode())
            load_s = time.perf_counter() - t0
            log(f"  import: {load_s:.1f} s")
            rows[0] = np.union1d(rows[0], extra)

            t0 = time.perf_counter()
            packed = [packed_row(c, n_shards) for c in rows]
            exists = packed[0].copy()
            for x in packed[1:]:
                exists |= x
            log(f"  oracle: {time.perf_counter() - t0:.1f} s")
            p = packed

            checks = [
                ("Count(Row(f=0))", _popcount(p[0])),
                ("Count(Row(f=6))", _popcount(p[6])),
                ("Count(Intersect(Row(f=0), Row(f=1)))", _popcount(p[0] & p[1])),
                ("Count(Intersect(Row(f=1), Row(f=2), Row(f=3)))",
                 _popcount(p[1] & p[2] & p[3])),
                ("Count(Intersect(Row(f=0), Row(f=1), Row(f=2), Row(f=3)))",
                 _popcount(p[0] & p[1] & p[2] & p[3])),
                ("Count(Union(Row(f=2), Row(f=5)))", _popcount(p[2] | p[5])),
                ("Count(Xor(Row(f=3), Row(f=4)))", _popcount(p[3] ^ p[4])),
                ("Count(Difference(Row(f=5), Row(f=6)))",
                 _popcount(p[5] & ~p[6])),
                ("Count(Not(Row(f=7)))", _popcount(exists & ~p[7])),
                ("Count(Not(Union(Row(f=0), Row(f=1))))",
                 _popcount(exists & ~(p[0] | p[1]))),
                ("Count(Union(Intersect(Row(f=0), Row(f=1)), "
                 "Xor(Row(f=2), Row(f=3)), Not(Row(f=4))))",
                 _popcount((p[0] & p[1]) | (p[2] ^ p[3]) | (exists & ~p[4]))),
            ]
            # 40 Rows resolve to 40 leaves, each read by the kernel
            wide = [int(r) for r in np.random.default_rng(seed).permutation(
                np.arange(40) % n_rows)]
            rows_pql = ", ".join(f"Row(f={r})" for r in wide)
            xor_all = np.zeros_like(p[0])
            for r in wide:
                xor_all ^= p[r]
            checks += [(f"Count(Union({rows_pql}))", _popcount(exists)),
                       (f"Count(Xor({rows_pql}))", _popcount(xor_all))]
            t0 = time.perf_counter()
            for pql, want in checks:
                got = _http(port, "POST", "/index/i/query",
                            pql.encode())["results"][0]
                if got != want:
                    raise AssertionError(f"{pql}: port {got} != oracle {want}")
                log(f"  {pql[:100]} = {got} (oracle agrees)")
            sub = [s for s in (0, 1) if s < n_shards]
            got = _http(port, "POST", "/index/i/query?shards="
                        + ",".join(map(str, sub)), b"Row(f=2)")
            want_cols = rows[2][rows[2] < (max(sub) + 1) * SHARD_WIDTH]
            if got["results"][0]["columns"] != want_cols.tolist():
                raise AssertionError("Row(f=2) ?shards=0,1 differs from the "
                                     "oracle")
            log(f"  Row(f=2) ?shards={sub}: {want_cols.size} columns "
                "(oracle agrees)")
            single_s = time.perf_counter() - t0

            pair = np.array([[_popcount(p[a] & p[b]) for b in range(n_rows)]
                             for a in range(n_rows)])

            def run_clients(n_per_client: int, salt: int):
                """clients threads x n_per_client Count(Intersect) over
                HTTP -> (latencies, wall seconds); answers checked."""
                lat: list = []
                errors: list = []
                lock = threading.Lock()

                def client(cid: int) -> None:
                    rng = np.random.default_rng(seed + salt + cid)
                    conn = http.client.HTTPConnection("localhost", port,
                                                      timeout=600)
                    try:
                        for _ in range(n_per_client):
                            a, b = (int(x)
                                    for x in rng.integers(n_rows, size=2))
                            q = f"Count(Intersect(Row(f={a}), Row(f={b})))"
                            t = time.perf_counter()
                            got = _http(port, "POST", "/index/i/query",
                                        q.encode(), conn)["results"][0]
                            dt = time.perf_counter() - t
                            with lock:
                                lat.append(dt)
                                if got != int(pair[a, b]):
                                    errors.append((q, got, int(pair[a, b])))
                    finally:
                        conn.close()

                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(clients)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
                if errors or len(lat) != clients * n_per_client:
                    raise AssertionError(
                        f"{len(errors)} concurrent answers differ, "
                        f"{clients * n_per_client - len(lat)} missing; "
                        f"first {errors[:1]}")
                return lat, wall

            # host time of each batch's dispatch (plan, pointer table,
            # launch), timed around the CountBatcher's own method
            count_batcher = srv.executor.batcher
            dispatch, dispatch_s = count_batcher._dispatch, []

            def timed_dispatch(key, payloads):
                t = time.perf_counter()
                try:
                    return dispatch(key, payloads)
                finally:
                    dispatch_s.append(time.perf_counter() - t)

            count_batcher._dispatch = timed_dispatch
            lat, wall = run_clients(per_client, 1000)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()  # the main path ends here
            del count_batcher._dispatch
            batcher = count_batcher.snapshot()
            res = srv.executor.residency.snapshot()
            stats = {
                "queries": len(lat), "qps": len(lat) / wall,
                "p50_ms": statistics.median(lat) * 1e3,
                "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                "max_batch_seen": batcher["max_batch_seen"],
                "batches": batcher["batches"],
                "batched_queries": batcher["batched_queries"],
                "resident_bytes": res["bytes"],
                "resident_entries": res["entries"],
                "import_s": load_s, "single_queries_s": single_s,
                "dispatch_host_ms": (statistics.mean(dispatch_s) * 1e3
                                     if dispatch_s else None),
                "dispatch_host_ms_p50": (statistics.median(dispatch_s) * 1e3
                                         if dispatch_s else None),
            }
            log(f"  concurrent: {clients} clients x {per_client} "
                f"Count(Intersect): {stats['qps']:.1f} q/s, p50 "
                f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, "
                f"max_batch_seen {stats['max_batch_seen']}; dispatch host "
                f"{_us(stats['dispatch_host_ms'])} us a batch (mean)")
            log(f"  resident leaves: {res['entries']} entries, "
                f"{res['bytes']} bytes")
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as torch_profile

                n = max(per_client // 4, 1)
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _, pwall = run_clients(n, 2000)
                    torch.cuda.synchronize()
                busy = device_busy_ms(prof)
                stats["profiled_queries"] = clients * n
                stats["profiled_wall_ms"] = pwall * 1e3
                stats["device_busy_ms"] = busy
                stats["device_idle_share"] = (
                    None if busy is None else 1.0 - busy / (pwall * 1e3))
                log(f"  profiled pass: {clients} clients x {n} queries in "
                    f"{pwall * 1e3:.1f} ms, device busy "
                    + ("not measured (the profiler saw no device events)"
                       if busy is None else
                       f"{busy:.3f} ms, idle share "
                       f"{stats['device_idle_share']:.4f}"))
            log(f"  launches on the Count path: {launches}")
            for name in COUNT_KERNELS:
                if launches[name] < 1:
                    raise AssertionError(
                        f"{name} never launched on the Count path")
            if stats["max_batch_seen"] < 2:
                raise AssertionError("the CountBatcher never coalesced")
            if count_only:
                return {"launches": launches, "stats": stats}
            out = {"launches": launches, "stats": stats}
            if ingest_only:
                s_rows, r_rows, _ = load_hybrid_fields(srv, port, n_shards,
                                                       hybrid[0])
                exists_all = exists.copy()
                for cols in (*s_rows, *r_rows):
                    exists_all |= packed_row(cols, n_shards)
            else:
                log("phase 3: BSI path on the same server")
                out["bsi"], values = bsi_phase(srv, port, p, exists,
                                               n_shards, *bsi)
                log("phase 4: TopN/Rows/GroupBy path on the same server")
                out["topn"] = topn_phase(srv, port, p, values, t_rows,
                                         n_shards, *topn[1:])
                log("phase 5: hybrid sparse/run leaves on the same server")
                out["hybrid"] = hybrid_phase(
                    srv, port, p, exists, values, t_rows,
                    out["topn"]["stats"]["cleared_t0_column"], n_shards,
                    *hybrid)
                exists_all, s_rows, r_rows = out["hybrid"].pop("data")
            log("phase 6: write path (coalesced Set/Clear) on the same "
                "server, under concurrent reads")
            out["ingest"] = ingest_phase(srv, port, p, exists_all, s_rows,
                                         r_rows, n_shards, seed, *ingest)
            return out
        finally:
            srv.close()


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--slab-rows", type=int, default=32)
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--per-client", type=int, default=64)
    ap.add_argument("--bsi-per-shard", type=int, default=32768,
                    help="int values per shard of the BSI phase")
    ap.add_argument("--bsi-clients", type=int, default=32)
    ap.add_argument("--bsi-per-client", type=int, default=16)
    ap.add_argument("--profile", action="store_true",
                    help="after the measured pass, run one more under "
                         "torch.profiler and print the device's idle share")
    ap.add_argument("--count-only", action="store_true",
                    help="drive the Count path alone and print its numbers")
    ap.add_argument("--ingest-only", action="store_true",
                    help="drive the Count path's import and the write path "
                         "alone and print the write path's numbers")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time program_count, intersect_count and "
                         "sparse_intersect_dense alone (no server) and "
                         "print their numbers")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import _build

    device = "cuda"
    t_start = time.perf_counter()
    smi_name = smi("name,power.limit")
    log(f"phase 1: {smi_name}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    _build.load()
    log(f"  kernels built in {_build.build_info['seconds']:.1f} s: "
        f"{_build.build_info['path']}")
    ptxas = ptxas_phase(_build)

    if args.kernel_times:
        measured = kernel_times(device, args.shards, 32768, args.seed,
                                args.runs)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"kernel_times": measured, "ptxas": ptxas}),
              flush=True)
        return 0
    log(f"phase 2: server over {args.shards} shards, Count path")
    served = server_phase(device, args.shards, args.rows, args.seed,
                          args.clients, args.per_client, args.profile,
                          (args.bsi_per_shard, args.seed, args.bsi_clients,
                           args.bsi_per_client),
                          (TOPN_BITS, args.seed, TOPN_CLIENTS,
                           TOPN_PER_CLIENT),
                          (args.seed, HYBRID_CLIENTS, HYBRID_PER_CLIENT),
                          (INGEST_WRITERS, INGEST_ENVELOPES, INGEST_CALLS,
                           INGEST_READERS, INGEST_TURN_ENVELOPES),
                          args.count_only, args.ingest_only)
    st = served["stats"]
    if args.count_only:
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"count_path": st, "launches": served["launches"]}),
              flush=True)
        return 0
    if args.ingest_only:
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"write_path": served["ingest"]["stats"],
                          "launches": served["ingest"]["launches"]}),
              flush=True)
        return 0
    k_served = max(1, round(st["batched_queries"] / max(st["batches"], 1)))
    bst = served["bsi"]["stats"]
    k_sum = max(1, round(bst["batched_queries"] / max(bst["batches"], 1)))

    gc.collect()  # the closed server's resident tensors
    torch.cuda.empty_cache()
    served_k = served["hybrid"]["stats"]["served_k"]
    log(f"phase 7: kernels at S={args.shards}, W=32768 (served mean "
        f"batches: pair stream K={k_served}, BSI sum K={k_sum}; sparse "
        f"rows K={served_k})")
    measured = kernel_phase(device, args.shards, 32768, args.slab_rows,
                            args.k, k_served, args.seed, args.runs)
    measured.update(bsi_kernel_phase(device, args.shards, 32768, k_sum,
                                     args.seed, args.runs))
    measured.update(topn_kernel_phase(device, args.shards, 32768, args.seed,
                                      args.runs))
    measured.update(hybrid_kernel_phase(device, args.shards, 32768, served_k,
                                        args.seed, args.runs))

    records = []
    paths = {"count": served, "bsi": served["bsi"], "topn": served["topn"],
             "hybrid": served["hybrid"], "ingest": served["ingest"]}
    for name, m in measured.items():
        # launches on every path of the main run (each path zeroes the
        # counts before its first query and reads them after its last)
        by_path = {p: paths[p]["launches"][name] for p in paths}
        phase = (served["bsi"] if name in BSI_KERNELS
                 else served["topn"] if name in TOPN_KERNELS
                 else served["hybrid"] if name in HYBRID_KERNELS else served)
        record = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None}
        by_form = {k.split("/", 1)[1]: v
                   for k, v in phase.get("forms", {}).items()
                   if k.startswith(name + "/")}
        if by_form:
            record["launches_by_form"] = by_form
            record["form"] = m["form"]
        records.append(record)
    log("  library_ms: none (no single PyTorch call computes a popcount of "
        "a bitwise op, a bit-sliced comparison, per-plane filtered "
        "popcounts, packed TopN counts or a popcount cross matrix: torch "
        "has no popcount; nor a gather, bit test and ordered compaction)")
    log(f"  details: {json.dumps({'kernels': measured, **served})}")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi_name)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
