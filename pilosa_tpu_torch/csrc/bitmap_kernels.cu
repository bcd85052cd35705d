// Hand-written Hopper (sm_90a) kernels for the dense bitmap read path and
// the bit-sliced integer (BSI) path.
//
// Eight kernels, one device code base. The dense read path:
//
//   pbk_pair_stream_counts  replaces pilosa_tpu/ops/pallas_kernels.py
//       pair_stream_counts (:234, body _pair_stream_kernel :216) and the
//       XLA scan pilosa_tpu/parallel/batcher.py _batched_counts (:436):
//       K queries popcount(op(leaf[ii[k]], leaf[jj[k]])) with
//       op in {and, or, xor, andnot, id}, as int32 partials per
//       2016-shard chunk -> int32[K, C].
//   pbk_program_count       replaces pallas_kernels.py program_count (:108,
//       body _program_count_kernel :80): a whole nested bitmap program
//       (postfix bytecode over a table of leaf pointers) + popcount ->
//       int32[S]. pbk_program_count_table is its form for long programs.
//   pbk_intersect_count     replaces pallas_kernels.py intersect_count (:59,
//       body _and_count_kernel :34): the fixed program ("and", 0, 1).
//
// Bound: all three are popcount streams. Each input word is read once per
// query and reduced to a few int32 counts, so memory bounds them: the
// least time is bytes read / 3.35 TB/s (H100 SXM HBM3). There is no matrix
// product, so no wgmma or TMA.
//
// The pair stream's HBM reads per launch: grid (K, C, split), a block
// streams both operands of its query (one for id), so 2K planes. The
// CountBatcher launches a batch over its distinct canonical pairs only
// (ops/kernels.py plan_pairs: (i, j) and (j, i) are one pair for and, or
// and xor), so K is the number of distinct pairs; blocks of pairs that
// share a leaf run together and mostly meet in L2, so what reaches HBM is
// nearer the distinct leaves' planes. The least time for such a batch is
// the larger of the distinct leaves' bytes over HBM's rate and the
// distinct pairs' words over the __popc rate.
//
// Design (the pair stream and intersect_count):
//   * 16-byte uint4 loads, neighbouring threads on neighbouring addresses;
//   * __popc per 32-bit word, accumulated in a per-thread unsigned int;
//   * warp __shfl_down_sync reduction, then shared memory across warps;
//   * integer atomicAdd of each block's partial into the zeroed output
//     (exact in any order). A loop inside the block replaces the Pallas
//     grid's sequential shard axis; grid dimensions split a query or a
//     shard row across enough blocks to fill the 132 SMs.
//   * intersect_count loads 2 uint4 of each operand per thread per pass.
//
// Design of program_count (an interpreter, so nothing is compiled per
// query). What held the first form to 26-28 % of its bound: its operand
// stack, indexed at run time, lived in local memory (16 slots of 16 bytes
// a thread, far past L1 at full occupancy, so pushes and pops went to L2);
// each leaf load waited on two dependent loads (the instruction, then the
// leaf pointer); one 16-byte load per thread was in flight; and each call
// copied the table from pinned host memory. Now:
//   * the table (leaf pointers, then instructions) is a by-value kernel
//     parameter of 4032 bytes when it fits (every served program does: the
//     widest has 40 leaves and 79 instructions), read as uniform
//     constant-bank loads;
//     a longer one stays a device table that each block stages into
//     shared memory, with the same body;
//   * the stack is instantiated per depth class (the encoder's Strahler
//     depth <= 2, <= 4, <= 16). Its top stays in registers; the slots below
//     it are registers addressed only by unrolled selects on sp for the
//     classes up to 4 (no local memory), and a local array only in the
//     deepest class, which only balanced programs of 16 or more leaves reach;
//   * a leaf followed by a binary op is combined straight into the top, so
//     a chain such as Intersect or Union of many Rows uses no slot;
//   * each thread takes V uint4 per pass (4, 2, 1 by class: the slots cost
//     4 V registers each) and issues a leaf's V loads together.
//
// The BSI path (planes [D, S, W]: plane d holds bit d of every column's
// stored value; exists [S, W] is the not-null row):
//
//   pbk_bsi_compare         replaces pallas_kernels.py bsi_compare (:451,
//       body _bsi_compare_kernel :414): the lt/lte/gt/gte/eq/neq sweep over
//       the planes -> match mask int32[S, W].
//   pbk_bsi_sum_counts      replaces pallas_kernels.py bsi_sum_counts (:504,
//       body _bsi_sum_kernel :485) and the batcher's XLA form
//       pilosa_tpu/parallel/batcher.py _batched_plane_sums (:590): for K
//       filters, popcount(plane_d & filter_k) per plane and shard plus the
//       filter's own count -> int32[K, D+1, S]. pbk_bsi_sum_staged is its
//       second form (below).
//
// Bound: both read every plane word once and do a few integer operations
// on it, so memory bounds them (bytes / 3.35 TB/s): D + 1 planes of
// S x 128 KiB in, plus the 128 KiB-per-shard mask out for the compare.
// The sum over K filters reads D + K planes but does K popcounts per plane
// word, so from K = 6 or so the __popc rate (16 per clock per SM) bounds
// it instead.
//
// Design of the BSI kernels:
//   * bsi_compare: one thread per 16-byte vector keeps `matched` and
//     `remaining` (or `r` for eq/neq) in registers while it walks the
//     planes in the op's order, so each plane word is read once and no
//     intermediate reaches HBM. The predicate is a device int32[D] of
//     bits, read as broadcasts; each bit becomes an all-ones or all-zeros
//     mask (0u - bit). The op is one of six template instantiations picked
//     at run time: nothing is compiled per query.
//   * bsi_sum_counts, two forms:
//     - grid (bsi_sum_kernel, the first design, the K = 1 form): a block
//       takes (filter k, shard s, a slice of 4096 words), keeps its filter
//       words in registers, then loops over the D planes: per plane a
//       warp-shuffle sum into shared memory, and one block-wide pass per
//       32 planes that adds each (k, d, s) partial with one integer
//       atomicAdd into the zeroed output (exact in any order). HBM reads
//       per launch: K x D planes plus the K filters.
//     - staged (bsi_sum_staged_kernel, the K > 1 form): a block of 128
//       threads takes (shard s, a run of 128-vector tiles, a group of up
//       to 32 filters). Per tile each thread stages its vector of every
//       filter of the group in shared memory (64 KiB at 32 filters, so
//       three blocks share an SM), then streams the D planes once, four
//       plane vectors in flight in registers, and counts two planes at a
//       time against every staged filter (one shared load per filter
//       feeds both); a warp reduce-scatter leaves filter k's warp total
//       in one lane, which adds it to a shared (d, k) sum; one integer
//       atomicAdd per (k, d, s) per block at the end. Row D (the filter's
//       own count) is counted once per filter, as a plane of ones. HBM reads
//       per launch: ceil(K / 32) x D planes plus the K filters, each once
//       per 32 planes of depth (one pass at any depth below 32).
//     Planes are reduced in chunks of 32, so the depth is not capped. The
//     Pallas kernel carried these sums across its sequential word-block
//     grid axis in the output tile; on Hopper the atomics replace that.
//
// Two more carry TopN and GroupBy:
//
//   pbk_topn_counts         replaces pallas_kernels.py topn_counts_packed
//       (:364, body _topn_counts_kernel :336; top_rows :388 calls it with a
//       zero src): for R candidate rows (a device table of leaf pointers)
//       and one src plane, |row & src|, |row| and |src| per row, as int32
//       partials per 2016-shard chunk -> int32[C, 3, R].
//   pbk_cross_count         replaces pallas_kernels.py cross_count_matrix
//       (:182, body _cross_count_kernel :158): counts[p, r] =
//       popcount(prefix[p] & axis[r]) over all shards and words, as int32
//       partials per 2016-shard chunk -> int32[C, P, R].
//
// Bounds: topn_counts reads every row and src once and does two __popc
// per row word, so bytes bound it. cross_count does one __popc per
// (prefix, row, word) triple: at the GroupBy shapes (P = 8, R = 64) that is
// 512 popcounts per 72 words read, so the popcount rate (16 per clock per
// SM) bounds it, not HBM.
//
// Design of the TopN and GroupBy kernels:
//   * topn_counts: a block takes (shard s, a slice of 4096 words), keeps
//     that slice of src in registers and its |src| partial in shared
//     memory, then walks the R rows: per row a warp-shuffle sum of both
//     counts into shared memory, and one block-wide pass per 32 rows adds
//     each (row, count) partial, and the block's |src| partial, with one
//     integer atomicAdd into the zeroed output. src is read once per launch
//     and every row once. The Pallas grid re-read src for every 128-row
//     block; here |src| is charged once per (block, row), so each row's
//     total is exactly |src| whatever R is.
//   * cross_count: split-K over the words, like a GEMM of popcounts. A
//     block owns an output tile of 4*PT prefixes x 64 axis rows and a
//     slice of one chunk's words; per step it stages 128 words of each of
//     its prefixes and rows in shared memory (row stride padded by one
//     16-byte vector, so the column reads are free of bank conflicts), and
//     each thread counts its PT prefixes against one row into registers:
//     every operand word is read from HBM once per tile, and its reuse
//     across the tile comes from shared memory. PT in {1, 2, 4} follows P,
//     so P = 8 runs with no padded prefixes. At the end each thread adds
//     its PT partials with integer atomics into the zeroed output.
//
// One more carries the hybrid sparse/run read path:
//
//   pbk_sparse_intersect_dense  replaces pallas_kernels.py
//       sparse_intersect_dense (:295, body _sparse_dense_kernel :282): for
//       a sparse row int32[S, K] (sorted shard-local column ids padded with
//       the sentinel 2^20) and a dense plane [S, W], keep each entry whose
//       bit is set -> sorted sentinel-padded int32[S, K]. With keep_hits 0
//       it keeps the entries whose bit is clear instead (sparse &~ dense).
//
// Bound: bytes. Each index is read and each output slot written once, and
// each entry below the sentinel reads one 4-byte word of the plane, so
// the plane bytes that must move are the distinct 32-byte sectors its
// entries touch; a few integer operations per entry.
//
// Design. The first form (one block of 256 threads per shard, one entry a
// thread per tile, two barriers per 256 entries) was latency-bound: one
// index load, then one dependent gather, in flight per thread, and most of
// each block idle at small K. Now:
//   * a warp owns a chunk of 32 V consecutive entries (V = 8), striped:
//     lane l holds entries 32 j + l of the chunk, so each index load and
//     each plane gather instruction covers 32 consecutive entries
//     (sorted, so near each other in the plane). Each thread issues all V
//     gathers (through the read-only cache: they touch 32-byte sectors at
//     random) before it tests any. A first cut in which a thread owned V
//     consecutive entries (16-byte index loads, one shuffle scan of the
//     per-thread counts) spread every gather instruction over 32 V entries
//     and lost to the first form from K = 1024 on. V = 16 or 64-256
//     threads moved the device time by under 5 % from K = 1024 on and lost
//     10 % at K = 512: the gathers' sectors bound it, not the occupancy;
//   * compaction in order: per stripe j one __ballot_sync gives each kept
//     lane its rank (the popcount of the kept lanes below it), so the kept
//     lanes of a stripe write neighbouring slots; in the block unit the
//     warps' totals pass once per tile through shared memory: one barrier
//     per tile of blockDim.x * V entries (two buffers), a running offset
//     carried from tile to tile, and the next tile's indices load while
//     this tile's gathers are in flight;
//   * the work unit follows K (ops/kernels.py sparse_plan): for K <= 32 V
//     one warp takes a shard and several shards share a block, with no
//     barrier; above, one block per shard, its thread count following K up
//     to 256;
//   * the sentinel tail goes out in 16-byte stores where K % 4 == 0.
// The input rows are sorted and unique, so compaction in order gives
// exactly sort(where(kept, idx, sentinel)): no sort, where the Pallas kernel
// masked and then sorted.
//
// Every C entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
// operand stack slots (ops/kernels.py MAX_STACK); the encoder orders
// operands deepest first, so only a program over 2^16 leaves or more
// needs more
constexpr int kMaxStack = 16;

// pair-stream ops (ops/kernels.py PAIR_OPS order)
constexpr int kOpAnd = 0;
constexpr int kOpOr = 1;
constexpr int kOpXor = 2;
constexpr int kOpAndNot = 3;
constexpr int kOpId = 4;

// program bytecode (ops/kernels.py encode_program)
constexpr unsigned char kLeaf = 0;
constexpr unsigned char kAnd = 1;
constexpr unsigned char kOr = 2;
constexpr unsigned char kXor = 3;
constexpr unsigned char kAndNot = 4;  // a &~ b, b on top of the stack
constexpr unsigned char kNot = 5;
constexpr unsigned char kRAndNot = 6;  // b &~ a, b on top of the stack

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint4 andnot4(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ __forceinline__ uint4 not4(uint4 a) {
  return make_uint4(~a.x, ~a.y, ~a.z, ~a.w);
}
__device__ __forceinline__ uint4 splat(unsigned m) {
  return make_uint4(m, m, m, m);
}
__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Warp reduce-scatter of N per-thread values (N a power of 2, at most 32):
// returns in lane l the warp's total of value l >> (5 - log2 N), so each
// value's total sits in 32 / N neighbouring lanes. N - 1 + 5 - log2 N
// shuffles, against 5 N for N separate warp sums. Every loop has a
// constant trip count, so v stays in registers. v is clobbered.
template <int N>
__device__ __forceinline__ unsigned warp_reduce_scatter(unsigned (&v)[N]) {
  constexpr int kSteps = N >= 32 ? 5 : N >= 16 ? 4 : N >= 8 ? 3 : N >= 4 ? 2
                         : N >= 2 ? 1 : 0;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    // the lane with bit (16 >> s) set keeps the upper half of the values
    // still held, its partner the lower; each sends the half it gives up
    const int half = N >> (s + 1);
    const int mask = 16 >> s;
    const bool upper = lane & mask;
#pragma unroll
    for (int i = 0; i < (N > 1 ? N / 2 : 1); ++i) {
      if (i < half) {
        const unsigned send = upper ? v[i] : v[i + half];
        const unsigned keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
    }
  }
  unsigned r = v[0];
#pragma unroll
  for (int s = kSteps; s < 5; ++s) {
    r += __shfl_xor_sync(0xffffffffu, r, 16 >> s);
  }
  return r;
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ unsigned block_sum(unsigned v) {
  __shared__ unsigned warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// ------------------------------------------------------ program_count

// The program's table: leaf pointers (n_leaves), then instructions
// (n_instr), as int64; an instruction is opcode | leaf << 8. The wrapper
// passes it by value in ProgramParam when n_leaves + n_instr <= kParamMeta
// (4032 bytes, so that with the other arguments the kernel's parameters
// stay within the classic 4 KB), else as a device table that each block
// stages into shared memory (or reads from global memory past kStagedMeta
// entries).
constexpr int kParamMeta = 504;
constexpr int kStagedMeta = 48 * 1024 / 8;
struct ProgramParam {
  long long meta[kParamMeta];
};
static_assert(sizeof(ProgramParam) == 4032, "within 4 KB of kernel parameters");

// the table read from the kernel's parameter bank: every thread reads the
// same entry, so each read is one uniform constant-bank load
struct ParamProgram {
  const ProgramParam& p;
  int n_leaves;
  __device__ __forceinline__ const uint4* leaf(long long i) const {
    return reinterpret_cast<const uint4*>(p.meta[i]);
  }
  __device__ __forceinline__ long long ins(int pc) const {
    return p.meta[n_leaves + pc];
  }
};

// the table read from shared memory (or global memory when too long)
struct TableProgram {
  const long long* meta;
  int n_leaves;
  __device__ __forceinline__ const uint4* leaf(long long i) const {
    return reinterpret_cast<const uint4*>(meta[i]);
  }
  __device__ __forceinline__ long long ins(int pc) const {
    return meta[n_leaves + pc];
  }
};

// The operands below the top of the stack, kSlots of them, each V uint4.
// Registers: push and pop address the slots only with compile-time
// indices (an unrolled select on sp), so nothing reaches local memory.
template <int kSlots, int V, bool kLocal>
struct OperandStack {
  uint4 s[kSlots][V];
  __device__ __forceinline__ void push(int sp, const uint4 (&x)[V]) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i == sp) {
#pragma unroll
        for (int j = 0; j < V; ++j) s[i][j] = x[j];
      }
    }
  }
  __device__ __forceinline__ void pop(int sp, uint4 (&x)[V]) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i == sp) {
#pragma unroll
        for (int j = 0; j < V; ++j) x[j] = s[i][j];
      }
    }
  }
};

// The deepest class: indexed at run time, so in local memory.
template <int kSlots, int V>
struct OperandStack<kSlots, V, true> {
  uint4 s[kSlots][V];
  __device__ __forceinline__ void push(int sp, const uint4 (&x)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) s[sp][j] = x[j];
  }
  __device__ __forceinline__ void pop(int sp, uint4 (&x)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = s[sp][j];
  }
};

__device__ __forceinline__ bool is_binary(int c) {
  return c != kLeaf && c != kNot;
}

// r = a op b for the stack [.., a, b]; r may be a or b
template <int V>
__device__ __forceinline__ void apply(int c, const uint4 (&a)[V],
                                      const uint4 (&b)[V], uint4 (&r)[V]) {
  switch (c) {
    case kAnd:
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = and4(a[j], b[j]);
      break;
    case kOr:
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = or4(a[j], b[j]);
      break;
    case kXor:
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = xor4(a[j], b[j]);
      break;
    case kAndNot:
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = andnot4(a[j], b[j]);
      break;
    default:  // kRAndNot
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = andnot4(b[j], a[j]);
      break;
  }
}

// Popcount of the program's result over elements [lo, hi) of one shard
// row (base = the row's first element), V uint4 per thread per pass:
// element i0 + j * kThreads for j < V. For each leaf instruction all V
// loads go out together. The top of the stack stays in registers apart
// from the kDepth - 1 slots below it, and a leaf followed by a binary op
// is combined straight into the top, so a chain (Intersect or Union of
// many Rows) never touches the slots.
template <int kDepth, int V, class Program>
__device__ __forceinline__ unsigned count_program(const Program& prog,
                                                  int n_instr, long long base,
                                                  long long lo, long long hi) {
  constexpr int kSlots = kDepth - 1;
  unsigned acc = 0;
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += kThreads * V) {
    OperandStack<kSlots, V, (kDepth > 4)> stack;
    uint4 top[V];
    int sp = 0;
    for (int pc = 0; pc < n_instr; ++pc) {
      const long long ins = prog.ins(pc);
      const int c = static_cast<int>(ins & 0xff);
      if (c == kLeaf) {
        const uint4* leaf = prog.leaf(ins >> 8) + base;
        uint4 x[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const long long i = i0 + j * kThreads;
          x[j] = i < hi ? __ldg(leaf + i) : splat(0u);
        }
        const int next =
            pc + 1 < n_instr ? static_cast<int>(prog.ins(pc + 1) & 0xff) : kLeaf;
        if (pc > 0 && is_binary(next)) {
          apply<V>(next, top, x, top);
          ++pc;
        } else {
          if (pc > 0) stack.push(sp++, top);
#pragma unroll
          for (int j = 0; j < V; ++j) top[j] = x[j];
        }
      } else if (c == kNot) {
#pragma unroll
        for (int j = 0; j < V; ++j) top[j] = not4(top[j]);
      } else {
        uint4 a[V];
        stack.pop(--sp, a);
        apply<V>(c, a, top, top);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (i0 + j * kThreads < hi) acc += popc4(top[j]);
    }
  }
  return acc;
}

// uint4 per thread per pass, by depth class: the slots cost 4 V registers
// each, so the deeper classes take fewer
template <int kDepth>
struct ProgramVec {
  static constexpr int value = kDepth <= 2 ? 4 : kDepth <= 4 ? 2 : 1;
};

// The block's share of shard blockIdx.x: grid (S, split).
__device__ __forceinline__ void block_range(long long w4, int split,
                                            long long& lo, long long& hi) {
  const long long per = (w4 + split - 1) / split;
  lo = per * blockIdx.y;
  hi = lo + per < w4 ? lo + per : w4;
}

// program_count with the table in the parameter bank
template <int kDepth>
__global__ void __launch_bounds__(kThreads)
    program_count_kernel(const __grid_constant__ ProgramParam prog,
                         int n_leaves, int n_instr, int* __restrict__ out,
                         long long w4, int split) {
  long long lo, hi;
  block_range(w4, split, lo, hi);
  const long long shard = blockIdx.x;
  const ParamProgram p{prog, n_leaves};
  const unsigned total = block_sum(count_program<kDepth, ProgramVec<kDepth>::value>(
      p, n_instr, shard * w4, lo, hi));
  if (threadIdx.x == 0 && total) atomicAdd(out + shard, static_cast<int>(total));
}

// program_count with the table in device memory, staged into shared
// memory when it fits kStagedMeta entries (stage = 1)
template <int kDepth>
__global__ void __launch_bounds__(kThreads)
    program_count_table_kernel(const long long* __restrict__ meta,
                               int n_leaves, int n_instr, int stage,
                               int* __restrict__ out, long long w4,
                               int split) {
  extern __shared__ long long staged[];
  const long long* table = meta;
  if (stage) {
    for (int i = threadIdx.x; i < n_leaves + n_instr; i += kThreads) {
      staged[i] = __ldg(meta + i);
    }
    __syncthreads();
    table = staged;
  }
  long long lo, hi;
  block_range(w4, split, lo, hi);
  const long long shard = blockIdx.x;
  const TableProgram p{table, n_leaves};
  const unsigned total = block_sum(count_program<kDepth, ProgramVec<kDepth>::value>(
      p, n_instr, shard * w4, lo, hi));
  if (threadIdx.x == 0 && total) atomicAdd(out + shard, static_cast<int>(total));
}

// intersect_count: the fixed program ("and", 0, 1), both operands' V
// vectors loaded together
constexpr int kIntersectVec = 2;
__global__ void __launch_bounds__(kThreads)
    intersect_count_kernel(const uint4* __restrict__ a,
                           const uint4* __restrict__ b, int* __restrict__ out,
                           long long w4, int split) {
  long long lo, hi;
  block_range(w4, split, lo, hi);
  const long long shard = blockIdx.x;
  const long long base = shard * w4;
  unsigned acc = 0;
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += kThreads * kIntersectVec) {
    uint4 x[kIntersectVec], y[kIntersectVec];
#pragma unroll
    for (int j = 0; j < kIntersectVec; ++j) {
      const long long i = i0 + j * kThreads;
      x[j] = i < hi ? __ldg(a + base + i) : splat(0u);
      y[j] = i < hi ? __ldg(b + base + i) : splat(0u);
    }
#pragma unroll
    for (int j = 0; j < kIntersectVec; ++j) acc += popc4(and4(x[j], y[j]));
  }
  const unsigned total = block_sum(acc);
  if (threadIdx.x == 0 && total) atomicAdd(out + shard, static_cast<int>(total));
}

// grid (K, C, split): block (q, c, part) counts part of chunk c of query q.
// meta = [leaf pointers (n_leaves) | ii (k) | jj (k)] as int64 on device:
// the batcher's leaves are distinct resident tensors, never restacked.
template <int kOp>
__global__ void __launch_bounds__(kThreads)
    pair_stream_kernel(const long long* __restrict__ meta, int n_leaves,
                       int k, int* __restrict__ out, long long n_shards,
                       long long w4, long long chunk_shards, int n_chunks,
                       int split) {
  const int q = blockIdx.x;
  const int c = blockIdx.y;
  const long long s0 = chunk_shards * c;
  const long long s1 =
      s0 + chunk_shards < n_shards ? s0 + chunk_shards : n_shards;
  const long long n = (s1 - s0) * w4;
  const long long per = (n + split - 1) / split;
  const long long lo = per * blockIdx.z;
  const long long hi = lo + per < n ? lo + per : n;
  const long long ia = meta[n_leaves + q];
  const long long ib = meta[n_leaves + k + q];
  const uint4* a = reinterpret_cast<const uint4*>(meta[ia]) + s0 * w4;
  const uint4* b = reinterpret_cast<const uint4*>(meta[ib]) + s0 * w4;
  unsigned acc = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    uint4 x = __ldg(a + i);
    if (kOp != kOpId) {
      const uint4 y = __ldg(b + i);
      x = kOp == kOpAnd   ? and4(x, y)
          : kOp == kOpOr  ? or4(x, y)
          : kOp == kOpXor ? xor4(x, y)
                          : andnot4(x, y);
    }
    acc += popc4(x);
  }
  const unsigned total = block_sum(acc);
  if (threadIdx.x == 0 && total) {
    atomicAdd(out + static_cast<long long>(q) * n_chunks + c,
              static_cast<int>(total));
  }
}

// ------------------------------------------------------------------ BSI

// comparison ops (ops/kernels.py BSI_OPS order)
constexpr int kLt = 0;
constexpr int kLte = 1;
constexpr int kGt = 2;
constexpr int kGte = 3;
constexpr int kEq = 4;
constexpr int kNeq = 5;

// all-ones when predicate bit i is 1, all-zeros when it is 0
__device__ __forceinline__ uint4 pred_mask(const int* __restrict__ pred,
                                           int i) {
  return splat(0u - (static_cast<unsigned>(__ldg(pred + i)) & 1u));
}

// grid-stride over the n 16-byte vectors of one [S, W] plane; plane d
// starts at planes + d * n
template <int kCmp>
__global__ void __launch_bounds__(kThreads)
    bsi_compare_kernel(const uint4* __restrict__ planes,
                       const uint4* __restrict__ exists,
                       const int* __restrict__ pred, int depth,
                       uint4* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < n; idx += stride) {
    const uint4 ex = __ldg(exists + idx);
    uint4 r;
    if (kCmp == kEq || kCmp == kNeq) {
      r = ex;
#pragma unroll 4
      for (int i = 0; i < depth; ++i) {
        // keep the columns whose plane bit equals the predicate bit
        const uint4 p = __ldg(planes + i * n + idx);
        r = and4(r, not4(xor4(p, pred_mask(pred, i))));
      }
      if (kCmp == kNeq) r = andnot4(ex, r);
    } else {
      uint4 matched = splat(0u);
      uint4 remaining = ex;  // columns equal to the predicate so far
#pragma unroll 4
      for (int i = depth - 1; i >= 0; --i) {
        const uint4 m = pred_mask(pred, i);
        const uint4 p = __ldg(planes + i * n + idx);
        if (kCmp == kLt || kCmp == kLte) {
          // predicate bit 1: a 0 here is strictly less
          matched = or4(matched, and4(andnot4(remaining, p), m));
        } else {
          // predicate bit 0: a 1 here is strictly greater
          matched = or4(matched, andnot4(and4(remaining, p), m));
        }
        remaining = and4(remaining, not4(xor4(p, m)));
      }
      if (kCmp == kLte || kCmp == kGte) matched = or4(matched, remaining);
      r = matched;
    }
    out[idx] = r;
  }
}

// filter vectors a thread keeps in registers, and planes per shared pass
constexpr int kSumVec = 4;
constexpr int kSumChunk = 32;
constexpr int kSumSpan = kThreads * kSumVec;  // 16-byte vectors per block

// grid (S * parts, K): block (s * parts + part, k) counts vectors
// [part * kSumSpan, (part + 1) * kSumSpan) of shard s against filter k.
// filters = K filter pointers as int64 on the device.
__global__ void __launch_bounds__(kThreads)
    bsi_sum_kernel(const uint4* __restrict__ planes,
                   const long long* __restrict__ filters, int depth,
                   int* __restrict__ out, long long n_shards, long long w4,
                   int parts) {
  __shared__ unsigned sums[kSumChunk][kThreads / 32];
  const long long shard = blockIdx.x / parts;
  const long long lo = static_cast<long long>(blockIdx.x % parts) * kSumSpan;
  const int k = blockIdx.y;
  const uint4* filt =
      reinterpret_cast<const uint4*>(__ldg(filters + k)) + shard * w4;
  uint4 f[kSumVec];
#pragma unroll
  for (int v = 0; v < kSumVec; ++v) {
    const long long i = lo + v * kThreads + threadIdx.x;
    f[v] = i < w4 ? __ldg(filt + i) : splat(0u);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long plane_stride = n_shards * w4;
  int* out_k = out + static_cast<long long>(k) * (depth + 1) * n_shards;
  for (int d0 = 0; d0 <= depth; d0 += kSumChunk) {
    const int d1 = d0 + kSumChunk < depth + 1 ? d0 + kSumChunk : depth + 1;
    for (int d = d0; d < d1; ++d) {
      unsigned acc = 0;
      if (d == depth) {  // the filter's own count
#pragma unroll
        for (int v = 0; v < kSumVec; ++v) acc += popc4(f[v]);
      } else {
        const uint4* p = planes + d * plane_stride + shard * w4;
#pragma unroll
        for (int v = 0; v < kSumVec; ++v) {
          const long long i = lo + v * kThreads + threadIdx.x;
          if (i < w4) acc += popc4(and4(__ldg(p + i), f[v]));
        }
      }
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (lane == 0) sums[d - d0][warp] = acc;
    }
    __syncthreads();
    if (threadIdx.x < d1 - d0) {
      unsigned t = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) t += sums[threadIdx.x][w];
      if (t) {
        atomicAdd(out_k + (d0 + threadIdx.x) * n_shards + shard,
                  static_cast<int>(t));
      }
    }
    __syncthreads();  // sums is rewritten by the next chunk
  }
}

constexpr int kSumFilters = 32;  // filters per staged group (K_tile)
constexpr int kSumStagedThreads = 128;  // = vectors per filter per tile
constexpr int kSumPlanesInFlight = 4;

// grid (S * parts, groups): block (s * parts + part, g) counts its run of
// 128-vector tiles of shard s against filters [g * KT, g * KT + KT) (the
// last group may hold fewer). filters = K filter pointers as int64 on the
// device; out = int32[K, D+1, S], zeroed. Dynamic shared memory: KT x
// kSumStagedThreads vectors (64 KiB at KT = 32, so three blocks share an
// SM and one block's loads overlap another's counting); thread t's vector
// of filter k at [k][t]. Row D, the filter's own count, is counted as a
// plane of all ones.
template <int KT>
__global__ void __launch_bounds__(kSumStagedThreads)
    bsi_sum_staged_kernel(const uint4* __restrict__ planes,
                          const long long* __restrict__ filters,
                          int n_filters, int depth, int* __restrict__ out,
                          long long n_shards, long long w4, int parts) {
  extern __shared__ uint4 fstage[];
  __shared__ unsigned sums[kSumChunk][KT];
  __shared__ const uint4* fptr[KT];
  const long long shard = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int k0 = blockIdx.y * KT;
  const int nk = n_filters - k0 < KT ? n_filters - k0 : KT;
  const long long tiles =
      (w4 + kSumStagedThreads - 1) / kSumStagedThreads;
  const long long per = (tiles + parts - 1) / parts;
  const long long t0 = per * part;
  const long long t1 = t0 + per < tiles ? t0 + per : tiles;
  if (threadIdx.x < KT) {
    fptr[threadIdx.x] =
        threadIdx.x < nk
            ? reinterpret_cast<const uint4*>(__ldg(filters + k0 + threadIdx.x)) +
                  shard * w4
            : nullptr;
  }
  const int lane = threadIdx.x & 31;
  constexpr int kLanesPerFilter = 32 / KT;
  const long long plane_stride = n_shards * w4;
  const uint4* pbase = planes + shard * w4;
  // filter k's vector at mine[k * kSumStagedThreads]
  uint4* mine = fstage + threadIdx.x;
  for (int d0 = 0; d0 <= depth; d0 += kSumChunk) {
    const int d1 = d0 + kSumChunk < depth + 1 ? d0 + kSumChunk : depth + 1;
    for (int e = threadIdx.x; e < kSumChunk * KT; e += kSumStagedThreads) {
      sums[e / KT][e % KT] = 0;
    }
    __syncthreads();  // also publishes fptr
    for (long long t = t0; t < t1; ++t) {
      const long long i = t * kSumStagedThreads + threadIdx.x;
      const bool live = i < w4;
      // each thread reads back only its own vectors: no barrier needed
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        mine[k * kSumStagedThreads] =
            live && k < nk ? __ldg(fptr[k] + i) : splat(0u);
      }
      for (int d = d0; d < d1; d += kSumPlanesInFlight) {
        uint4 p[kSumPlanesInFlight];
#pragma unroll
        for (int j = 0; j < kSumPlanesInFlight; ++j) {
          const int dd = d + j;
          p[j] = dd == depth ? splat(~0u)  // the filter's own count
                 : live && dd < d1 ? __ldg(pbase + dd * plane_stride + i)
                                   : splat(0u);
        }
        // two planes per pass over the staged filters: one shared load
        // of a filter vector feeds both
#pragma unroll
        for (int j = 0; j < kSumPlanesInFlight; j += 2) {
          if (d + j >= d1) break;  // uniform across the block
          unsigned acc0[KT], acc1[KT];
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const uint4 f = mine[k * kSumStagedThreads];
            acc0[k] = popc4(and4(p[j], f));
            acc1[k] = popc4(and4(p[j + 1], f));
          }
          const unsigned v0 = warp_reduce_scatter<KT>(acc0);
          const unsigned v1 = warp_reduce_scatter<KT>(acc1);
          if ((lane & (kLanesPerFilter - 1)) == 0) {
            const int k = lane / kLanesPerFilter;
            if (v0) atomicAdd(&sums[d + j - d0][k], v0);
            if (v1 && d + j + 1 < d1) atomicAdd(&sums[d + j + 1 - d0][k], v1);
          }
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (d1 - d0) * KT; e += kSumStagedThreads) {
      const int dd = e / KT, k = e % KT;
      const unsigned t = sums[dd][k];
      if (k < nk && t) {
        atomicAdd(out + (static_cast<long long>(k0 + k) * (depth + 1) + d0 +
                         dd) * n_shards + shard,
                  static_cast<int>(t));
      }
    }
    __syncthreads();  // sums is rewritten by the next chunk
  }
}

// ----------------------------------------------------------------- TopN

constexpr int kTopnVec = 4;                     // src vectors per thread
constexpr int kTopnSpan = kThreads * kTopnVec;  // 16-byte vectors per block
constexpr int kTopnRows = 32;                   // rows per shared pass

// grid (S * parts): block (s * parts + part) counts vectors
// [part * kTopnSpan, (part + 1) * kTopnSpan) of shard s. rows = R leaf
// pointers as int64 on the device; out = int32[C, 3, R], zeroed.
__global__ void __launch_bounds__(kThreads)
    topn_counts_kernel(const long long* __restrict__ rows, int n_rows,
                       const uint4* __restrict__ src, int* __restrict__ out,
                       long long w4, int parts, long long chunk_shards) {
  __shared__ unsigned sums[2][kTopnRows][kThreads / 32];
  __shared__ unsigned src_total;
  const long long shard = blockIdx.x / parts;
  const long long lo = static_cast<long long>(blockIdx.x % parts) * kTopnSpan;
  const long long base = shard * w4;
  uint4 s[kTopnVec];
  unsigned scount = 0;
#pragma unroll
  for (int v = 0; v < kTopnVec; ++v) {
    const long long i = lo + v * kThreads + threadIdx.x;
    s[v] = i < w4 ? __ldg(src + base + i) : splat(0u);
    scount += popc4(s[v]);
  }
  scount = block_sum(scount);
  if (threadIdx.x == 0) src_total = scount;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* out_c = out + (shard / chunk_shards) * 3LL * n_rows;
  for (int r0 = 0; r0 < n_rows; r0 += kTopnRows) {
    const int r1 = r0 + kTopnRows < n_rows ? r0 + kTopnRows : n_rows;
    for (int r = r0; r < r1; ++r) {
      const uint4* row =
          reinterpret_cast<const uint4*>(__ldg(rows + r)) + base;
      unsigned inter = 0, cnt = 0;
#pragma unroll
      for (int v = 0; v < kTopnVec; ++v) {
        const long long i = lo + v * kThreads + threadIdx.x;
        if (i < w4) {
          const uint4 x = __ldg(row + i);
          inter += popc4(and4(x, s[v]));
          cnt += popc4(x);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        inter += __shfl_down_sync(0xffffffffu, inter, o);
        cnt += __shfl_down_sync(0xffffffffu, cnt, o);
      }
      if (lane == 0) {
        sums[0][r - r0][warp] = inter;
        sums[1][r - r0][warp] = cnt;
      }
    }
    __syncthreads();  // also publishes src_total on the first pass
    if (threadIdx.x < r1 - r0) {
      unsigned inter = 0, cnt = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        inter += sums[0][threadIdx.x][w];
        cnt += sums[1][threadIdx.x][w];
      }
      const int r = r0 + threadIdx.x;
      if (inter) atomicAdd(out_c + r, static_cast<int>(inter));
      if (cnt) atomicAdd(out_c + n_rows + r, static_cast<int>(cnt));
      if (src_total) {
        atomicAdd(out_c + 2 * n_rows + r, static_cast<int>(src_total));
      }
    }
    __syncthreads();  // sums is rewritten by the next pass
  }
}

// -------------------------------------------------------------- GroupBy

constexpr int kCcRows = 64;  // axis rows per block tile, one per thread
constexpr int kCcVec = 32;   // 16-byte vectors per operand row and step

// grid (C * split, P tiles, R tiles): block (c * split + part, pt, rt)
// counts its share of chunk c's words for prefixes [pt * 4PT, +4PT) x
// axis rows [rt * 64, +64). Thread (ty, tx) = (tid / 64, tid % 64) owns
// prefixes ty * PT .. ty * PT + PT - 1 of the tile against row tx.
// prefix = [P, S, w4] and axis = [R, S, w4] contiguous; out = int32[C, P,
// R], zeroed.
template <int PT>
__global__ void __launch_bounds__(kThreads)
    cross_count_kernel(const uint4* __restrict__ prefix,
                       const uint4* __restrict__ axis, int n_prefix,
                       int n_axis, int* __restrict__ out, long long n_shards,
                       long long w4, long long chunk_shards, int split) {
  constexpr int kTileP = 4 * PT;
  __shared__ uint4 ps[kTileP][kCcVec];
  __shared__ uint4 rs[kCcRows][kCcVec + 1];
  const int c = blockIdx.x / split;
  const int part = blockIdx.x % split;
  const int p0 = blockIdx.y * kTileP;
  const int r0 = blockIdx.z * kCcRows;
  const long long plane = n_shards * w4;
  const long long s0 = chunk_shards * c;
  const long long s1 = s0 + chunk_shards < n_shards ? s0 + chunk_shards
                                                    : n_shards;
  const long long off = s0 * w4;
  const long long n = (s1 - s0) * w4;
  const long long steps = (n + kCcVec - 1) / kCcVec;
  const long long per = (steps + split - 1) / split;
  const long long t0 = per * part;
  const long long t1 = t0 + per < steps ? t0 + per : steps;
  const int ty = threadIdx.x / kCcRows;
  const int tx = threadIdx.x % kCcRows;
  const bool live = p0 + ty * PT < n_prefix && r0 + tx < n_axis;
  unsigned acc[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) acc[i] = 0;
  for (long long t = t0; t < t1; ++t) {
    const long long k0 = t * kCcVec;
    for (int e = threadIdx.x; e < kTileP * kCcVec; e += kThreads) {
      const int p = e / kCcVec, k = e % kCcVec;
      ps[p][k] = p0 + p < n_prefix && k0 + k < n
                     ? __ldg(prefix + (p0 + p) * plane + off + k0 + k)
                     : splat(0u);
    }
    for (int e = threadIdx.x; e < kCcRows * kCcVec; e += kThreads) {
      const int r = e / kCcVec, k = e % kCcVec;
      rs[r][k] = r0 + r < n_axis && k0 + k < n
                     ? __ldg(axis + (r0 + r) * plane + off + k0 + k)
                     : splat(0u);
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int k = 0; k < kCcVec; ++k) {
        const uint4 b = rs[tx][k];
#pragma unroll
        for (int i = 0; i < PT; ++i) acc[i] += popc4(and4(ps[ty * PT + i][k], b));
      }
    }
    __syncthreads();  // the tiles are rewritten by the next step
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int p = p0 + ty * PT + i;
    if (p < n_prefix && acc[i]) {
      atomicAdd(out + (static_cast<long long>(c) * n_prefix + p) * n_axis +
                    r0 + tx,
                static_cast<int>(acc[i]));
    }
  }
}

// ------------------------------------------------------- sparse ∩ dense

constexpr int kSentinel = 1 << 20;  // ops/hybrid.py SPARSE_SENTINEL
constexpr int kSparseMaxWarps = kThreads / 32;
constexpr int kSparseVec = 8;  // entries per thread

// A warp's chunk of 32 V consecutive entries from entry c0 on, striped:
// lane l holds entries c0 + 32 j + l (the sentinel past k), so each load,
// and each gather below, covers 32 consecutive entries of the row.
template <int V>
__device__ __forceinline__ void load_chunk(const int* __restrict__ row,
                                           int c0, int k, int lane,
                                           int (&idx)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int e = c0 + 32 * j + lane;
    idx[j] = e < k ? __ldcs(row + e) : kSentinel;
  }
}

// ballot[j]: the lanes whose entry j is kept. All V plane words are
// loaded before any is tested, so V gathers are in flight per thread.
// Returns the chunk's kept count.
template <bool kKeepHits, int V>
__device__ __forceinline__ int keep_ballots(const unsigned* __restrict__ plane,
                                            const int (&idx)[V],
                                            unsigned (&ballot)[V]) {
  unsigned word[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    word[j] = static_cast<unsigned>(idx[j]) < static_cast<unsigned>(kSentinel)
                  ? __ldg(plane + (idx[j] >> 5))
                  : 0u;
  }
  int total = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool live =
        static_cast<unsigned>(idx[j]) < static_cast<unsigned>(kSentinel);
    const bool bit = (word[j] >> (idx[j] & 31)) & 1u;
    ballot[j] = __ballot_sync(0xffffffffu, live && (kKeepHits ? bit : !bit));
    total += __popc(ballot[j]);
  }
  return total;
}

// The chunk's kept entries, in order, from dst[pos] on: per stripe j the
// kept lanes write neighbouring slots.
template <int V>
__device__ __forceinline__ void write_kept(int* __restrict__ dst, int pos,
                                           const unsigned (&ballot)[V],
                                           const int (&idx)[V], int lane) {
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if ((ballot[j] >> lane) & 1u) dst[pos + __popc(ballot[j] & below)] = idx[j];
    pos += __popc(ballot[j]);
  }
}

// dst[filled, k) = sentinel, thread t of nt; 16-byte stores from the
// first multiple of 4 on when kVec4.
template <bool kVec4>
__device__ __forceinline__ void fill_tail(int* __restrict__ dst, int filled,
                                          int k, int t, int nt) {
  if (kVec4) {
    const int head = ((filled + 3) & ~3) < k ? ((filled + 3) & ~3) : k;
    for (int i = filled + t; i < head; i += nt) dst[i] = kSentinel;
    const int4 s4 = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
    for (int i = head + 4 * t; i < k; i += 4 * nt) {
      *reinterpret_cast<int4*>(dst + i) = s4;
    }
  } else {
    for (int i = filled + t; i < k; i += nt) dst[i] = kSentinel;
  }
}

// Compaction of row s of sp [S, k] against plane s of dense [S, 32768]
// into out [S, k]; kKeepHits keeps the entries whose bit is set, else
// those whose bit is clear; sentinel entries are never kept. Warp w of a
// tile owns its chunk of 32 V consecutive entries (load_chunk).
//   kWarpUnit: k <= 32 V; warp w of block b takes shard b * warps + w, in
//     one chunk, with no barrier.
//   else: block b takes shard b in tiles of blockDim.x * V entries; the
//     warp totals pass through shared memory (two buffers, so one barrier
//     per tile), a running offset carries from tile to tile, and the next
//     tile's indices load while this tile's gathers are in flight.
// kVec4 (k % 4 == 0, out 16-byte aligned): the sentinel tail in 16-byte
// stores.
template <bool kKeepHits, int V, bool kWarpUnit, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    sparse_dense_kernel(const int* __restrict__ sp,
                        const unsigned* __restrict__ dense,
                        int* __restrict__ out, long long n_shards, int k,
                        long long w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long shard =
      kWarpUnit ? static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp
                : static_cast<long long>(blockIdx.x);
  if (shard >= n_shards) return;  // whole warps: the warp unit's last block
  const int* row = sp + shard * k;
  const unsigned* plane = dense + shard * w;
  int* dst = out + shard * k;
  int idx[V];
  unsigned ballot[V];
  if (kWarpUnit) {
    load_chunk<V>(row, 0, k, lane, idx);
    const int total = keep_ballots<kKeepHits, V>(plane, idx, ballot);
    write_kept<V>(dst, 0, ballot, idx, lane);
    fill_tail<kVec4>(dst, total, k, lane, 32);
    return;
  }
  __shared__ int warp_totals[2][kSparseMaxWarps];
  const int n_warps = blockDim.x >> 5;
  const int tile = blockDim.x * V;
  const int chunk = warp * 32 * V;
  int filled = 0;
  int parity = 0;
  load_chunk<V>(row, chunk, k, lane, idx);
  for (int base = 0; base < k; base += tile) {
    const int total = keep_ballots<kKeepHits, V>(plane, idx, ballot);
    int next[V];
    load_chunk<V>(row, base + tile + chunk, k, lane, next);
    if (lane == 0) warp_totals[parity][warp] = total;
    __syncthreads();
    int offset = filled, tile_total = 0;
#pragma unroll
    for (int v = 0; v < kSparseMaxWarps; ++v) {
      const int c = v < n_warps ? warp_totals[parity][v] : 0;
      offset += v < warp ? c : 0;
      tile_total += c;
    }
    write_kept<V>(dst, offset, ballot, idx, lane);
    filled += tile_total;
    parity ^= 1;
#pragma unroll
    for (int j = 0; j < V; ++j) idx[j] = next[j];
  }
  fill_tail<kVec4>(dst, filled, k, threadIdx.x, blockDim.x);
}

template <bool kKeepHits, int V, bool kWarpUnit>
cudaError_t launch_sparse_dense(unsigned grid, int threads, cudaStream_t st,
                                const int* sp, const unsigned* dense, int* out,
                                long long n_shards, int k, long long w,
                                bool vec4) {
  if (vec4) {
    sparse_dense_kernel<kKeepHits, V, kWarpUnit, true>
        <<<grid, threads, 0, st>>>(sp, dense, out, n_shards, k, w);
  } else {
    sparse_dense_kernel<kKeepHits, V, kWarpUnit, false>
        <<<grid, threads, 0, st>>>(sp, dense, out, n_shards, k, w);
  }
  return cudaGetLastError();
}

// Launcher of the staged sum: its dynamic shared memory above 48 KB
// must be allowed before its first launch.
template <int KT>
cudaError_t launch_sum_staged(dim3 grid, cudaStream_t st,
                              const uint4* planes, const long long* filters,
                              int k, int depth, int* out, long long n_shards,
                              long long w4, int parts) {
  const size_t smem =
      static_cast<size_t>(KT) * kSumStagedThreads * sizeof(uint4);
  static const cudaError_t e = cudaFuncSetAttribute(
      bsi_sum_staged_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  bsi_sum_staged_kernel<KT><<<grid, kSumStagedThreads, smem, st>>>(
      planes, filters, k, depth, out, n_shards, w4, parts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pbk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pbk_pair_stream_counts(const long long* meta, int n_leaves, int k, int op,
                           int* out, long long n_shards, long long w4,
                           long long chunk_shards, int n_chunks, int split,
                           void* stream) {
  const dim3 grid(k, n_chunks, split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kOpAnd:
      pair_stream_kernel<kOpAnd><<<grid, kThreads, 0, st>>>(
          meta, n_leaves, k, out, n_shards, w4, chunk_shards, n_chunks, split);
      break;
    case kOpOr:
      pair_stream_kernel<kOpOr><<<grid, kThreads, 0, st>>>(
          meta, n_leaves, k, out, n_shards, w4, chunk_shards, n_chunks, split);
      break;
    case kOpXor:
      pair_stream_kernel<kOpXor><<<grid, kThreads, 0, st>>>(
          meta, n_leaves, k, out, n_shards, w4, chunk_shards, n_chunks, split);
      break;
    case kOpAndNot:
      pair_stream_kernel<kOpAndNot><<<grid, kThreads, 0, st>>>(
          meta, n_leaves, k, out, n_shards, w4, chunk_shards, n_chunks, split);
      break;
    case kOpId:
      pair_stream_kernel<kOpId><<<grid, kThreads, 0, st>>>(
          meta, n_leaves, k, out, n_shards, w4, chunk_shards, n_chunks, split);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The program's table as int64: ptrs (n_leaves leaf pointers), then instr
// (n_instr instructions); depth = the depth class (2, 4 or 16) from
// ops/kernels.py program_plan. pbk_program_count copies host arrays of at
// most kParamMeta entries together into the kernel's parameters;
// pbk_program_count_table takes one device table of any length. Both
// zero out (int32[S]) on the stream first.
int pbk_program_count(const long long* ptrs, const long long* instr,
                      int n_leaves, int n_instr, int depth, int* out,
                      long long n_shards, long long w4, int split,
                      void* stream) {
  if (n_leaves < 1 || n_instr < 1 || n_leaves + n_instr > kParamMeta) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProgramParam prog;
  std::memcpy(prog.meta, ptrs, sizeof(long long) * n_leaves);
  std::memcpy(prog.meta + n_leaves, instr, sizeof(long long) * n_instr);
  const dim3 grid(static_cast<unsigned>(n_shards), split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * n_shards, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (depth) {
    case 2:
      program_count_kernel<2><<<grid, kThreads, 0, st>>>(prog, n_leaves,
                                                         n_instr, out, w4, split);
      break;
    case 4:
      program_count_kernel<4><<<grid, kThreads, 0, st>>>(prog, n_leaves,
                                                         n_instr, out, w4, split);
      break;
    case kMaxStack:
      program_count_kernel<kMaxStack><<<grid, kThreads, 0, st>>>(
          prog, n_leaves, n_instr, out, w4, split);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int pbk_program_count_table(const long long* meta, int n_leaves, int n_instr,
                            int depth, int* out, long long n_shards,
                            long long w4, int split, void* stream) {
  if (n_leaves < 1 || n_instr < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int stage = n_leaves + n_instr <= kStagedMeta;
  const size_t smem =
      stage ? sizeof(long long) * static_cast<size_t>(n_leaves + n_instr) : 0;
  const dim3 grid(static_cast<unsigned>(n_shards), split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * n_shards, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (depth) {
    case 2:
      program_count_table_kernel<2><<<grid, kThreads, smem, st>>>(
          meta, n_leaves, n_instr, stage, out, w4, split);
      break;
    case 4:
      program_count_table_kernel<4><<<grid, kThreads, smem, st>>>(
          meta, n_leaves, n_instr, stage, out, w4, split);
      break;
    case kMaxStack:
      program_count_table_kernel<kMaxStack><<<grid, kThreads, smem, st>>>(
          meta, n_leaves, n_instr, stage, out, w4, split);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// zeroes out (int32[S]) on the stream first
int pbk_intersect_count(const void* a, const void* b, int* out,
                        long long n_shards, long long w4, int split,
                        void* stream) {
  const dim3 grid(static_cast<unsigned>(n_shards), split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * n_shards, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  intersect_count_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), out, w4,
      split);
  return static_cast<int>(cudaGetLastError());
}

int pbk_bsi_compare(const void* planes, const void* exists, const int* pred,
                    int depth, int op, void* out, long long n, int blocks,
                    void* stream) {
  const uint4* p = static_cast<const uint4*>(planes);
  const uint4* e = static_cast<const uint4*>(exists);
  uint4* o = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kLt:
      bsi_compare_kernel<kLt><<<blocks, kThreads, 0, st>>>(p, e, pred, depth, o, n);
      break;
    case kLte:
      bsi_compare_kernel<kLte><<<blocks, kThreads, 0, st>>>(p, e, pred, depth, o, n);
      break;
    case kGt:
      bsi_compare_kernel<kGt><<<blocks, kThreads, 0, st>>>(p, e, pred, depth, o, n);
      break;
    case kGte:
      bsi_compare_kernel<kGte><<<blocks, kThreads, 0, st>>>(p, e, pred, depth, o, n);
      break;
    case kEq:
      bsi_compare_kernel<kEq><<<blocks, kThreads, 0, st>>>(p, e, pred, depth, o, n);
      break;
    case kNeq:
      bsi_compare_kernel<kNeq><<<blocks, kThreads, 0, st>>>(p, e, pred, depth, o, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int pbk_bsi_sum_counts(const void* planes, const long long* filters, int k,
                       int depth, int* out, long long n_shards, long long w4,
                       void* stream) {
  const long long parts = (w4 + kSumSpan - 1) / kSumSpan;
  const dim3 grid(static_cast<unsigned>(n_shards * parts),
                  static_cast<unsigned>(k));
  bsi_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(planes), filters, depth, out, n_shards, w4,
      static_cast<int>(parts));
  return static_cast<int>(cudaGetLastError());
}

// parts = blocks per (shard, filter group), from ops/kernels.py _split.
int pbk_bsi_sum_staged(const void* planes, const long long* filters, int k,
                       int depth, int* out, long long n_shards, long long w4,
                       int parts, void* stream) {
  int kt = 1;
  while (kt < k && kt < kSumFilters) kt <<= 1;
  const long long groups = (k + kt - 1) / kt;
  if (parts < 1 || groups > 65535 || n_shards * parts > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_shards * parts),
                  static_cast<unsigned>(groups));
  const uint4* p = static_cast<const uint4*>(planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pa = parts;
  cudaError_t e;
  switch (kt) {
    case 1:
      e = launch_sum_staged<1>(grid, st, p, filters, k, depth, out, n_shards, w4, pa);
      break;
    case 2:
      e = launch_sum_staged<2>(grid, st, p, filters, k, depth, out, n_shards, w4, pa);
      break;
    case 4:
      e = launch_sum_staged<4>(grid, st, p, filters, k, depth, out, n_shards, w4, pa);
      break;
    case 8:
      e = launch_sum_staged<8>(grid, st, p, filters, k, depth, out, n_shards, w4, pa);
      break;
    case 16:
      e = launch_sum_staged<16>(grid, st, p, filters, k, depth, out, n_shards, w4, pa);
      break;
    default:
      e = launch_sum_staged<32>(grid, st, p, filters, k, depth, out, n_shards, w4, pa);
      break;
  }
  return static_cast<int>(e);
}

int pbk_topn_counts(const long long* rows, int n_rows, const void* src,
                    int* out, long long n_shards, long long w4,
                    long long chunk_shards, void* stream) {
  const long long parts = (w4 + kTopnSpan - 1) / kTopnSpan;
  topn_counts_kernel<<<static_cast<unsigned>(n_shards * parts), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, static_cast<const uint4*>(src), out, w4,
      static_cast<int>(parts), chunk_shards);
  return static_cast<int>(cudaGetLastError());
}

int pbk_cross_count(const void* prefix, const void* axis, int n_prefix,
                    int n_axis, int* out, long long n_shards, long long w4,
                    long long chunk_shards, int n_chunks, int split,
                    void* stream) {
  const uint4* p = static_cast<const uint4*>(prefix);
  const uint4* a = static_cast<const uint4*>(axis);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pt = n_prefix <= 4 ? 1 : n_prefix <= 8 ? 2 : 4;
  const dim3 grid(static_cast<unsigned>(n_chunks * split),
                  static_cast<unsigned>((n_prefix + 4 * pt - 1) / (4 * pt)),
                  static_cast<unsigned>((n_axis + kCcRows - 1) / kCcRows));
  if (pt == 1) {
    cross_count_kernel<1><<<grid, kThreads, 0, st>>>(
        p, a, n_prefix, n_axis, out, n_shards, w4, chunk_shards, split);
  } else if (pt == 2) {
    cross_count_kernel<2><<<grid, kThreads, 0, st>>>(
        p, a, n_prefix, n_axis, out, n_shards, w4, chunk_shards, split);
  } else {
    cross_count_kernel<4><<<grid, kThreads, 0, st>>>(
        p, a, n_prefix, n_axis, out, n_shards, w4, chunk_shards, split);
  }
  return static_cast<int>(cudaGetLastError());
}

// block_unit, threads and grid from ops/kernels.py sparse_plan: the warp
// unit (block_unit 0) needs k <= 32 kSparseVec and takes threads / 32
// shards a block; the block unit takes one shard a block.
int pbk_sparse_intersect_dense(const void* sp, const void* dense, void* out,
                               long long n_shards, int k, long long w,
                               int keep_hits, int block_unit, int threads,
                               long long grid, void* stream) {
  const bool unit_ok = block_unit || k <= 32 * kSparseVec;
  const long long per_block = block_unit ? 1 : threads / 32;
  if (!unit_ok || threads < 32 || threads > kThreads || threads % 32 ||
      grid < 1 || grid > 0x7fffffffLL || grid * per_block < n_shards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* s = static_cast<const int*>(sp);
  const unsigned* d = static_cast<const unsigned*>(dense);
  int* o = static_cast<int*>(out);
  const bool vec4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  constexpr int V = kSparseVec;
  cudaError_t e;
  if (keep_hits) {
    e = block_unit ? launch_sparse_dense<true, V, false>(
                         g, threads, st, s, d, o, n_shards, k, w, vec4)
                   : launch_sparse_dense<true, V, true>(
                         g, threads, st, s, d, o, n_shards, k, w, vec4);
  } else {
    e = block_unit ? launch_sparse_dense<false, V, false>(
                         g, threads, st, s, d, o, n_shards, k, w, vec4)
                   : launch_sparse_dense<false, V, true>(
                         g, threads, st, s, d, o, n_shards, k, w, vec4);
  }
  return static_cast<int>(e);
}

}  // extern "C"
