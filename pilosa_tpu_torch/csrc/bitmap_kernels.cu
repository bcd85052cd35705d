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
//       (postfix bytecode and a table of leaf pointers, both in device
//       memory, so neither the leaf count nor the program length is
//       capped) + popcount -> int32[S].
//   pbk_intersect_count     replaces pallas_kernels.py intersect_count (:59,
//       body _and_count_kernel :34): the same kernel as program_count,
//       instantiated with the fixed program ("and", 0, 1).
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
// Design (a simple right kernel first, not yet a fast one):
//   * 16-byte uint4 loads, neighbouring threads on neighbouring addresses;
//   * __popc per 32-bit word, accumulated in a per-thread unsigned int;
//   * warp __shfl_down_sync reduction, then shared memory across warps;
//   * integer atomicAdd of each block's partial into the zeroed output
//     (exact in any order). A loop inside the block replaces the Pallas
//     grid's sequential shard axis; grid dimensions split a query or a
//     shard row across enough blocks to fill the 132 SMs.
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
// Design: one block per shard walks its K entries in tiles of 256. A
// thread loads one index, skips the plane for a sentinel, else tests bit
// idx & 31 of word idx >> 5 (read through the read-only cache). Kept
// entries are compacted in order: __ballot_sync and __popc of the lanes
// below give the rank in the warp, the eight warp counts in shared memory
// the warp's offset in the tile, and a running offset carries from tile to
// tile; the block then fills the row's tail with the sentinel. The input
// rows are sorted and unique, so compaction in order gives exactly
// sort(where(kept, idx, sentinel)): no sort, where the Pallas kernel
// masked and then sorted.
//
// Every C entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

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

// One uint4 of the program's result at element idx of every leaf.
// meta = [leaf pointers (n_leaves) | instructions (n_instr)] as int64 on
// the device, an instruction being opcode | leaf << 8. Every thread reads
// the same instruction, so the loads are broadcasts that hit in L1. The
// operand stack lives in local memory (dynamically indexed); leaves are
// read straight from the resident tensors, so no intermediate plane ever
// reaches HBM.
__device__ __forceinline__ uint4 eval_program(const long long* __restrict__ meta,
                                              int n_leaves, int n_instr,
                                              long long idx) {
  uint4 stack[kMaxStack];
  int sp = 0;
  for (int pc = 0; pc < n_instr; ++pc) {
    const long long ins = __ldg(meta + n_leaves + pc);
    const unsigned char c = static_cast<unsigned char>(ins & 0xff);
    if (c == kLeaf) {
      const uint4* leaf = reinterpret_cast<const uint4*>(__ldg(meta + (ins >> 8)));
      stack[sp++] = __ldg(leaf + idx);
    } else if (c == kNot) {
      stack[sp - 1] = not4(stack[sp - 1]);
    } else {
      const uint4 b = stack[--sp];
      const uint4 a = stack[sp - 1];
      stack[sp - 1] = c == kAnd      ? and4(a, b)
                      : c == kOr     ? or4(a, b)
                      : c == kXor    ? xor4(a, b)
                      : c == kAndNot ? andnot4(a, b)
                                     : andnot4(b, a);  // kRAndNot
    }
  }
  return stack[0];
}

// grid (S, split): block (s, part) counts part of shard s's w4 uint4s.
// kFixedAnd counts a & b (intersect_count) and ignores meta.
template <bool kFixedAnd>
__global__ void __launch_bounds__(kThreads)
    program_count_kernel(const uint4* __restrict__ a,
                         const uint4* __restrict__ b,
                         const long long* __restrict__ meta, int n_leaves,
                         int n_instr, int* __restrict__ out, long long w4,
                         int split) {
  const long long shard = blockIdx.x;
  const long long per = (w4 + split - 1) / split;
  const long long lo = per * blockIdx.y;
  const long long hi = lo + per < w4 ? lo + per : w4;
  const long long base = shard * w4;
  unsigned acc = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    uint4 v;
    if (kFixedAnd) {
      v = and4(__ldg(a + base + i), __ldg(b + base + i));
    } else {
      v = eval_program(meta, n_leaves, n_instr, base + i);
    }
    acc += popc4(v);
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
constexpr int kWarps = kThreads / 32;

// grid (S): block s compacts row s of sp [S, k] against plane s of dense
// [S, w] into out [S, k]. kKeepHits keeps the entries whose bit is set,
// else those whose bit is clear; sentinel entries are never kept.
template <bool kKeepHits>
__global__ void __launch_bounds__(kThreads)
    sparse_dense_kernel(const int* __restrict__ sp,
                        const unsigned* __restrict__ dense,
                        int* __restrict__ out, int k, long long w) {
  __shared__ int warp_counts[kWarps];
  const long long shard = blockIdx.x;
  const int* row = sp + shard * k;
  const unsigned* plane = dense + shard * w;
  int* dst = out + shard * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  int filled = 0;
  for (int base = 0; base < k; base += kThreads) {
    const int i = base + threadIdx.x;
    const int idx = i < k ? __ldg(row + i) : kSentinel;
    bool keep = false;
    if (static_cast<unsigned>(idx) < static_cast<unsigned>(kSentinel)) {
      const unsigned word = __ldg(plane + (idx >> 5));
      const bool bit = (word >> (idx & 31)) & 1u;
      keep = kKeepHits ? bit : !bit;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int offset = filled, total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int c = warp_counts[v];
      offset += v < warp ? c : 0;
      total += c;
    }
    if (keep) dst[offset + __popc(ballot & below)] = idx;
    filled += total;
    __syncthreads();  // warp_counts is rewritten by the next tile
  }
  for (int i = filled + threadIdx.x; i < k; i += kThreads) dst[i] = kSentinel;
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

int pbk_program_count(const long long* meta, int n_leaves, int n_instr,
                      int* out, long long n_shards, long long w4, int split,
                      void* stream) {
  const dim3 grid(static_cast<unsigned>(n_shards), split);
  program_count_kernel<false><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, meta, n_leaves, n_instr, out, w4, split);
  return static_cast<int>(cudaGetLastError());
}

int pbk_intersect_count(const void* a, const void* b, int* out,
                        long long n_shards, long long w4, int split,
                        void* stream) {
  const dim3 grid(static_cast<unsigned>(n_shards), split);
  program_count_kernel<true><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), nullptr, 0,
      0, out, w4, split);
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

int pbk_sparse_intersect_dense(const void* sp, const void* dense, void* out,
                               long long n_shards, int k, long long w,
                               int keep_hits, void* stream) {
  const int* s = static_cast<const int*>(sp);
  const unsigned* d = static_cast<const unsigned*>(dense);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_shards));
  if (keep_hits) {
    sparse_dense_kernel<true><<<grid, kThreads, 0, st>>>(s, d, o, k, w);
  } else {
    sparse_dense_kernel<false><<<grid, kThreads, 0, st>>>(s, d, o, k, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
