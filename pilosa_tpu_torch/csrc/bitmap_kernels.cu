// Hand-written Hopper (sm_90a) kernels for the dense bitmap read path.
//
// Three kernels, one device code base:
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
// Design (a simple right kernel first, not yet a fast one):
//   * 16-byte uint4 loads, neighbouring threads on neighbouring addresses;
//   * __popc per 32-bit word, accumulated in a per-thread unsigned int;
//   * warp __shfl_down_sync reduction, then shared memory across warps;
//   * integer atomicAdd of each block's partial into the zeroed output
//     (exact in any order). A loop inside the block replaces the Pallas
//     grid's sequential shard axis; grid dimensions split a query or a
//     shard row across enough blocks to fill the 132 SMs.
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
__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
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

}  // extern "C"
