// Bit-sliced scoring kernels for COBS queries, written for Hopper (sm_90a).
//
// Shared semantics (those of repro.kernels.ref): arena words are uint32
// (carried by PyTorch as int32 bit patterns); document d of a row is bit
// d % 32 of word d / 32; an output [..., W, 32] holds int32 counts in
// (word, bit) order. Each kernel replaces Pallas kernels of
// src/repro/kernels/bitslice_score.py:
//
//   unpack_kernel      <- _unpack_kernel   (unpack_score)
//   vertical_kernel    <- _vertical_kernel (vertical_score)
//   lookup_kernel      <- _lookup_kernel, _lookup_blocks_kernel and
//                         _lookup_multi_kernel (lookup_score,
//                         lookup_score_blocks, lookup_score_multi)
//   lookup_comp_kernel <- _lookup_blocks_comp_kernel and
//                         _lookup_multi_comp_kernel
//                         (lookup_score_blocks_compressed,
//                         lookup_score_multi_compressed)
//   chunk_lookup_kernel      <- _chunk_multi_kernel
//                               (chunk_lookup_score_multi)
//   chunk_lookup_comp_kernel <- _chunk_multi_comp_kernel
//                               (chunk_lookup_score_multi_compressed)
//   chunk_dedup_kernel       <- _chunk_dedup_kernel (chunk_dedup_score)
//
// What bounds them on an H100: bytes. A query reads L rows of W words and
// writes W * 32 counts; the arithmetic is a few integer operations per
// word, far below the card's rate. The least time is (rows read + indices
// read + counts written) / 3.35 TB/s. At the main path's shapes (W = 32 to
// 64 words, L <= 320 terms) that is well under a microsecond, so a single
// query is bound in practice by the launch and by the dependent chain of
// loads down the term loop; these first versions are simple and right,
// and their times stand in PERF.md.
//
// The fused-decode lookup reads row r of a rowdict-coded shard as
// dict[refs[r]]: per term, one more 4-byte load (refs) before the row. Its
// bound is (indices + masks + one refs entry and one dict row per counted
// term + counts written) / 3.35 TB/s; the dependent chain is three loads
// long instead of two.
//
// The chunked-accumulator kernels (the pruned and bulk executors) score
// one chunk of Lc terms and add the counts into a running-count buffer:
// out = acc + counts, acc and out int32 [Q, nb, Wp, 32] with Wp >= W (the
// JAX executors pad the word axis of acc to a word block; words >= W read
// as zero rows). Their bound is the fused lookup's plus acc read once and
// out written once. All three are the fused lookup's body with kAcc set:
// chunk_dedup_score(uniq, indir, mask, acc) is exactly
// chunk_lookup_score_multi(uniq, indir, mask, acc), the unique-row matrix
// taking the arena's place; its own __global__ name lets the profiler
// and the launch counters tell the two uses apart.
//
// Design common to all:
// * The TPU kernels carry counter planes across a sequential grid axis
//   over terms. CUDA blocks run in no order, so the term loop runs inside
//   one thread instead, and nothing carries between blocks.
// * Work items are flattened as g = cell * W + word (cell * Wp + word in
//   the chunk kernels), where a cell is one (query, block) pair or one
//   batch entry. Each thread reads only its own acc range, so the chunk
//   kernels need no carry between blocks either. Neighbouring threads read
//   neighbouring words of one row, so a warp reads a row's 128 bytes at
//   W = 32 in one transaction, and the ragged word edge needs no padding.
// * The output of item g is out[g * 32 .. g * 32 + 31]; a block's outputs
//   are one contiguous range, which expand_store writes coalesced through
//   shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 16;   // counts up to 65535 terms
constexpr int kThreads = 128;    // threads per block, vertical and lookup
constexpr int kUnpackThreads = 256;
constexpr int kPad = 33;         // shared-memory row stride: no bank conflicts

// Ripple-carry one row word into the thread's counter planes (Harley-Seal
// vertical counters): plane j holds bit j of each document's count.
__device__ __forceinline__ void ripple_add(uint32_t (&p)[kMaxPlanes],
                                           uint32_t carry, int n_planes) {
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) {
    if (j < n_planes) {
      const uint32_t next = p[j] & carry;
      p[j] ^= carry;
      carry = next;
    }
  }
}

// Expand each thread's planes to its word's 32 counts, stage them in
// shared memory, and store the block's contiguous [n_items, 32] output
// with consecutive threads on consecutive addresses. With kAcc the store
// adds the running counts acc_block (the same range as out_block, read
// once by the thread that writes that element).
template <bool kAcc = false>
__device__ __forceinline__ void expand_store(const uint32_t (&p)[kMaxPlanes],
                                             int n_planes, bool active,
                                             int32_t* __restrict__ out_block,
                                             int n_items,
                                             const int32_t* __restrict__
                                                 acc_block = nullptr) {
  __shared__ int32_t tile[kThreads * kPad];
  const int t = threadIdx.x;
  if (active) {
    for (int bit = 0; bit < 32; ++bit) {
      int32_t c = 0;
#pragma unroll
      for (int j = 0; j < kMaxPlanes; ++j) {
        if (j < n_planes) c |= static_cast<int32_t>((p[j] >> bit) & 1u) << j;
      }
      tile[t * kPad + bit] = c;
    }
  }
  __syncthreads();
  for (int e = t; e < n_items * 32; e += blockDim.x) {
    int32_t c = tile[(e >> 5) * kPad + (e & 31)];
    if constexpr (kAcc) c += acc_block[e];
    out_block[e] = c;
  }
}

// One thread per output (cell, word, bit): it walks the L rows of its cell
// and adds bit `bit` of its word. The 32 lanes of a warp share one word,
// so each load is a broadcast and each store is coalesced.
__global__ void unpack_kernel(const uint32_t* __restrict__ rows,
                              int32_t* __restrict__ out, int L, int W,
                              long long total) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (g >= total) return;
  const long long item = g >> 5;
  const int bit = static_cast<int>(g & 31);
  const long long cell = item / W;
  const int w = static_cast<int>(item % W);
  const uint32_t* src = rows + cell * L * W + w;
  int32_t acc = 0;
  for (int l = 0; l < L; ++l) {
    acc += static_cast<int32_t>((src[static_cast<long long>(l) * W] >> bit)
                                & 1u);
  }
  out[g] = acc;
}

// One thread per (cell, word) with its counter planes in registers; the
// term loop is sequential inside the thread and the expansion to counts
// happens once at the end.
__global__ void __launch_bounds__(kThreads)
vertical_kernel(const uint32_t* __restrict__ rows, int32_t* __restrict__ out,
                int L, int W, long long total, int n_planes) {
  const long long g0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long g = g0 + threadIdx.x;
  const bool active = g < total;
  uint32_t p[kMaxPlanes];
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) p[j] = 0u;
  if (active) {
    const long long cell = g / W;
    const int w = static_cast<int>(g % W);
    const uint32_t* src = rows + cell * L * W + w;
    for (int l = 0; l < L; ++l) {
      ripple_add(p, src[static_cast<long long>(l) * W], n_planes);
    }
  }
  const long long left = total - g0;
  expand_store(p, n_planes, active, out + g0 * 32,
               static_cast<int>(left < kThreads ? left : kThreads));
}

// The fused gather + vertical count over [cells, L] indices: one thread
// per (cell, word). Each thread reads its cell's indices and mask itself
// (a warp-wide broadcast, served from L1 after the first lane) - there is
// no scalar prefetch on this card. A term with mask 0 is skipped, which
// gives the TPU kernel's `row * mask`. With kDecode, row r is read as
// rows[refs[r]] (a rowdict pair: rows is the dictionary), the index the
// TPU kernels resolve in their BlockSpec index map; the refs entry is one
// more broadcast load per term. Items run over Wp words a cell (Wp >= W,
// the rows' width); a word >= W reads as a zero row. With kAcc the counts
// are added to acc (same layout as out) as they are stored.
template <bool kDecode, bool kAcc>
__device__ __forceinline__ void lookup_body(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ refs,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ mask,
    const int32_t* __restrict__ acc, int32_t* __restrict__ out, int L,
    int W, int Wp, long long total, int n_planes) {
  const long long g0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long g = g0 + threadIdx.x;
  const bool active = g < total;
  uint32_t p[kMaxPlanes];
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) p[j] = 0u;
  if (active) {
    const long long cell = g / Wp;
    const int w = static_cast<int>(g % Wp);
    const int32_t* ci = idx + cell * L;
    const int32_t* cm = mask + cell * L;
    if (w < W) {
      for (int l = 0; l < L; ++l) {
        if (cm[l] != 0) {
          long long r = ci[l];
          if constexpr (kDecode) r = refs[r];
          ripple_add(p, rows[r * W + w], n_planes);
        }
      }
    }
  }
  const long long left = total - g0;
  expand_store<kAcc>(p, n_planes, active, out + g0 * 32,
                     static_cast<int>(left < kThreads ? left : kThreads),
                     kAcc ? acc + g0 * 32 : nullptr);
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const uint32_t* __restrict__ arena,
              const int32_t* __restrict__ idx,
              const int32_t* __restrict__ mask, int32_t* __restrict__ out,
              int L, int W, long long total, int n_planes) {
  lookup_body<false, false>(arena, nullptr, idx, mask, nullptr, out, L, W, W,
                            total, n_planes);
}

// The fused-decode lookup over a rowdict pair (dict [D, W], refs [R]).
__global__ void __launch_bounds__(kThreads)
lookup_comp_kernel(const uint32_t* __restrict__ dict,
                   const int32_t* __restrict__ refs,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ mask,
                   int32_t* __restrict__ out, int L, int W, long long total,
                   int n_planes) {
  lookup_body<true, false>(dict, refs, idx, mask, nullptr, out, L, W, W,
                           total, n_planes);
}

// One term chunk of the pruned and bulk executors, fused-gathered from a
// resident raw tile and added into the running counts.
__global__ void __launch_bounds__(kThreads)
chunk_lookup_kernel(const uint32_t* __restrict__ arena,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ mask,
                    const int32_t* __restrict__ acc,
                    int32_t* __restrict__ out, int L, int W, int Wp,
                    long long total, int n_planes) {
  lookup_body<false, true>(arena, nullptr, idx, mask, acc, out, L, W, Wp,
                           total, n_planes);
}

// The same over a resident rowdict pair (dict [D, W], refs [R]).
__global__ void __launch_bounds__(kThreads)
chunk_lookup_comp_kernel(const uint32_t* __restrict__ dict,
                         const int32_t* __restrict__ refs,
                         const int32_t* __restrict__ idx,
                         const int32_t* __restrict__ mask,
                         const int32_t* __restrict__ acc,
                         int32_t* __restrict__ out, int L, int W, int Wp,
                         long long total, int n_planes) {
  lookup_body<true, true>(dict, refs, idx, mask, acc, out, L, W, Wp, total,
                          n_planes);
}

// One term chunk read through indir from a unique-row matrix uniq [U, W]
// (host-gathered rows, or device-gathered and ANDed row sets for k > 1).
__global__ void __launch_bounds__(kThreads)
chunk_dedup_kernel(const uint32_t* __restrict__ uniq,
                   const int32_t* __restrict__ indir,
                   const int32_t* __restrict__ mask,
                   const int32_t* __restrict__ acc,
                   int32_t* __restrict__ out, int L, int W, int Wp,
                   long long total, int n_planes) {
  lookup_body<false, true>(uniq, nullptr, indir, mask, acc, out, L, W, Wp,
                           total, n_planes);
}

unsigned int blocks_for(long long items, int threads) {
  return static_cast<unsigned int>((items + threads - 1) / threads);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() (0 = launched). The wrappers in bitslice_score.py
// validate shapes, types and index ranges before calling.

extern "C" int cobs_unpack(const void* rows, void* out, int B, int L, int W,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * W * 32;
  unpack_kernel<<<blocks_for(total, kUnpackThreads), kUnpackThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<int32_t*>(out), L, W,
      total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cobs_vertical(const void* rows, void* out, int B, int L,
                             int W, int n_planes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * W;
  vertical_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<int32_t*>(out), L, W,
      total, n_planes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cobs_lookup(const void* arena, const void* idx,
                           const void* mask, void* out, int cells, int L,
                           int W, int n_planes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(cells) * W;
  lookup_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(arena), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(mask), static_cast<int32_t*>(out), L, W,
      total, n_planes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cobs_lookup_comp(const void* dict, const void* refs,
                                const void* idx, const void* mask, void* out,
                                int cells, int L, int W, int n_planes,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(cells) * W;
  lookup_comp_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dict), static_cast<const int32_t*>(refs),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(mask),
      static_cast<int32_t*>(out), L, W, total, n_planes);
  return static_cast<int>(cudaGetLastError());
}

// The chunk entry points: rows [R, W] (uniq for the dedup kernel), idx
// (indir) and mask [cells, L], acc and out [cells, Wp, 32].
extern "C" int cobs_chunk_lookup(const void* arena, const void* idx,
                                 const void* mask, const void* acc,
                                 void* out, int cells, int L, int W, int Wp,
                                 int n_planes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(cells) * Wp;
  chunk_lookup_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(arena), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(mask), static_cast<const int32_t*>(acc),
      static_cast<int32_t*>(out), L, W, Wp, total, n_planes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cobs_chunk_lookup_comp(const void* dict, const void* refs,
                                      const void* idx, const void* mask,
                                      const void* acc, void* out, int cells,
                                      int L, int W, int Wp, int n_planes,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(cells) * Wp;
  chunk_lookup_comp_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dict), static_cast<const int32_t*>(refs),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(mask),
      static_cast<const int32_t*>(acc), static_cast<int32_t*>(out), L, W, Wp,
      total, n_planes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cobs_chunk_dedup(const void* uniq, const void* indir,
                                const void* mask, const void* acc, void* out,
                                int cells, int L, int W, int Wp, int n_planes,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(cells) * Wp;
  chunk_dedup_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(uniq), static_cast<const int32_t*>(indir),
      static_cast<const int32_t*>(mask), static_cast<const int32_t*>(acc),
      static_cast<int32_t*>(out), L, W, Wp, total, n_planes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cobs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
