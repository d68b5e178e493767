// Bit-sliced scoring kernels for COBS queries, written for Hopper (sm_90a).
//
// Shared semantics (those of repro.kernels.ref): arena words are uint32
// (carried by PyTorch as int32 bit patterns); document d of a row is bit
// d % 32 of word d / 32; an output [..., W, 32] holds int32 counts in
// (word, bit) order. Each kernel replaces Pallas kernels of
// src/repro/kernels/bitslice_score.py:
//
//   unpack_kernel      <- _unpack_kernel   (unpack_score); the unpack body
//   vertical_kernel    <- _vertical_kernel (vertical_score);
//                         split_body<kRows, false>
//   lookup_kernel      <- _lookup_kernel, _lookup_blocks_kernel and
//                         _lookup_multi_kernel (lookup_score,
//                         lookup_score_blocks, lookup_score_multi);
//                         split_body<kIndexed, false>
//   lookup_comp_kernel <- _lookup_blocks_comp_kernel and
//                         _lookup_multi_comp_kernel
//                         (lookup_score_blocks_compressed,
//                         lookup_score_multi_compressed);
//                         split_body<kDecoded, false>
//   chunk_lookup_kernel      <- _chunk_multi_kernel
//                               (chunk_lookup_score_multi);
//                               split_body<kTile, true>
//   chunk_lookup_comp_kernel <- _chunk_multi_comp_kernel
//                               (chunk_lookup_score_multi_compressed);
//                               split_body<kDecoded, true>
//   chunk_dedup_kernel       <- _chunk_dedup_kernel (chunk_dedup_score);
//                               split_body<kIndexed, true>
//   gather_kernel      <- _gather_kernel (gather_rows); gather_body
//   gather_comp_kernel <- the kernel of gather_rows_compressed; gather_body
//   dedup_kernel       <- _dedup_score_kernel (dedup_score);
//                         split_body<kUniq, false>
//   grouped::lookup_kernel <- none (lookup_score_grouped): every resident
//                         block of a batch in one launch, each term's row
//                         hashed and planned in the kernel;
//                         split_body<kHashed, false>
//   select_kernel      <- none (select_scores): the server's selection of a
//                         dense batch's hits, which the JAX server makes on
//                         the host in numpy
//
// What bounds them on an H100: bytes. A query reads L rows of W words and
// writes W * 32 counts; the arithmetic is a few integer operations per
// word, far below the card's rate. The least time is (rows read + indices
// read + counts written) / 3.35 TB/s. At the main path's shapes (W = 8 to
// 64 words, L <= 320 terms) that is well under a microsecond, so in
// practice a launch is bound by latency: how many dependent memory round
// trips its slowest thread makes, and how few of the card's 132 SMs a
// launch of 1-64 (cell, word) pairs occupies.
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
// out written once. chunk_dedup_score(uniq, indir, mask, acc) computes
// chunk_lookup_score_multi(uniq, indir, mask, acc), the unique-row matrix
// taking the arena's place; all three chunk kernels run the split body in
// its accumulate mode.
//
// The row-dedup pair of the single-host server: gather_kernel copies each
// unique arena row (or ANDs each unique k-row set) of a batch once into a
// compact matrix uniq [U, W]; dedup_kernel then scores every (query,
// block) cell through the indirection indir [Q, nb, L] into uniq. The
// gather is a copy: its bound is (U * k indices + U * k rows read + U rows
// written) / 3.35 TB/s. gather_comp_kernel reads row r as dict[refs[r]],
// one more 4-byte load a row. At the served shapes (a few thousand rows of
// 16-128 bytes) both are latency: a chain of dependent loads (index, refs
// entry, row) and a launch. dedup_kernel is lookup_kernel over uniq
// instead of the arena (the split body); its bound is the fused lookup's
// with rows counted once per distinct uniq row. The pair overlaps with
// programmatic dependent launch: a gather block lets the dedup launch
// begin once it has issued its row loads, and dedup_kernel stages its
// first indirections while the gather runs, then waits for the gather's
// rows (griddepcontrol) before it loads any.
//
// Design. The TPU kernels carry counter planes across a sequential grid
// axis over terms. CUDA blocks run in no order, so the term axis is cut
// inside a block (or a cluster of blocks) instead, and nothing carries
// between launches. Two bodies:
//
// * The split body (split_body: every kernel but unpack_kernel and the
//   gathers, each with its source mode and accumulate flag as listed above).
//   One block of 256 threads per (cell, word tile), where a cell is one batch
//   entry or one (query, block) pair and a word tile is Wt <= 32 consecutive
//   words (W, or the running counts' Wp, cut into ceil(W / 32) near-equal
//   tiles). Thread t works on word t % Wt of the tile and on term slice t / Wt
//   of S = 256 / Wt; slice s takes terms s, s + S, s + 2S, ..., so a warp
//   reads 32 / Wt whole row segments per load, coalesced. Each thread issues 8
//   independent row loads before it ripples any of them into its counter
//   planes (num_planes(ceil(terms / S)), at most 16, a compile-time count
//   picked per launch), so a step costs one memory latency, not one per term.
//   Its source mode says where rows come from: the cell's own rows (kRows), or
//   the rows of indices that the block stages in shared memory first
//   (cp.async, double-buffered tiles of 1,024 terms), which takes the index
//   load out of each term's chain (kIndexed, kUniq, kTile); the decoded mode
//   (kDecoded) then replaces each staged index by its refs entry, all of a
//   stage's refs loads in flight at once across the block. At the end the
//   threads write their planes to shared memory and each thread sums one
//   output's bit over the S slices and the planes, so the tile's Wt * 32
//   counts are stored as one coalesced range; the accumulate mode (the three
//   chunk kernels) adds each count's acc element, read once by the storing
//   thread (before the term loop when there is no cluster). A slice that would
//   pass 65,535 terms flushes its planes into those counts first, so any L
//   runs in one launch. Where a launch has few (cell, tile) pairs, a cluster
//   of 2-8 blocks splits the pair's terms; rank 0..cs-1 each sum a share of
//   the tile's counts over the cluster's shared memory (distributed shared
//   memory), so no global atomics or memsets are needed.
// * The unpack body (unpack_kernel), which keeps the TPU kernel's 32-way
//   expansion: one block of 8 warps per (cell, word), lane b counting bit
//   b of the word in an int32 (each row load a broadcast to the warp), the
//   warps splitting the term loop into slices with 8 row loads in flight,
//   summed in shared memory into one 128-byte line; no planes, so any L in
//   one launch; a cluster splits a word's terms as in the split body.
// * The gather body (gather_body: gather_kernel, gather_comp_kernel). A warp
//   takes 32 row sets: lane j loads the indices of set j (and for the
//   decode their refs entries), so each level of the index chain is one
//   round trip for 32 rows; the warp then moves the rows as 16-, 8- or
//   4-byte vectors (the widest that W and both pointers allow, one
//   instantiation each), each row's source offsets broadcast by shuffle,
//   every row of a set loaded before the first AND.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// a split slice's counter planes, and the split body's flush threshold:
// they count up to kFlushTerms terms, and a slice that would pass them
// flushes its planes into the block's counts first
constexpr int kMaxPlanes = 16;
constexpr int kFlushTerms = (1 << kMaxPlanes) - 1;
constexpr int kUnpackWarps = 8;  // warps (term slices) of an unpack block
// the gather body: row sets of a block, each of its warps resolving all
// of them (one a lane); rows of a set in flight at once (a set of more rows
// is ANDed in rounds of this many); vectors a lane keeps in flight; the
// warp-steps a block's warp takes (a block gets as many warps, up to
// kGatherMaxWarps, as its sets' rows need at that many steps a warp)
constexpr int kGatherSets = 32;
constexpr int kGatherRows = 4;
constexpr int kGatherInFlight = 4;
constexpr int kGatherSteps = 1;
constexpr int kGatherMaxWarps = 8;
// the split body (vertical_kernel, the lookup, chunk and dedup kernels);
// kUnroll also in unpack_kernel
constexpr int kSplitThreads = 256;
constexpr int kWordTile = 32;     // most words of a block's tile
constexpr int kStageTerms = 1024; // terms per shared-memory index stage
constexpr int kUnroll = 8;        // row loads in flight per thread
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kOwn = kWordTile * 32 / kSplitThreads;  // outputs a thread sums
// a cluster is chosen only while each slice keeps this many terms; for
// unpack_kernel, whose clusters cost more than they save until each warp
// keeps 4 steps of row loads (tools/split_probe.py, PERF.md section 6)
constexpr int kMinSliceTerms = 2;
constexpr int kUnpackMinSliceTerms = 4 * kUnroll;

// ---------------------------------------------------------------------------
// The split body of vertical_kernel, lookup_kernel, lookup_comp_kernel,
// the three chunk kernels and dedup_kernel
// ---------------------------------------------------------------------------

// A word tile's geometry for W words: tiles of wt <= 32 words, S slices.
struct SplitGeometry {
  int tiles, wt, slices;
};

__host__ __device__ __forceinline__ SplitGeometry split_geometry(int W) {
  SplitGeometry g;
  g.tiles = W > 0 ? (W + kWordTile - 1) / kWordTile : 1;
  g.wt = W > 0 ? (W + g.tiles - 1) / g.tiles : 1;
  g.slices = kSplitThreads / g.wt;
  return g;
}

// Counter planes that hold counts up to `terms` (num_planes), at most 16.
__host__ __device__ __forceinline__ int planes_for(int terms) {
  int n = 1;
  while (n < kMaxPlanes && (terms >> n) != 0) ++n;
  return n;
}

// Ripple-carry one step's kUnroll row words into NP counter planes. NP is
// a compile-time count: a plane count known only at run time would guard
// every one of 16 planes per word, which costs more than the loads.
template <int NP>
__device__ __forceinline__ void ripple_step(uint32_t (&p)[kMaxPlanes],
                                            const uint32_t (&v)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    uint32_t carry = v[u];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const uint32_t next = p[j] & carry;
      p[j] ^= carry;
      carry = next;
    }
  }
}

// ripple_step with np (1-16, uniform across the block) as its NP.
__device__ __forceinline__ void ripple_step(uint32_t (&p)[kMaxPlanes],
                                            const uint32_t (&v)[kUnroll],
                                            int np) {
  switch (np) {
    case 1: ripple_step<1>(p, v); break;
    case 2: ripple_step<2>(p, v); break;
    case 3: ripple_step<3>(p, v); break;
    case 4: ripple_step<4>(p, v); break;
    case 5: ripple_step<5>(p, v); break;
    case 6: ripple_step<6>(p, v); break;
    case 7: ripple_step<7>(p, v); break;
    case 8: ripple_step<8>(p, v); break;
    case 9: ripple_step<9>(p, v); break;
    case 10: ripple_step<10>(p, v); break;
    case 11: ripple_step<11>(p, v); break;
    case 12: ripple_step<12>(p, v); break;
    case 13: ripple_step<13>(p, v); break;
    case 14: ripple_step<14>(p, v); break;
    case 15: ripple_step<15>(p, v); break;
    default: ripple_step<16>(p, v); break;
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Programmatic dependent launch (sm_90): a primary grid's block lets the
// grid launched after it with programmatic stream serialization begin
// (once every block has triggered or exited); the dependent grid waits
// until its primary has completed and its memory is visible. The memory
// clobbers keep the loads before the trigger and every access after the
// wait where they are written.
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Sum every slice's counter planes into the outputs this thread owns
// (e = t + k * 256, in the tile's (word, bit) order), then clear the
// planes. Every thread of the block calls it at the same point.
__device__ __forceinline__ void split_flush(uint32_t (&p)[kMaxPlanes],
                                            int32_t (&own)[kOwn],
                                            uint32_t* s_planes, int np,
                                            int S, int wt, int wn) {
  const int t = threadIdx.x;
  const int s = t / wt, w = t % wt;
  if (s < S) {
#pragma unroll
    for (int j = 0; j < kMaxPlanes; ++j) {
      if (j < np) s_planes[(j * S + s) * wt + w] = p[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int e = t + k * kSplitThreads;
    if (e < wn * 32) {
      const uint32_t* col = s_planes + (e >> 5);  // word e / 32 of each plane
      const int bit = e & 31;
      int32_t c = 0;
      for (int j = 0; j < np; ++j) {
        int32_t cj = 0;
#pragma unroll 4
        for (int q = 0; q < S; ++q) {
          cj += static_cast<int32_t>((col[(j * S + q) * wt] >> bit) & 1u);
        }
        c += cj << j;
      }
      own[k] += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) p[j] = 0u;
}

// Copy n indices and masks of a cell, from term `start`, into stage `buf`
// of the shared buffers (cp.async, one commit group). Thread t copies
// terms t, t + 256, ... of the stage.
__device__ __forceinline__ void split_stage(
    int32_t (*s_idx)[kStageTerms], int32_t (*s_mask)[kStageTerms], int buf,
    const int32_t* ci, const int32_t* cm, int start, int n) {
  for (int i = threadIdx.x; i < n; i += kSplitThreads) {
    cp_async4(&s_idx[buf][i], ci + start + i);
    cp_async4(&s_mask[buf][i], cm + start + i);
  }
  cp_async_commit();
}

// The rowdict decode of a stage of n terms that has landed: each thread
// replaces the indices it staged itself (visible to it once its
// cp.async.wait_group returns) by their refs entries, its up to 4 loads in
// flight at once, so the block resolves a stage's refs in one memory
// round trip. A term whose mask is 0 loads nothing. The block syncs after.
__device__ __forceinline__ void split_decode(
    int32_t* s_idx, const int32_t* s_mask, const int32_t* __restrict__ refs,
    int n) {
  constexpr int kPer = kStageTerms / kSplitThreads;
  int32_t r[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kSplitThreads;
    r[k] = i < n && s_mask[i] != 0 ? refs[s_idx[i]] : 0;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kSplitThreads;
    if (i < n) s_idx[i] = r[k];
  }
}

// The term hash of core/hashing.py: hash_terms for one hash (seed 0): a
// murmur3 mix of the packed term's (lo, hi) words and murmur3's fmix32.
constexpr uint32_t kHashC1 = 0xCC9E2D51u, kHashC2 = 0x1B873593u;
constexpr uint32_t kHashF1 = 0x85EBCA6Bu, kHashF2 = 0xC2B2AE35u;
constexpr uint32_t kHashSeed0 = 0x2545F491u;  // (0 * 0x9E3779B9) ^ 0x2545F491
constexpr uint32_t kHashAdd = 0xE6546B64u;

__device__ __forceinline__ uint32_t hash_mix(uint32_t h, uint32_t word) {
  const uint32_t k0 = word * kHashC1;
  const uint32_t k = __funnelshift_l(k0, k0, 15) * kHashC2;
  const uint32_t x = h ^ k;
  return __funnelshift_l(x, x, 13) * 5u + kHashAdd;
}

__device__ __forceinline__ uint32_t term_hash(uint32_t lo, uint32_t hi) {
  uint32_t h = hash_mix(hash_mix(kHashSeed0, lo), hi) ^ 8u;
  h ^= h >> 16;
  h *= kHashF1;
  h ^= h >> 13;
  h *= kHashF2;
  return h ^ (h >> 16);
}

// One block of a grouped lookup's block table (24 bytes, as
// kernels/bitslice_score.py: BlockTable packs it): the tile that holds the
// block's rows, the block's first row in it and its width (the hash's
// modulus; row_offset + width never passes the tile's rows, checked once
// when the table is built), and the block's place on the output's block
// axis.
struct LookupBlock {
  const uint32_t* rows;
  int row_offset;
  int width;
  int slot;
  int pad;
};
static_assert(sizeof(LookupBlock) == 24, "BlockTable packs 24-byte entries");

// A grouped lookup's batch: the block table, the queries' packed terms
// [queries, L, 2] and live term counts [queries] (null: every term of L),
// and the output's block count (out is [queries, blocks, W, 32]).
struct HashedBatch {
  const LookupBlock* table;
  const int32_t* terms;
  const int32_t* n_valid;
  int queries;
  int blocks;
};

// kHashed's stage: n terms of a query, from term `start`, each computed
// here into stage `buf`: a live term (below nv) gets its row, the block's
// row_offset + term_hash % width, and mask 1; a term past nv row 0 and
// mask 0. Thread t takes terms t, t + 256, ... of the stage and loads all
// of their words before it hashes any: the loads depend on nothing the
// block loads first (every term of the stage lies below L), so they are in
// flight with the table entry's and n_valid's, one memory round trip a
// stage as cp.async's is. Plain stores, visible to the block after the
// body's barrier; the empty commit group keeps the body's one group a
// stage.
__device__ __forceinline__ void split_stage_hashed(
    int32_t (*s_idx)[kStageTerms], int32_t (*s_mask)[kStageTerms], int buf,
    const int32_t* terms, int nv, const LookupBlock& blk, int start, int n) {
  constexpr int kPer = kStageTerms / kSplitThreads;
  int32_t lo[kPer], hi[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kSplitThreads;
    lo[k] = i < n ? terms[2 * (start + i)] : 0;
    hi[k] = i < n ? terms[2 * (start + i) + 1] : 0;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kSplitThreads;
    if (i < n) {
      const bool live = start + i < nv;
      const uint32_t h = term_hash(static_cast<uint32_t>(lo[k]),
                                   static_cast<uint32_t>(hi[k]));
      s_idx[buf][i] = live ? blk.row_offset + static_cast<int32_t>(
                                 h % static_cast<uint32_t>(blk.width))
                           : 0;
      s_mask[buf][i] = live ? 1 : 0;
    }
  }
  cp_async_commit();
}

// Where a split block reads its rows: the cell's contiguous [L, W] block
// (vertical), the arena row of each staged index (lookup, and the chunk
// dedup over uniq), or the dictionary row of each staged index's refs
// entry (the fused-decode lookup and chunk lookup over a rowdict pair).
// kUniq (dedup over uniq) and kTile (the chunk lookup over a resident
// tile) load as kIndexed does; each is a mode of its own so that its
// kernel is an instantiation of its own: dedup_kernel sharing
// lookup_kernel's (and with it the body's function-scope shared arrays)
// changed lookup_kernel's SASS and slowed it by up to 2% (PERF.md
// section 6). kHashed (the grouped lookup over a block table) loads as
// kIndexed does from indices it computes itself from the query's terms
// (split_stage_hashed); its cell is a (table entry, query) pair.
enum SplitSource { kRows, kIndexed, kDecoded, kUniq, kTile, kHashed };

// Block b of the grid: cluster rank b % cs, (cell, tile) pair b / cs. The
// block counts terms [lo, hi) of its cell (a cluster's ranks split the
// terms into near-equal ranges) into the tile's wn * 32 counts, which are
// out[(cell * Wo + w0) * 32 ...] and contiguous; Wo is W, but Wp with
// kAcc, whose running counts pad the word axis (word tiles are cut from
// Wp words, and a word >= W loads nothing). A staged source reads its
// indices and masks through s_idx and s_mask (two stages of kStageTerms).
// With kAcc each stored count adds the acc element of the same place,
// read once, by the thread that stores it: before the term loop without a
// cluster, at the store with one (acc and out do not overlap). With
// kHashed the cell is (entry e, query q) = (cell / queries, cell % queries)
// of `hb`: rows are entry e's tile, the indices and masks are computed from
// query q's terms, and the counts land at out[((q * blocks + slot) * W +
// w0) * 32 ...].
template <SplitSource kSrc, bool kAcc>
__device__ __forceinline__ void split_body(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ refs,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ mask,
    const int32_t* __restrict__ acc, int32_t* __restrict__ out, int L,
    int W, int Wp, int cs, int32_t (*s_idx)[kStageTerms],
    int32_t (*s_mask)[kStageTerms], HashedBatch hb = {}) {
  constexpr bool kStaged = kSrc != kRows;
  __shared__ uint32_t s_planes[kMaxPlanes * kSplitThreads];
  __shared__ int32_t s_red[kWordTile * 32];
  const int t = threadIdx.x;
  const int Wo = kAcc ? Wp : W;
  const SplitGeometry g = split_geometry(Wo);
  const int wt = g.wt, S = g.slices;
  const int s = t / wt, w = t % wt;
  const int rank = static_cast<int>(blockIdx.x % cs);
  const long long pair = blockIdx.x / cs;
  const long long cell = pair / g.tiles;
  const int w0 = static_cast<int>(pair % g.tiles) * wt;
  const int wn = Wo - w0 < wt ? Wo - w0 : wt;   // the tile's words
  // ... that load rows
  const int wc = kAcc && W - w0 < wn ? W - w0 : wn;
  // Without a cluster this thread stores counts e = t + k * 256 of the
  // tile; with kAcc it loads their acc elements now, so that the loads
  // overlap the staging.
  int32_t pre[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int e = t + k * kSplitThreads;
    pre[k] = 0;
    if constexpr (kAcc) {
      if (cs == 1 && e < wn * 32) pre[k] = acc[(cell * Wp + w0) * 32 + e];
    }
  }
  const long long per_rank = (static_cast<long long>(L) + cs - 1) / cs;
  const long long lo_ll = rank * per_rank < L ? rank * per_rank : L;
  const long long hi_ll = lo_ll + per_rank < L ? lo_ll + per_rank : L;
  const int lo = static_cast<int>(lo_ll), hi = static_cast<int>(hi_ll);
  const int np = planes_for((hi - lo + S - 1) / S);
  const bool counting = s < S && w < wc;
  long long oc = cell;              // the cell's place in out
  LookupBlock blk = {};
  const int32_t* terms = nullptr;
  int nv = 0;
  if constexpr (kSrc == kHashed) {
    const long long q = cell % hb.queries;
    blk = hb.table[cell / hb.queries];
    rows = blk.rows;
    oc = q * hb.blocks + blk.slot;
    terms = hb.terms + q * 2LL * L;
    nv = hb.n_valid != nullptr ? hb.n_valid[q] : L;
  }
  const uint32_t* col = kStaged ? rows + w0 + w
                                : rows + cell * L * W + w0 + w;
  const int32_t* ci = kStaged ? idx + cell * L : nullptr;
  const int32_t* cm = kStaged ? mask + cell * L : nullptr;

  uint32_t p[kMaxPlanes];
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) p[j] = 0u;
  int32_t own[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) own[k] = 0;

  if constexpr (kSrc == kHashed) {
    if (lo < hi) {
      split_stage_hashed(s_idx, s_mask, 0, terms, nv, blk, lo,
                         hi - lo < kStageTerms ? hi - lo : kStageTerms);
    }
  } else if constexpr (kStaged) {
    if (lo < hi) {
      split_stage(s_idx, s_mask, 0, ci, cm, lo,
                  hi - lo < kStageTerms ? hi - lo : kStageTerms);
    }
  }
  // dedup_kernel is launched as the gather's programmatic dependent: it may
  // start while the gather runs, so it stages its first indirections and
  // masks (which the gather does not write), then waits until the gather
  // grid has completed and its rows are visible, before any uniq row load
  // and any store
  if constexpr (kSrc == kUniq) grid_dependency_wait();
  int since = 0;  // the most terms a slice has added since the last flush
  int buf = 0;
  for (int st = lo; st < hi; st += kStageTerms, buf ^= 1) {
    const int n = hi - st < kStageTerms ? hi - st : kStageTerms;
    const int per_slice = (n + S - 1) / S;
    if (since + per_slice > kFlushTerms) {
      split_flush(p, own, s_planes, np, S, wt, wn);
      since = 0;
    }
    if constexpr (kStaged) {
      const int next = st + kStageTerms;
      if (next < hi) {
        if constexpr (kSrc == kHashed) {
          split_stage_hashed(s_idx, s_mask, buf ^ 1, terms, nv, blk, next,
                             hi - next < kStageTerms ? hi - next
                                                     : kStageTerms);
        } else {
          split_stage(s_idx, s_mask, buf ^ 1, ci, cm, next,
                      hi - next < kStageTerms ? hi - next : kStageTerms);
        }
      } else {
        cp_async_commit();
      }
      cp_async_wait_prior();
      if constexpr (kSrc == kDecoded) {
        split_decode(s_idx[buf], s_mask[buf], refs, n);
      }
      __syncthreads();
    }
    if (counting) {
      for (int b = s; b < n; b += S * kUnroll) {
        uint32_t v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int l = b + u * S;
          v[u] = 0u;
          if (l < n) {
            if constexpr (kStaged) {
              if (s_mask[buf][l] != 0) {
                v[u] = col[static_cast<long long>(s_idx[buf][l]) * W];
              }
            } else {
              v[u] = col[static_cast<long long>(st + l) * W];
            }
          }
        }
        ripple_step(p, v, np);
      }
    }
    since += per_slice;
    if constexpr (kStaged) __syncthreads();  // this stage is restaged next
  }
  split_flush(p, own, s_planes, np, S, wt, wn);

  int32_t* out_tile = out + (oc * Wo + w0) * 32;
  if (cs == 1) {
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int e = t + k * kSplitThreads;
      if (e < wn * 32) out_tile[e] = own[k] + pre[k];
    }
    return;
  }
  // A cluster: every rank's counts into its shared memory, then rank r
  // sums share r of the tile over the cluster and stores it.
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int e = t + k * kSplitThreads;
    if (e < wn * 32) s_red[e] = own[k];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (wn * 32 + cs - 1) / cs;
  const int end = wn * 32 < (rank + 1) * share ? wn * 32 : (rank + 1) * share;
  for (int e = rank * share + t; e < end; e += kSplitThreads) {
    int32_t c = 0;
    if constexpr (kAcc) c = acc[(cell * Wp + w0) * 32 + e];
    for (int q = 0; q < cs; ++q) {
      c += cluster.map_shared_rank(&s_red[0], q)[e];
    }
    out_tile[e] = c;
  }
  cluster.sync();  // no block leaves while another reads its counts
}

// Replaces _vertical_kernel (vertical_score): rows [B, L, W] -> [B, W, 32].
// Bound on this card: bytes (each row read once) and, at the main path's
// few cells, the latency of the row loads; the split body keeps 8 row
// loads in flight per thread over 256 threads per (cell, word tile),
// coalesced along the rows, and a cluster splits the rows of a lone cell.
__global__ void __launch_bounds__(kSplitThreads)
vertical_kernel(const uint32_t* __restrict__ rows, int32_t* __restrict__ out,
                int L, int W, int cs) {
  split_body<kRows, false>(rows, nullptr, nullptr, nullptr, nullptr, out, L,
                           W, W, cs, nullptr, nullptr);
}

// Replaces _lookup_kernel, _lookup_blocks_kernel and _lookup_multi_kernel
// (lookup_score, lookup_score_blocks, lookup_score_multi): arena [R, W],
// idx and mask [cells, L] -> [cells, W, 32]; a term counts where its mask
// is non-zero. Bound: bytes (indices, masks, one row per counted term,
// the counts) and, in practice, the index -> row chain of dependent loads;
// the indices are staged in shared memory with cp.async, double-buffered,
// so each slice's row loads (8 in flight) depend on shared memory only.
__global__ void __launch_bounds__(kSplitThreads)
lookup_kernel(const uint32_t* __restrict__ arena,
              const int32_t* __restrict__ idx,
              const int32_t* __restrict__ mask, int32_t* __restrict__ out,
              int L, int W, int cs) {
  __shared__ int32_t s_idx[2][kStageTerms];
  __shared__ int32_t s_mask[2][kStageTerms];
  split_body<kIndexed, false>(arena, nullptr, idx, mask, nullptr, out, L, W,
                              W, cs, s_idx, s_mask);
}

// Replaces _lookup_blocks_comp_kernel and _lookup_multi_comp_kernel
// (lookup_score_blocks_compressed, lookup_score_multi_compressed): the
// fused lookup over a rowdict pair (dict [D, W], refs [R]), reading row r
// as dict[refs[r]]; idx and mask [cells, L] -> [cells, W, 32]. Bound:
// bytes (indices, masks, one refs entry and one dictionary row per counted
// term, the counts) and, in practice, the idx -> refs -> row chain of
// dependent loads. The split body stages the indices with cp.async and
// resolves their refs entries while the stage lands (split_decode: all
// 256 threads, 4 loads each in flight), so each slice's row loads stay one
// shared-memory read away, as in lookup_kernel.
__global__ void __launch_bounds__(kSplitThreads)
lookup_comp_kernel(const uint32_t* __restrict__ dict,
                   const int32_t* __restrict__ refs,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ mask,
                   int32_t* __restrict__ out, int L, int W, int cs) {
  __shared__ int32_t s_idx[2][kStageTerms];
  __shared__ int32_t s_mask[2][kStageTerms];
  split_body<kDecoded, false>(dict, refs, idx, mask, nullptr, out, L, W, W,
                              cs, s_idx, s_mask);
}

// Replaces _chunk_multi_kernel (chunk_lookup_score_multi): one term chunk
// of the pruned and bulk executors, fused-gathered from a resident raw tile
// (arena [R, W], idx and mask [cells, L]) and added into the running
// counts: out = acc + counts, both [cells, Wp, 32]. Bound: bytes (indices,
// masks, each distinct arena row the live terms touch, acc read once, out
// written once) and, in practice, latency: at the bulk sweep's chunk (L =
// 32, W = Wp = 32, 256 cells) the rows come from an arena far larger than
// L2, so a launch is one staging round trip, one round trip of row loads
// from device memory and the cross-slice sum. The split body in its
// accumulate mode, as chunk_dedup_kernel (a source mode of its own, kTile,
// so that chunk_dedup_kernel keeps its SASS): indices staged with
// cp.async, 8 row loads in flight a thread, acc loaded by the storing
// thread before the term loop; any L in one launch. At that chunk (256
// blocks, no cluster, 8 slices of 4 terms) on one H100 80GB HBM3 at 700 W:
// 5.4-5.6 us against a byte bound of 0.90 us (chip_smoke.py, the sweep's
// own chunks; tools/split_probe.py, random inputs of that shape: 5.4-5.5);
// the serial body it replaced (one thread per (cell, word) walking every
// term in order with 16 counter planes, 64 blocks of 128 threads) took
// 22.0-22.3 us there.
__global__ void __launch_bounds__(kSplitThreads)
chunk_lookup_kernel(const uint32_t* __restrict__ arena,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ mask,
                    const int32_t* __restrict__ acc,
                    int32_t* __restrict__ out, int L, int W, int Wp,
                    int cs) {
  __shared__ int32_t s_idx[2][kStageTerms];
  __shared__ int32_t s_mask[2][kStageTerms];
  split_body<kTile, true>(arena, nullptr, idx, mask, acc, out, L, W, Wp, cs,
                          s_idx, s_mask);
}

// Replaces _chunk_multi_comp_kernel (chunk_lookup_score_multi_compressed):
// chunk_lookup_kernel over a resident rowdict pair (dict [D, W], refs [R]),
// reading row r as dict[refs[r]]. Bound: bytes (indices, masks, each
// distinct refs entry and dictionary row the live terms touch, acc read
// once, out written once) and, in practice, the idx -> refs -> row chain.
// The split body's decoded mode with accumulate: each stage's indices are
// replaced by their refs entries while the stage lands (split_decode), as
// in lookup_comp_kernel. Dictionary rows have stride W and the running
// counts stride Wp; the word tile is cut from Wp, and a word in [W, Wp)
// loads nothing and only carries its acc into out. At the rowdict store's
// tallest shard (idx [128, 1, 32], W = 4, Wp = 8: 128 blocks, no cluster,
// word tile 8, 32 slices of one term) on one H100 80GB HBM3 at 700 W:
// 3.3-3.4 us against a byte bound of 0.095 us (chip_smoke.py, the sweep's
// own chunks; tools/split_probe.py, random inputs of that shape: 3.2); the
// serial body it replaced took 27.7-28.6 us there. A tile cut from W
// instead (64 slices, half of them without a term at L = 32, the padding
// words' acc carried by the same block) took 3.5-3.6 us in the probe, so
// half of the block's threads keep holding padding words.
__global__ void __launch_bounds__(kSplitThreads)
chunk_lookup_comp_kernel(const uint32_t* __restrict__ dict,
                         const int32_t* __restrict__ refs,
                         const int32_t* __restrict__ idx,
                         const int32_t* __restrict__ mask,
                         const int32_t* __restrict__ acc,
                         int32_t* __restrict__ out, int L, int W, int Wp,
                         int cs) {
  __shared__ int32_t s_idx[2][kStageTerms];
  __shared__ int32_t s_mask[2][kStageTerms];
  split_body<kDecoded, true>(dict, refs, idx, mask, acc, out, L, W, Wp, cs,
                             s_idx, s_mask);
}

// Replaces _chunk_dedup_kernel (chunk_dedup_score): one term chunk read
// through indir [cells, L] from a unique-row matrix uniq [U, W]
// (host-gathered rows, or device-gathered and ANDed row sets for k > 1),
// added into the running counts: out = acc + counts, both [cells, Wp, 32].
// Bound: bytes (indirections, masks, each distinct uniq row the live terms
// touch, acc read once, out written once) and, in practice, latency: at
// the pruned path's chunk (L = 32, W = Wp = 8, 32 cells) a launch is one
// staging round trip, one row load and the cross-slice sum. The split body
// in its accumulate mode: the indirections are staged as lookup_kernel's
// indices are, and (without a cluster, as at that shape) each thread loads
// the acc elements it will store before the term loop, so their latency
// overlaps the staging. Geometry at that shape (tools/split_probe.py, one
// H100 80GB HBM3 at 700 W, synthetic inputs of that shape): the
// geometry's 32 slices of one term each, 32 blocks, 2.80 us; 16 slices
// 2.97 us and 8 slices 3.09 us (copies of this source with the slice count
// capped), and 4.14-4.30 us at a cluster of 2 for each. So the kernel keeps
// the geometry's 256 / Wt slices. The serial body it replaced took
// 22.87 us there: 10.24 us at one term (5.56 us without acc, so about
// 4.7 us of acc loads issued one after another after the barrier) and
// 0.42 us a term; the split body takes 2.81 us at one term and 0.01 us a
// term.
__global__ void __launch_bounds__(kSplitThreads)
chunk_dedup_kernel(const uint32_t* __restrict__ uniq,
                   const int32_t* __restrict__ indir,
                   const int32_t* __restrict__ mask,
                   const int32_t* __restrict__ acc,
                   int32_t* __restrict__ out, int L, int W, int Wp,
                   int cs) {
  __shared__ int32_t s_idx[2][kStageTerms];
  __shared__ int32_t s_mask[2][kStageTerms];
  split_body<kIndexed, true>(uniq, nullptr, indir, mask, acc, out, L, W, Wp,
                             cs, s_idx, s_mask);
}

// Replaces _dedup_score_kernel (dedup_score): lookup_kernel's body over the
// unique-row matrix uniq [U, W] of the row-dedup pair, indir and mask
// [cells, L] indexing uniq's rows -> [cells, W, 32]. Bound: bytes
// (indirections, masks, each distinct uniq row the live terms touch, the
// counts written) and, in practice, the indir -> row chain of dependent
// loads, as in lookup_kernel: the same split body (indirections staged
// with cp.async, 8 row loads in flight per thread, slices summed through
// shared memory into one coalesced store, a cluster where a launch has
// few (cell, tile) pairs), any L in one launch. The uniq matrix of a read
// batch (about 2,000 rows of 128 bytes) sits in L2, where each block
// re-reads its rows. At the dense read batch (indir [32, 2, 128], uniq
// [2048, 32]; 128 blocks in clusters of 2) on one H100 80GB HBM3 at 700 W
// (chip_smoke.py): 7.1-7.2 us against a byte bound of 0.17 us; the
// serial body it replaced (one thread per (cell, word) walking every
// term in order) took 46.4-46.9 us there. It is launched as the
// programmatic dependent of the kernel before it (the pair's gather,
// which releases it once its row loads are issued): its blocks stage
// their first indirections while the gather runs and wait for the gather
// to complete before they read uniq (kUniq's grid_dependency_wait). On
// that card (tools/split_probe.py, random inputs of the batch's shape) the
// pair took 8.22-8.36 us against 8.30-8.33 launched plainly, and dedup
// launches back to back (each the dependent of the one before, which
// releases it only as it ends) 6.52-6.72 against 6.75-6.94.
__global__ void __launch_bounds__(kSplitThreads)
dedup_kernel(const uint32_t* __restrict__ uniq,
             const int32_t* __restrict__ indir,
             const int32_t* __restrict__ mask, int32_t* __restrict__ out,
             int L, int W, int cs) {
  __shared__ int32_t s_idx[2][kStageTerms];
  __shared__ int32_t s_mask[2][kStageTerms];
  split_body<kUniq, false>(uniq, nullptr, indir, mask, nullptr, out, L, W, W,
                           cs, s_idx, s_mask);
}

// Replaces no Pallas kernel: lookup_kernel's grouped form
// (lookup_score_grouped), which scores every block of a block table for
// every query of a batch in one launch, where the JAX engine runs one
// lookup a shard after hashing and planning on the host side of the
// launch. Each entry of the table is a block of some resident tile (its
// rows pointer, row offset, width and slot); each (entry, query, word
// tile) is a block of threads of the split body in kHashed mode, which
// computes each term's row as it stages the query's terms (term_hash,
// modulo the block's width, plus its offset; mask l < n_valid[q], 0 or 1)
// and writes the counts into the batch's [Q, blocks, W, 32] buffer at the
// entry's slot. Bound: bytes (the terms read once a cell, one row per live
// term, the counts written) and, in practice, the chain table entry ->
// terms -> row of dependent loads. It keeps the name lookup_kernel, in a
// namespace of its own (so that the indexed form's name stays one
// function), and with it the profiler's scoring-kernel pattern.
namespace grouped {
__global__ void __launch_bounds__(kSplitThreads)
lookup_kernel(HashedBatch hb, int32_t* __restrict__ out, int L, int W,
              int cs) {
  __shared__ int32_t s_idx[2][kStageTerms];
  __shared__ int32_t s_mask[2][kStageTerms];
  split_body<kHashed, false>(nullptr, nullptr, nullptr, nullptr, nullptr,
                             out, L, W, W, cs, s_idx, s_mask, hb);
}
}  // namespace grouped

// Replaces _unpack_kernel (unpack_score): rows [B, L, W] -> [B, W, 32], each
// count an int32 that adds (word >> bit) & 1 over the L rows (the TPU
// kernel's 32-way expansion; no counter planes, so nothing to expand at
// the end and no 65,535-term flush: any L runs in one launch). Bound:
// bytes (each row read once, the counts written once; well under a
// microsecond at the planner's shapes) and, in practice, the latency of
// the row loads. One block of kUnpackWarps warps per (cell, word): lane b
// of a warp counts bit b, so each row load is one 4-byte broadcast to the
// warp; warp s takes the term slice s, s + kUnpackWarps, ... and keeps
// kUnroll row loads in flight. The warps' 32 counts are summed in shared
// memory and stored as one 128-byte line. A lone cell at W = 64 is 64
// blocks; where a launch has few (cell, word) pairs and each warp would
// keep at least 4 steps of loads, a cluster of 2-8 blocks splits the
// word's terms and rank 0 sums the cluster's counts over distributed
// shared memory. On one H100 80GB HBM3 at 700 W (chip_smoke.py): rows
// [320, 64] 3.65-3.66 us, rows [64, 64] (a short singleton) 2.2-2.3 us,
// against byte bounds of 0.027 and 0.007 us; the thread-per-(cell, word,
// bit) body it replaced took 11.6-11.8 us at [320, 64]. 4 warps a word
// took 5.0 and 2.1 us, 16 warps 3.0 and 2.0, a cluster of 2 at these 64
// pairs 0.4-1.2 us more (tools/split_probe.py).
__global__ void __launch_bounds__(kUnpackWarps * 32)
unpack_kernel(const uint32_t* __restrict__ rows, int32_t* __restrict__ out,
              int L, int W, int cs) {
  __shared__ int32_t s_red[kUnpackWarps * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(blockIdx.x % cs);
  const long long item = blockIdx.x / cs;          // (cell, word)
  const long long cell = item / W;
  const int w = static_cast<int>(item % W);
  const long long per_rank = (static_cast<long long>(L) + cs - 1) / cs;
  const long long lo_ll = rank * per_rank < L ? rank * per_rank : L;
  const long long hi_ll = lo_ll + per_rank < L ? lo_ll + per_rank : L;
  const int lo = static_cast<int>(lo_ll), hi = static_cast<int>(hi_ll);
  const uint32_t* col = rows + cell * L * W + w;
  int32_t c = 0;
  for (int b = lo + warp; b < hi; b += kUnpackWarps * kUnroll) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = b + u * kUnpackWarps;
      v[u] = l < hi ? col[static_cast<long long>(l) * W] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      c += static_cast<int32_t>((v[u] >> lane) & 1u);
    }
  }
  s_red[warp * 32 + lane] = c;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 1; q < kUnpackWarps; ++q) c += s_red[q * 32 + lane];
  }
  if (cs == 1) {
    if (warp == 0) out[item * 32 + lane] = c;
    return;
  }
  // A cluster: each rank's 32 counts in its s_red[0..31] (only warp 0
  // reads or writes s_red after the barrier), then rank 0 sums them over
  // the cluster and stores the line.
  if (warp == 0) s_red[lane] = c;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0 && warp == 0) {
    int32_t t = 0;
    for (int q = 0; q < cs; ++q) {
      t += cluster.map_shared_rank(&s_red[0], q)[lane];
    }
    out[item * 32 + lane] = t;
  }
  cluster.sync();  // no block leaves while rank 0 reads its counts
}

// The gather body's vectors: kVec words (16, 8 or 4 bytes) a load and a
// store, and their AND.
template <int kVec> struct GatherVec;
template <> struct GatherVec<4> {
  using T = uint4;
  static __device__ __forceinline__ T ones() {
    return make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  static __device__ __forceinline__ T band(T a, T b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  }
};
template <> struct GatherVec<2> {
  using T = uint2;
  static __device__ __forceinline__ T ones() { return make_uint2(~0u, ~0u); }
  static __device__ __forceinline__ T band(T a, T b) {
    return make_uint2(a.x & b.x, a.y & b.y);
  }
};
template <> struct GatherVec<1> {
  using T = uint32_t;
  static __device__ __forceinline__ T ones() { return ~0u; }
  static __device__ __forceinline__ T band(T a, T b) { return a & b; }
};

// Unique-row gather: out row u is the AND of the k rows uniq_idx[u * k ..
// u * k + k - 1] (k = 1: a copy); with kDecode row r is read as
// rows[refs[r]]. Block b takes the row sets [32b, 32b + 32) and each of its
// warps resolves all 32: lane j loads the indices of set 32b + j (and with
// kDecode their refs entries, all in flight at once), one round trip a
// level of the index chain for 32 rows. The block's warps then split the
// sets' rows, moved as vectors of kVec words: lpr = min(W / kVec, 32) lanes
// a row, 32 / lpr rows a warp-step (at W = 32 and kVec = 4, 8 lanes a row
// and 4 rows an instruction; at W = 4 a lane a row), each row's source
// rows broadcast from the lane that resolved them (__shfl_sync). A lane
// issues the loads of up to kGatherInFlight vectors and of every one of
// their up to kGatherRows rows before the first AND, then stores each
// vector once. A set of more than kGatherRows rows is ANDed in rounds,
// each later round reading back what the lane stored in the one before
// (uniq_idx and out do not overlap). Once a warp has issued its first
// loads, its threads release the dependent launch (dedup_kernel).
template <bool kDecode, int kVec>
__device__ __forceinline__ void gather_body(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ refs,
    const int32_t* __restrict__ uniq_idx, uint32_t* __restrict__ out, int U,
    int k, int W) {
  using Vec = GatherVec<kVec>;
  using V = typename Vec::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long u0 = static_cast<long long>(blockIdx.x) * kGatherSets;
  const int n = U - u0 < kGatherSets ? static_cast<int>(U - u0)
                                     : kGatherSets;   // sets of the block
  const int vpr = W / kVec;                 // vectors a row
  const int lpr = vpr < 32 ? vpr : 32;      // lanes a row
  const int rps = 32 / lpr;                 // rows a warp-step
  const int lr = lane / lpr, lc = lane - lr * lpr;
  const int cpl = (vpr + lpr - 1) / lpr;    // vectors a lane moves of a row
  const int step = rps * static_cast<int>(blockDim.x >> 5);
  const V* src = reinterpret_cast<const V*>(rows);
  V* dst = reinterpret_cast<V*>(out) + u0 * vpr;
  const int32_t* set = uniq_idx + (u0 + lane) * k;
  bool triggered = false;
  for (int h0 = 0; h0 < k; h0 += kGatherRows) {
    const int kh = k - h0 < kGatherRows ? k - h0 : kGatherRows;
    int r[kGatherRows];
#pragma unroll
    for (int i = 0; i < kGatherRows; ++i) {
      r[i] = lane < n && i < kh ? set[h0 + i] : 0;
    }
    if constexpr (kDecode) {
#pragma unroll
      for (int i = 0; i < kGatherRows; ++i) {
        if (lane < n && i < kh) r[i] = refs[r[i]];
      }
    }
    // this lane's vectors: of rows s = rps * warp + step * m + lr (a lane
    // past 32 / lpr rows moves none), vectors c = lc + lpr * j < vpr
    int m = 0, j = 0;
    while (rps * warp + step * m < n) {            // uniform in the warp
      V x[kGatherInFlight][kGatherRows];
      long long at[kGatherInFlight];
      int q = 0;
#pragma unroll
      for (; q < kGatherInFlight; ++q) {
        const int s = rps * warp + step * m + lr;
        if (s - lr >= n) break;                    // uniform in the warp
        const int c = lc + lpr * j;
        const bool ok = lr < rps && s < n && c < vpr;
        at[q] = ok ? static_cast<long long>(s) * vpr + c : -1;
#pragma unroll
        for (int i = 0; i < kGatherRows; ++i) {
          x[q][i] = Vec::ones();
          if (i < kh) {                            // uniform in the warp
            const long long ri = __shfl_sync(0xffffffffu, r[i], s & 31);
            if (ok) x[q][i] = src[ri * vpr + c];
          }
        }
        if (++j == cpl) {
          j = 0;
          ++m;
        }
      }
      if (!triggered) {
        grid_dependents_launch();
        triggered = true;
      }
#pragma unroll
      for (int p = 0; p < kGatherInFlight; ++p) {
        if (p < q && at[p] >= 0) {
          V v = h0 > 0 ? dst[at[p]] : Vec::ones();
#pragma unroll
          for (int i = 0; i < kGatherRows; ++i) v = Vec::band(v, x[p][i]);
          dst[at[p]] = v;
        }
      }
    }
  }
}

// Replaces _gather_kernel (gather_rows): arena [R, W], uniq_idx [U, k]
// (k = 1 for a flat [U] list) -> out [U, W]. Bound: bytes (U * k indices,
// the rows read, U rows written) and, at the served shapes, the index ->
// row chain and the launch; the gather body resolves a warp's 32 indices
// in one round trip and moves the rows as kVec-word vectors. At the dense
// read batch (uniq_idx [2048], arena [3,813,888, 32]: 64 blocks of 8
// warps, 16-byte vectors, a row a warp-step of 4 rows per warp) on one
// H100 80GB HBM3 at 700 W (tools/split_probe.py, random indices):
// 1.60-1.62 us against a byte bound of 0.15 us; the thread-a-word body it
// replaced took 1.57-1.61 us there. Warps taking 2, 4 and 8 warp-steps
// each (4, 2, 1 warps a block) took 1.74-1.81, 2.12-2.16 and 3.03-3.11 us;
// a first body with one warp per 32 sets and 8 vectors a lane 4.1 us.
template <int kVec>
__global__ void __launch_bounds__(kGatherMaxWarps * 32)
gather_kernel(const uint32_t* __restrict__ arena,
              const int32_t* __restrict__ uniq_idx,
              uint32_t* __restrict__ out, int U, int k, int W) {
  gather_body<false, kVec>(arena, nullptr, uniq_idx, out, U, k, W);
}

// Replaces the kernel of gather_rows_compressed: the same over a rowdict
// pair (dict [D, W], refs [R]), reading row r as dict[refs[r]]. Bound:
// bytes (indices, one refs entry and one dictionary row per listed row,
// U rows written) and the idx -> refs -> row chain, whose two index levels
// the body resolves for 32 rows at once. At the rowdict store's tallest
// shard (uniq_idx [1024], dict [16384, 4], refs [3,649,024]: 32 blocks of
// one warp, a lane a 16-byte row) on one H100 80GB HBM3 at 700 W
// (tools/split_probe.py): 1.66-1.71 us against a byte bound of 0.009 us;
// the thread-a-word body it replaced took 1.59-1.66 us there. Releasing
// dedup_kernel as the gather starts instead of after its row loads made
// the dense read batch's pair slower: 9.19-9.25 us against 8.26-8.31.
template <int kVec>
__global__ void __launch_bounds__(kGatherMaxWarps * 32)
gather_comp_kernel(const uint32_t* __restrict__ dict,
                   const int32_t* __restrict__ refs,
                   const int32_t* __restrict__ uniq_idx,
                   uint32_t* __restrict__ out, int U, int k, int W) {
  gather_body<true, kVec>(dict, refs, uniq_idx, out, U, k, W);
}

// Launch a gather over U row sets of k rows of W words: a block per 32
// sets (the last holds the rest), as many warps as its rows need at
// kGatherSteps warp-steps a warp, and the widest vector that W and both
// row pointers allow (16 bytes, else 8, else 4).
template <bool kDecode>
int launch_gather(const uint32_t* rows, const int32_t* refs,
                  const int32_t* uniq_idx, uint32_t* out, int U, int k,
                  int W, void* stream) {
  if (U < 1 || k < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t at = reinterpret_cast<uintptr_t>(rows)
                       | reinterpret_cast<uintptr_t>(out);
  const int vec = W % 4 == 0 && at % 16 == 0 ? 4
                  : W % 2 == 0 && at % 8 == 0 ? 2 : 1;
  const int vpr = W / vec, lpr = vpr < 32 ? vpr : 32, rps = 32 / lpr;
  const int sets = U < kGatherSets ? U : kGatherSets;
  const int steps = (sets + rps - 1) / rps * ((vpr + lpr - 1) / lpr);
  int warps = (steps + kGatherSteps - 1) / kGatherSteps;
  warps = warps < kGatherMaxWarps ? warps : kGatherMaxWarps;
  const dim3 grid(static_cast<unsigned int>(
      (static_cast<long long>(U) + kGatherSets - 1) / kGatherSets));
  const dim3 block(static_cast<unsigned int>(warps * 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    if constexpr (kDecode) {
      gather_comp_kernel<4><<<grid, block, 0, st>>>(rows, refs, uniq_idx,
                                                    out, U, k, W);
    } else {
      gather_kernel<4><<<grid, block, 0, st>>>(rows, uniq_idx, out, U, k, W);
    }
  } else if (vec == 2) {
    if constexpr (kDecode) {
      gather_comp_kernel<2><<<grid, block, 0, st>>>(rows, refs, uniq_idx,
                                                    out, U, k, W);
    } else {
      gather_kernel<2><<<grid, block, 0, st>>>(rows, uniq_idx, out, U, k, W);
    }
  } else {
    if constexpr (kDecode) {
      gather_comp_kernel<1><<<grid, block, 0, st>>>(rows, refs, uniq_idx,
                                                    out, U, k, W);
    } else {
      gather_kernel<1><<<grid, block, 0, st>>>(rows, uniq_idx, out, U, k, W);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The cluster size a split launch uses: `cluster` when it is 1-8, else
// (0) the largest of 1, 2, 4, 8 that keeps the grid within one block per
// SM and at least `min_terms` terms per slice.
int split_cluster(long long pairs, int L, int slices, int min_terms,
                  int cluster, int device) {
  if (cluster > 0) return cluster;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
      != cudaSuccess) {
    sms = 132;
  }
  int cs = 1;
  while (cs < kMaxCluster && pairs * cs * 2 <= sms
         && static_cast<long long>(L) >= 2LL * cs * slices * min_terms) {
    cs *= 2;
  }
  return cs;
}

// Launch `kernel` as pairs * cs blocks of `threads`, in clusters of cs (the
// cluster size split_cluster picks for `slices` term slices a block of at
// least `min_terms` terms each). With kProgrammatic the launch also allows
// programmatic stream serialization: the kernel may begin once the kernel
// before it on the stream has triggered its dependents, and must wait
// (grid_dependency_wait) before it reads what that kernel writes. The
// launch fails, and is not retried without it, if the driver refuses it.
template <bool kProgrammatic = false, typename Kernel, typename... Args>
int launch_clustered(Kernel kernel, long long pairs, int L, int slices,
                     int min_terms, int threads, int cluster, int device,
                     void* stream, Args... args) {
  const int cs = split_cluster(pairs, L, slices, min_terms, cluster, device);
  if (cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) != 0
      || pairs * cs > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(pairs * cs));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  unsigned int n = 0;
  if (cs > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cs;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if constexpr (kProgrammatic) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  // the kernel's last argument is the cluster size it was launched with
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A split-body kernel over `cells` cells of L terms and Wo output words
// (kProgrammatic as for launch_clustered: dedup_kernel's alone).
template <bool kProgrammatic = false, typename Kernel, typename... Args>
int launch_split(Kernel kernel, long long cells, int L, int Wo, int cluster,
                 int device, void* stream, Args... args) {
  const SplitGeometry g = split_geometry(Wo);
  return launch_clustered<kProgrammatic>(
      kernel, cells * g.tiles, L, g.slices, kMinSliceTerms, kSplitThreads,
      cluster, device, stream, args...);
}

// ---------------------------------------------------------------------------
// The selection of a dense batch's hits
// ---------------------------------------------------------------------------

constexpr int kSelectThreads = 1024;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kSelectUnroll = 8;   // documents a thread takes a tile
constexpr int kSelectTile = kSelectThreads * kSelectUnroll;
// a lane's share of the tile's (step, warp) counts in the block's scan
constexpr int kSelectScan = kSelectUnroll * kSelectWarps / 32;

// Replaces no Pallas kernel: the JAX server copies a batch's [Q, n_slots]
// scores to the host and selects there (slot order to document order,
// the coverage cutoff, the hits). This kernel does the first two and
// compacts the hits on the card, so the host receives hit lists:
// scores [>= Q, ld] in slot order, doc_slot [n_docs], cut [Q] ->
// out [Q, 1 + 2 * cap]: out[q, 0] the number of documents d with
// scores[q, doc_slot[d]] >= cut[q], then the first min(that, cap) of
// them as (d, score) pairs in ascending d, then zeros. One block per
// query walks the documents in tiles of kSelectTile: thread t takes
// documents tile + u * kSelectThreads + t (u < kSelectUnroll), so each
// warp's doc_slot loads are coalesced, all kUnroll slot loads and then
// all score loads of a tile are in flight at once, and (step, warp,
// lane) is document order. A warp ballot and popcount rank each hit in
// its warp; one warp scans the tile's (step, warp) counts in shared
// memory, and each hit is stored at its rank. Bound: bytes (doc_slot
// read once, Q * n_docs scores read once, the hit lists written); at the
// served batch ([32, 34,816] scores, 34,134 documents, cap 1,024) 4.5 MB,
// 1.35 us at 3.35 TB/s. In practice a block's chain of dependent steps:
// two loads and two barriers a tile, 5 tiles at that width.
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const int32_t* __restrict__ scores, int ld,
              const int32_t* __restrict__ doc_slot,
              const int32_t* __restrict__ cut, int n_docs, int cap,
              int32_t* __restrict__ out) {
  __shared__ int s_rank[kSelectUnroll * kSelectWarps];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int32_t* row = scores + static_cast<long long>(blockIdx.x) * ld;
  int32_t* dst = out + static_cast<long long>(blockIdx.x) * (1 + 2LL * cap);
  const int c = cut[blockIdx.x];
  int found = 0;   // hits in the tiles before this one
  for (int t0 = 0; t0 < n_docs; t0 += kSelectTile) {
    int slot[kSelectUnroll], s[kSelectUnroll];
#pragma unroll
    for (int u = 0; u < kSelectUnroll; ++u) {
      const int d = t0 + u * kSelectThreads + threadIdx.x;
      slot[u] = d < n_docs ? doc_slot[d] : -1;
    }
#pragma unroll
    for (int u = 0; u < kSelectUnroll; ++u) {
      s[u] = slot[u] >= 0 ? row[slot[u]] : 0;
    }
    unsigned hit[kSelectUnroll];
#pragma unroll
    for (int u = 0; u < kSelectUnroll; ++u) {
      hit[u] = __ballot_sync(0xffffffffu, slot[u] >= 0 && s[u] >= c);
      if (lane == 0) s_rank[u * kSelectWarps + warp] = __popc(hit[u]);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the tile's counts in (step, warp) order
      int v[kSelectScan], sum = 0;
#pragma unroll
      for (int i = 0; i < kSelectScan; ++i) {
        v[i] = s_rank[lane * kSelectScan + i];
        sum += v[i];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      int run = found + incl - sum;
#pragma unroll
      for (int i = 0; i < kSelectScan; ++i) {
        s_rank[lane * kSelectScan + i] = run;
        run += v[i];
      }
      if (lane == 31) s_tile = incl;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSelectUnroll; ++u) {
      if ((hit[u] >> lane) & 1u) {
        const int at = s_rank[u * kSelectWarps + warp]
                       + __popc(hit[u] & below);
        if (at < cap) {
          dst[1 + 2 * at] = t0 + u * kSelectThreads + threadIdx.x;
          dst[2 + 2 * at] = s[u];
        }
      }
    }
    found += s_tile;
    __syncthreads();   // s_rank and s_tile are the next tile's
  }
  for (int i = 2 * (found < cap ? found : cap) + threadIdx.x; i < 2 * cap;
       i += kSelectThreads) {
    dst[1 + i] = 0;
  }
  if (threadIdx.x == 0) dst[0] = found;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() (0 = launched). The wrappers in bitslice_score.py
// validate shapes, types and index ranges before calling.

// unpack_kernel takes any L in one launch, one block (or cluster) per
// (cell, word); `cluster` as for the split kernels below.
extern "C" int cobs_unpack(const void* rows, void* out, int B, int L, int W,
                           int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_clustered(
      unpack_kernel, static_cast<long long>(B) * W, L, kUnpackWarps,
      kUnpackMinSliceTerms, kUnpackWarps * 32, cluster, device, stream,
      static_cast<const uint32_t*>(rows), static_cast<int32_t*>(out), L, W);
}

// The split kernels take any L in one launch; `cluster` is the cluster
// size (1, 2, 4 or 8 blocks per (cell, word tile)), or 0 to let
// split_cluster choose.
extern "C" int cobs_vertical(const void* rows, void* out, int B, int L,
                             int W, int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_split(
      vertical_kernel, B, L, W, cluster, device, stream,
      static_cast<const uint32_t*>(rows), static_cast<int32_t*>(out), L, W);
}

extern "C" int cobs_lookup(const void* arena, const void* idx,
                           const void* mask, void* out, int cells, int L,
                           int W, int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_split(
      lookup_kernel, cells, L, W, cluster, device, stream,
      static_cast<const uint32_t*>(arena), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(mask), static_cast<int32_t*>(out), L, W);
}

extern "C" int cobs_lookup_comp(const void* dict, const void* refs,
                                const void* idx, const void* mask, void* out,
                                int cells, int L, int W, int cluster,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_split(lookup_comp_kernel, cells, L, W, cluster, device,
                      stream, static_cast<const uint32_t*>(dict),
                      static_cast<const int32_t*>(refs),
                      static_cast<const int32_t*>(idx),
                      static_cast<const int32_t*>(mask),
                      static_cast<int32_t*>(out), L, W);
}

// The grouped lookup: table [n_entries] LookupBlock entries on the device,
// terms [Q, L, 2], n_valid [Q] (null: every term of L counts), out
// [Q, n_blocks, W, 32]; writes the table's blocks of out and no other, one
// launch for the n_entries * Q cells at any L, at the cluster size the
// entry point picks (as cobs_lookup's). The table's rows are in range by
// construction (row_offset + width never passes a tile's rows).
extern "C" int cobs_lookup_grouped(const void* table, int n_entries,
                                   const void* terms, const void* n_valid,
                                   void* out, int Q, int n_blocks, int L,
                                   int W, int cluster, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries < 1 || Q < 1 || n_blocks < 1 || L < 0 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HashedBatch hb = {static_cast<const LookupBlock*>(table),
                          static_cast<const int32_t*>(terms),
                          static_cast<const int32_t*>(n_valid), Q, n_blocks};
  return launch_split(grouped::lookup_kernel,
                      static_cast<long long>(n_entries) * Q, L, W, cluster,
                      device, stream, hb, static_cast<int32_t*>(out), L, W);
}

// What a split launch of `cells` cells of L terms over W words (a chunk
// kernel's over its Wp running-count words) runs as: info[0..8] = blocks,
// threads per block, cluster size, word tile, slices, counter planes a
// slice uses, static shared memory bytes, registers per thread, and the
// cluster sizes the kernel may take (its max). `kernel` names the kernel:
// "vertical", "lookup", "lookup_comp", "chunk_lookup", "chunk_lookup_comp",
// "chunk_dedup", "dedup" or "unpack" (one word a block, a slice a warp, no
// counter planes: 0).
extern "C" int cobs_split_info(const char* kernel, int cells, int L, int W,
                               int Wp, int cluster, int device, void* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  int Wo = W;
  const bool unpack = std::strcmp(kernel, "unpack") == 0;
  if (std::strcmp(kernel, "vertical") == 0) {
    err = cudaFuncGetAttributes(&fa, vertical_kernel);
  } else if (std::strcmp(kernel, "lookup") == 0) {
    err = cudaFuncGetAttributes(&fa, lookup_kernel);
  } else if (std::strcmp(kernel, "lookup_comp") == 0) {
    err = cudaFuncGetAttributes(&fa, lookup_comp_kernel);
  } else if (std::strcmp(kernel, "chunk_lookup") == 0) {
    err = cudaFuncGetAttributes(&fa, chunk_lookup_kernel);
    Wo = Wp;
  } else if (std::strcmp(kernel, "chunk_lookup_comp") == 0) {
    err = cudaFuncGetAttributes(&fa, chunk_lookup_comp_kernel);
    Wo = Wp;
  } else if (std::strcmp(kernel, "chunk_dedup") == 0) {
    err = cudaFuncGetAttributes(&fa, chunk_dedup_kernel);
    Wo = Wp;
  } else if (std::strcmp(kernel, "dedup") == 0) {
    err = cudaFuncGetAttributes(&fa, dedup_kernel);
  } else if (unpack) {
    err = cudaFuncGetAttributes(&fa, unpack_kernel);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  SplitGeometry g = split_geometry(Wo);
  if (unpack) g = {Wo > 0 ? Wo : 1, 1, kUnpackWarps};
  const long long pairs = static_cast<long long>(cells) * g.tiles;
  const int cs = split_cluster(
      pairs, L, g.slices, unpack ? kUnpackMinSliceTerms : kMinSliceTerms,
      cluster, device);
  const long long per_rank = (static_cast<long long>(L) + cs - 1) / cs;
  int* o = static_cast<int*>(info);
  o[0] = static_cast<int>(pairs * cs);
  o[1] = unpack ? kUnpackWarps * 32 : kSplitThreads;
  o[2] = cs;
  o[3] = g.wt;
  o[4] = g.slices;
  const long long per_slice = (per_rank + g.slices - 1) / g.slices;
  o[5] = unpack ? 0 : planes_for(per_slice < INT_MAX
                                     ? static_cast<int>(per_slice) : INT_MAX);
  o[6] = static_cast<int>(fa.sharedSizeBytes);
  o[7] = fa.numRegs;
  o[8] = kMaxCluster;
  return 0;
}

// The chunk entry points: rows [R, W] (uniq for the dedup kernel; the
// dictionary, beside refs [R], for the fused decode), idx (indir) and mask
// [cells, L], acc and out [cells, Wp, 32] with Wp >= W; acc and out must
// not overlap. Each takes a cluster size as the split kernels do.
extern "C" int cobs_chunk_lookup(const void* arena, const void* idx,
                                 const void* mask, const void* acc,
                                 void* out, int cells, int L, int W, int Wp,
                                 int cluster, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Wp < W) return static_cast<int>(cudaErrorInvalidValue);
  return launch_split(chunk_lookup_kernel, cells, L, Wp, cluster, device,
                      stream, static_cast<const uint32_t*>(arena),
                      static_cast<const int32_t*>(idx),
                      static_cast<const int32_t*>(mask),
                      static_cast<const int32_t*>(acc),
                      static_cast<int32_t*>(out), L, W, Wp);
}

extern "C" int cobs_chunk_lookup_comp(const void* dict, const void* refs,
                                      const void* idx, const void* mask,
                                      const void* acc, void* out, int cells,
                                      int L, int W, int Wp, int cluster,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Wp < W) return static_cast<int>(cudaErrorInvalidValue);
  return launch_split(chunk_lookup_comp_kernel, cells, L, Wp, cluster,
                      device, stream, static_cast<const uint32_t*>(dict),
                      static_cast<const int32_t*>(refs),
                      static_cast<const int32_t*>(idx),
                      static_cast<const int32_t*>(mask),
                      static_cast<const int32_t*>(acc),
                      static_cast<int32_t*>(out), L, W, Wp);
}

extern "C" int cobs_chunk_dedup(const void* uniq, const void* indir,
                                const void* mask, const void* acc, void* out,
                                int cells, int L, int W, int Wp, int cluster,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Wp < W) return static_cast<int>(cudaErrorInvalidValue);
  return launch_split(chunk_dedup_kernel, cells, L, Wp, cluster, device,
                      stream, static_cast<const uint32_t*>(uniq),
                      static_cast<const int32_t*>(indir),
                      static_cast<const int32_t*>(mask),
                      static_cast<const int32_t*>(acc),
                      static_cast<int32_t*>(out), L, W, Wp);
}

// The dedup pair: uniq_idx [U, k] (k = 1 for a flat [U] list), out
// [U, W]; then uniq [U, W], indir and mask [cells, L], out [cells, W, 32].
// cobs_dedup_score launches as the programmatic dependent of the kernel
// before it on the stream (the gather of the pair), so its launch and
// first staging overlap the gather; its kernel waits for that kernel's
// completion before it reads uniq.
extern "C" int cobs_gather_rows(const void* arena, const void* uniq_idx,
                                void* out, int U, int k, int W, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gather<false>(static_cast<const uint32_t*>(arena), nullptr,
                              static_cast<const int32_t*>(uniq_idx),
                              static_cast<uint32_t*>(out), U, k, W, stream);
}

extern "C" int cobs_gather_rows_comp(const void* dict, const void* refs,
                                     const void* uniq_idx, void* out, int U,
                                     int k, int W, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gather<true>(static_cast<const uint32_t*>(dict),
                             static_cast<const int32_t*>(refs),
                             static_cast<const int32_t*>(uniq_idx),
                             static_cast<uint32_t*>(out), U, k, W, stream);
}

extern "C" int cobs_dedup_score(const void* uniq, const void* indir,
                                const void* mask, void* out, int cells,
                                int L, int W, int cluster, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_split<true>(dedup_kernel, cells, L, W, cluster, device,
                            stream, static_cast<const uint32_t*>(uniq),
                            static_cast<const int32_t*>(indir),
                            static_cast<const int32_t*>(mask),
                            static_cast<int32_t*>(out), L, W);
}

// The selection of a dense batch: scores [>= Q, ld] (row stride ld),
// doc_slot [n_docs] (each in [0, ld)), cut [Q] -> out [Q, 1 + 2 * cap];
// one block per query.
extern "C" int cobs_select_hits(const void* scores, const void* doc_slot,
                                const void* cut, void* out, int Q, int ld,
                                int n_docs, int cap, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q < 1 || ld < 0 || n_docs < 0 || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  select_kernel<<<Q, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(scores), ld,
      static_cast<const int32_t*>(doc_slot), static_cast<const int32_t*>(cut),
      n_docs, cap, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cobs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
