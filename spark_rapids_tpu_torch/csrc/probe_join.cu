// joinProbe: the candidate phase of the static equi-join, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/pallas_tier.py
// probe_join / _probe_kernel (with its bisection _bsearch), and the XLA
// formulation in spark_rapids_tpu/kernels/join.py join_pairs_static
// (xla_candidates) that it stands in for.  With l_cap probe rows, r_cap
// build rows sorted by their first key hash, and pair_cap output slots:
//
//   lo[i]     = lower bound of l_h1[i] in r_sorted       (u32 order)
//   counts[i] = l_mask[i] ? upper bound - lo[i] : 0
//   cum       = inclusive prefix sum of counts (int32), total = sum (int64)
//   for every slot k < pair_cap:
//     probe_row = min(upper bound of k in cum, l_cap - 1)
//     ordinal   = k - (cum[probe_row] - counts[probe_row])
//     build_row = perm[clamp(lo[probe_row] + ordinal, 0, r_cap - 1)]
//     match     = k < min(total, pair_cap) && a_valid[probe_row]
//                 && b_valid[build_row]
//                 && a_words[w][probe_row] == b_words[w][build_row] for all w
//
// Slots at or past the total carry the same clipped rows as the
// reference, so the raw outputs are equal lane for lane.  Hashes and key
// words arrive as int64 tensors holding u32 values (the port's form of the
// JAX package's uint32 words) and are read as such: no narrowing pass.
// int32 sums and offsets wrap as the reference's int32 arithmetic does.
//
// Bound: bytes moved.  The least work reads the probe side's mask and live
// hashes, the sorted build hashes once, the words, validity and
// permutation entries of the rows the candidates reach, and writes three
// int32/bool outputs per slot; the comparisons are far below the card's
// integer rate.  What held the first design back was latency, not bytes:
// two full bisections per probe row over r_sorted (64 MB of int64 at Q3's
// 2^23 build rows, more than the 50 MB L2: ~46 dependent loads a row), one
// more bisection over the prefix sums per pair slot, and four launches.
//
// Design: two launches on the caller's stream, no host sync.
//   1. prep: samples r_sorted into a u32 table of every 32nd hash (r_cap/32
//      entries, read strided: one sector in eight), records for each of
//      8192 hash buckets (the top 13 bits) how many samples lie below the
//      bucket's first value (from each pair of neighbouring samples), and
//      zeroes the counters of launch 2.
//   2. probe: a persistent grid (the SMs times the blocks each holds).
//      Its blocks load the bucket table into shared memory once, then take
//      tiles of 512 probe rows, one per thread, from an atomic counter:
//      - one lower-bound search per live row (and the last row): its
//        bucket bounds the samples to bisect (about r_cap/2^18 of them;
//        the hashes are uniform), the samples bound the build hashes of
//        r_sorted to bisect to at most 31.  No bisection runs over shared
//        memory, whose top levels would all fall in one bank.  The upper
//        bound gallops forward from the lower bound (Q3's keys run about
//        two per value), exact for any multiplicity;
//      - the masked counts are scanned in the block; the tile's aggregate
//        and each row's in-tile prefix (exact int64) and lower bound go to
//        scratch.  No tile waits on another.
//      The block that finishes the last tile scans the tiles' aggregates
//      into exclusive prefixes and the exact int64 total and raises a flag;
//      then the whole grid fills the pair slots, one thread per slot: the
//      slot's tile by bisection over the tile prefixes (in shared memory),
//      its row by bisection over that tile's in-tile prefixes (at most 512
//      entries, in L2), then the permutation gather and the key-word
//      verify, every load of the verify issued without waiting on
//      another's outcome.  (Staging each block's span of rows in shared
//      memory first was slower: the random gathers of the verify, not the
//      bisections, take the time.)
//      Slots past the total carry the reference's clipped rows (probe_row =
//      l_cap - 1 and its lo and wrapped ordinal).  The reference's cum is
//      the low 32 bits of tile prefix + in-tile prefix; only if the total
//      exceeds 2^31 - 1, where that cum wraps and the reference's bisection
//      no longer reads a sorted array, does every slot take the first
//      design's bisection over the whole cum, searching its lo again.
// A decoupled look-back (each tile's prefix chained from its
// predecessors') is not needed: the slots are filled by the whole grid
// once every tile is done (filling each tile's slots in its own block
// left most of the card idle, since live probe rows cluster in the first
// tiles), and without it no tile waits on another.  Two formulations that
// searched four rows per thread with their state in small per-row arrays
// computed wrong bounds on the card (nvcc 12.9, -O3) and right ones with
// ptxas -O1; the scalar form here is the one kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = kThreads;              // probe rows per tile
constexpr int kTableBytes = 32 * 1024 + 16;  // the bucket table, 8193 u32
constexpr int kStride2 = 32;                 // sample stride in r_sorted
constexpr int kBucketBits = 13;
constexpr int kBuckets = 1 << kBucketBits;
constexpr int kPrepThreads = 256;
constexpr int kCtrlWords = 8;
// ctrl words: [0] next tile, [1] tiles done, [2] lo of the last probe row,
// [3] masked count of the last probe row, [4] tile prefixes ready

struct Layout {
  long long probe_row, build_row, match, total;  // outputs
  long long lo, part, tile_agg, tile_prefix, buckets, samples, ctrl, bytes;
  long long n_tiles, m2;
};

long long align256(long long x) { return (x + 255) & ~255LL; }

Layout layout_of(long long l_cap, long long r_cap, long long pair_cap) {
  Layout L;
  L.n_tiles = (l_cap + kTile - 1) / kTile;
  L.m2 = (r_cap + kStride2 - 1) / kStride2;
  long long at = 0;
  L.probe_row = at;   at = align256(at + 4 * pair_cap);
  L.build_row = at;   at = align256(at + 4 * pair_cap);
  L.match = at;       at = align256(at + pair_cap);
  L.total = at;       at = align256(at + 8);
  L.lo = at;          at = align256(at + 4 * l_cap);
  L.part = at;        at = align256(at + 8 * l_cap);
  L.tile_agg = at;    at = align256(at + 8 * L.n_tiles);
  L.tile_prefix = at; at = align256(at + 8 * L.n_tiles);
  L.buckets = at;     at = align256(at + 4 * (kBuckets + 1));
  L.samples = at;     at = align256(at + 4 * L.m2);
  L.ctrl = at;        at = align256(at + 8 * kCtrlWords);
  L.bytes = at;
  return L;
}

__device__ __forceinline__ uint32_t hash_at(const long long* r_sorted,
                                            long long i) {
  return static_cast<uint32_t>(__ldg(r_sorted + i));
}

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const long long* __restrict__ r_sorted, long long m2,
            uint32_t* __restrict__ samples, uint32_t* __restrict__ buckets,
            unsigned long long* __restrict__ ctrl) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = start; i <= m2; i += stride) {
    // buckets[q] = the samples below q's first value: sample i is the
    // first at or above every bucket from the one after sample i - 1's
    // through its own (the last position closes the table)
    const long long cur = i < m2 ? hash_at(r_sorted, i * kStride2) : 0;
    if (i < m2) samples[i] = static_cast<uint32_t>(cur);
    const long long first =
        i == 0 ? 0
               : (hash_at(r_sorted, (i - 1) * kStride2) >>
                  (32 - kBucketBits)) + 1;
    const long long last = i < m2 ? cur >> (32 - kBucketBits) : kBuckets;
    for (long long q = first; q <= last; ++q) {
      buckets[q] = static_cast<uint32_t>(i);
    }
  }
  if (start < kCtrlWords) ctrl[start] = 0;
}

// Inclusive scan of one int64 per thread across the block.  Returns the
// thread's inclusive prefix; *total (shared) receives the block's sum.
__device__ __forceinline__ long long block_scan64(long long x,
                                                  long long* warp_sums,
                                                  long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;
    if (lane == kThreads / 32 - 1) *total = s;
  }
  __syncthreads();
  return warp > 0 ? x + warp_sums[warp - 1] : x;
}

// Lower bound of h in r_sorted: the bucket of h (its top bits) bounds the
// samples to bisect, and c samples below h bound the build hashes to
// bisect to [(c - 1) * 32 + 1, c * 32] (0 for none).
__device__ __forceinline__ long long lower_bound_row(
    uint32_t h, const uint32_t* counts_below, const uint32_t* samples,
    const long long* r_sorted, long long r_cap) {
  const uint32_t q = h >> (32 - kBucketBits);
  long long a = counts_below[q], b = counts_below[q + 1];
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (__ldg(samples + mid) < h) a = mid + 1; else b = mid;
  }
  if (a == 0) return 0;
  long long lo = (a - 1) * kStride2 + 1;
  long long hi = a * kStride2 < r_cap ? a * kStride2 : r_cap;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (hash_at(r_sorted, mid) < h) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index past the run of h that starts at lb (r_sorted[lb] == h):
// gallop forward, then bisect.  Exact for any multiplicity.
__device__ __forceinline__ long long upper_bound_from(
    const long long* r_sorted, long long r_cap, long long lb, uint32_t h) {
  long long x = lb, step = 1, y;
  while (true) {  // r_sorted[x] == h; find y with r_sorted[y] > h
    y = x + step;
    if (y >= r_cap) { y = r_cap; break; }
    if (hash_at(r_sorted, y) > h) break;
    x = y;
    step <<= 1;
  }
  x += 1;
  while (x < y) {
    const long long mid = (x + y) >> 1;
    if (hash_at(r_sorted, mid) <= h) x = mid + 1; else y = mid;
  }
  return x;
}

// The reference's int32 cum at probe row r: the low 32 bits of the exact
// prefix.  (Other blocks wrote the scratch: read it from L2, not L1.)
__device__ __forceinline__ int cum_at(const long long* tile_prefix,
                                      const long long* part, long long r) {
  return static_cast<int>(static_cast<unsigned long long>(
      __ldcg(tile_prefix + r / kTile) + __ldcg(part + r)));
}

// The first design's slot, for totals past int32: bisection over the
// wrapped int32 cum exactly as the reference's searchsorted reads it, and
// the row's lo searched again by plain bisection.
__device__ __forceinline__ void wrapped_slot(
    long long k, long long live, const long long* tile_prefix,
    const long long* part, const long long* l_h1, long long l_cap,
    const long long* r_sorted, const int* perm, long long r_cap,
    const long long* a_words, const uint8_t* a_valid,
    const long long* b_words, const uint8_t* b_valid, int n_words,
    int* probe_row_out, int* build_row_out, uint8_t* match_out) {
  long long a = 0, b = l_cap;
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (static_cast<long long>(cum_at(tile_prefix, part, mid)) <= k) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const long long p = a < l_cap - 1 ? a : l_cap - 1;
  // == cum[p] - counts[p]
  const int start = p > 0 ? cum_at(tile_prefix, part, p - 1) : 0;
  const int ordinal = static_cast<int>(static_cast<unsigned>(k) -
                                       static_cast<unsigned>(start));
  const uint32_t h = static_cast<uint32_t>(l_h1[p]);
  long long lo = 0, hi = r_cap;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (hash_at(r_sorted, mid) < h) lo = mid + 1; else hi = mid;
  }
  long long pos = static_cast<int>(static_cast<unsigned>(lo) +
                                   static_cast<unsigned>(ordinal));
  pos = pos < 0 ? 0 : (pos > r_cap - 1 ? r_cap - 1 : pos);
  const int br = perm[pos];
  bool eq = k < live && a_valid[p] && b_valid[br];
  for (int w = 0; eq && w < n_words; ++w) {
    eq = a_words[static_cast<long long>(w) * l_cap + p] ==
         b_words[static_cast<long long>(w) * r_cap + br];
  }
  probe_row_out[k] = static_cast<int>(p);
  build_row_out[k] = br;
  match_out[k] = eq ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const long long* __restrict__ l_h1,
             const uint8_t* __restrict__ l_mask, long long l_cap,
             const long long* __restrict__ r_sorted,
             const int* __restrict__ perm, long long r_cap,
             const long long* __restrict__ a_words,
             const uint8_t* __restrict__ a_valid,
             const long long* __restrict__ b_words,
             const uint8_t* __restrict__ b_valid, int n_words,
             long long pair_cap, const uint32_t* __restrict__ buckets,
             const uint32_t* __restrict__ samples, long long n_tiles,
             unsigned long long* ctrl, int* lo_out, long long* part,
             long long* tile_agg, long long* tile_prefix,
             int* __restrict__ probe_row_out, int* __restrict__ build_row_out,
             uint8_t* __restrict__ match_out, long long* total_out) {
  // the bucket table while tiles are scanned, then the tiles' prefixes
  __shared__ __align__(16) unsigned char table[kTableBytes];
  __shared__ long long warp_sums[kThreads / 32];
  __shared__ long long s_aggregate, s_carry;
  __shared__ long long s_tile;
  __shared__ bool s_last;
  uint32_t* counts_below = reinterpret_cast<uint32_t*>(table);

  for (int i = threadIdx.x; i <= kBuckets; i += kThreads) {
    counts_below[i] = buckets[i];
  }
  if (threadIdx.x == 0) s_last = false;
  __syncthreads();

  while (true) {
    if (threadIdx.x == 0) {
      s_tile = static_cast<long long>(atomicAdd(ctrl, 1ull));
    }
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= n_tiles) break;

    // ---- this thread's probe row: bounds and masked count -------------
    const long long i = tile * kTile + threadIdx.x;
    const bool live = i < l_cap && l_mask[i] != 0;
    // the last row's lower bound is read by the slots past the total
    const bool need = live || i == l_cap - 1;
    const uint32_t h = need ? static_cast<uint32_t>(l_h1[i]) : 0;
    const long long lb =
        need ? lower_bound_row(h, counts_below, samples, r_sorted, r_cap) : 0;
    long long count = 0;
    if (live && lb < r_cap && hash_at(r_sorted, lb) == h) {
      count = upper_bound_from(r_sorted, r_cap, lb, h) - lb;
    }
    const long long in_tile = block_scan64(count, warp_sums, &s_aggregate);
    if (i < l_cap) {
      lo_out[i] = static_cast<int>(lb);
      part[i] = in_tile;
    }
    if (i == l_cap - 1) {
      ctrl[2] = static_cast<unsigned long long>(lb);
      ctrl[3] = static_cast<unsigned long long>(count);
    }
    if (threadIdx.x == 0) tile_agg[tile] = s_aggregate;
    // every write of this tile is visible before it counts as done
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0 &&
        atomicAdd(ctrl + 1, 1ull) ==
            static_cast<unsigned long long>(n_tiles - 1)) {
      s_last = true;  // this block finished the last tile
    }
  }

  // ---- the tile prefixes and the total, by the last tile's block --------
  if (s_last) {
    __threadfence();
    if (threadIdx.x == 0) s_carry = 0;
    __syncthreads();
    for (long long base = 0; base < n_tiles; base += kThreads) {
      const long long t = base + threadIdx.x;
      const long long v = t < n_tiles ? __ldcg(tile_agg + t) : 0;
      const long long incl = block_scan64(v, warp_sums, &s_aggregate);
      if (t < n_tiles) tile_prefix[t] = s_carry + incl - v;
      __syncthreads();
      if (threadIdx.x == 0) s_carry += s_aggregate;
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      *total_out = s_carry;
      __threadfence();
      atomicExch(ctrl + 4, 1ull);
    }
  }
  if (threadIdx.x == 0) {
    volatile unsigned long long* ready = ctrl + 4;
    while (*ready == 0) __nanosleep(64);
    __threadfence();
    s_carry = *reinterpret_cast<volatile long long*>(total_out);
  }
  __syncthreads();

  // ---- every pair slot, by the whole grid ------------------------------
  const long long total = s_carry;
  const long long live = total < pair_cap ? total : pair_cap;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (total > 0x7fffffffLL) {
    for (long long k = first; k < pair_cap; k += stride) {
      wrapped_slot(k, live, tile_prefix, part, l_h1, l_cap, r_sorted, perm,
                   r_cap, a_words, a_valid, b_words, b_valid, n_words,
                   probe_row_out, build_row_out, match_out);
    }
    return;
  }
  // the tile prefixes, in shared memory where they fit
  long long* prefix = reinterpret_cast<long long*>(table);
  const bool in_shared = n_tiles <= kTableBytes / 8;
  if (in_shared) {
    for (long long t = threadIdx.x; t < n_tiles; t += kThreads) {
      prefix[t] = __ldcg(tile_prefix + t);
    }
  }
  __syncthreads();
  const unsigned lo_last = static_cast<unsigned>(__ldcg(ctrl + 2));
  const unsigned count_last = static_cast<unsigned>(__ldcg(ctrl + 3));
  for (long long k = first; k < pair_cap; k += stride) {
    if (k >= live) {
      // past the total: probe_row = l_cap - 1, whose start is cum[l_cap -
      // 1] - its count; the ordinal and position wrap as the reference's
      const unsigned start = static_cast<unsigned>(total) - count_last;
      const int ordinal =
          static_cast<int>(static_cast<unsigned>(k) - start);
      long long pos = static_cast<int>(lo_last +
                                       static_cast<unsigned>(ordinal));
      pos = pos < 0 ? 0 : (pos > r_cap - 1 ? r_cap - 1 : pos);
      probe_row_out[k] = static_cast<int>(l_cap - 1);
      build_row_out[k] = perm[pos];
      match_out[k] = 0;
      continue;
    }
    // the last tile whose prefix is <= k, then the first of its rows
    // whose in-tile prefix passes k - that prefix
    long long a = 0, b = n_tiles;
    while (b - a > 1) {
      const long long mid = (a + b) >> 1;
      const long long v = in_shared ? prefix[mid] : __ldcg(tile_prefix + mid);
      if (v <= k) a = mid; else b = mid;
    }
    const long long x = k - (in_shared ? prefix[a] : __ldcg(tile_prefix + a));
    const long long row0 = a * kTile;
    long long r = row0;
    long long e = row0 + kTile < l_cap ? row0 + kTile : l_cap;
    while (r < e) {
      const long long mid = (r + e) >> 1;
      if (__ldcg(part + mid) <= x) r = mid + 1; else e = mid;
    }
    const long long start = r > row0 ? __ldcg(part + r - 1) : 0;
    const int br = perm[__ldcg(lo_out + r) + (x - start)];
    bool eq = (a_valid[r] != 0) & (b_valid[br] != 0);
    for (int w = 0; w < n_words; ++w) {
      eq &= a_words[static_cast<long long>(w) * l_cap + r] ==
            b_words[static_cast<long long>(w) * r_cap + br];
    }
    probe_row_out[k] = static_cast<int>(r);
    build_row_out[k] = br;
    match_out[k] = eq ? 1 : 0;
  }
}

int persistent_blocks() {
  static int cached[64];  // per device: SMs x resident blocks, 0 = unknown
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                      kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// Bytes of the workspace one call needs, and where its outputs lie in it:
// offsets[0..3] receive the byte offsets of probe_row (int32[pair_cap]),
// build_row (int32[pair_cap]), match (bool[pair_cap]) and total (int64).
extern "C" long long srt_probe_join_workspace(long long l_cap,
                                              long long r_cap,
                                              long long pair_cap,
                                              long long* offsets) {
  const Layout L = layout_of(l_cap, r_cap, pair_cap);
  offsets[0] = L.probe_row;
  offsets[1] = L.build_row;
  offsets[2] = L.match;
  offsets[3] = L.total;
  return L.bytes;
}

// Plain C entry point, loaded with ctypes.  l_h1: int64[l_cap] (u32
// values); l_mask: bool[l_cap]; r_sorted: int64[r_cap] ascending (u32
// values); perm: int32[r_cap], every entry in [0, r_cap); a_words:
// int64[n_words][l_cap]; a_valid: bool[l_cap]; b_words:
// int64[n_words][r_cap]; b_valid: bool[r_cap].  workspace: a 256-byte
// aligned device allocation of srt_probe_join_workspace bytes, which holds
// the outputs and the scratch.  Two launches; returns cudaGetLastError()
// after them (0 = launched).
extern "C" int srt_probe_join(const void* l_h1, const void* l_mask,
                              long long l_cap, const void* r_sorted,
                              const void* perm, long long r_cap,
                              const void* a_words, const void* a_valid,
                              const void* b_words, const void* b_valid,
                              int n_words, long long pair_cap,
                              void* workspace, void* stream) {
  if (l_cap < 1 || r_cap < 1 || pair_cap < 1 || n_words < 1 ||
      l_cap >= (1LL << 31) || r_cap >= (1LL << 31) ||
      pair_cap >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid_max = persistent_blocks();
  if (grid_max < 1) return static_cast<int>(cudaGetLastError());
  const Layout L = layout_of(l_cap, r_cap, pair_cap);
  char* ws = static_cast<char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ctrl = reinterpret_cast<unsigned long long*>(ws + L.ctrl);
  auto* buckets = reinterpret_cast<uint32_t*>(ws + L.buckets);
  auto* samples = reinterpret_cast<uint32_t*>(ws + L.samples);
  long long prep_blocks = (L.m2 + 1 + kPrepThreads - 1) / kPrepThreads;
  if (prep_blocks > 132 * 8) prep_blocks = 132 * 8;
  prep_kernel<<<static_cast<unsigned>(prep_blocks), kPrepThreads, 0, s>>>(
      static_cast<const long long*>(r_sorted), L.m2, samples, buckets, ctrl);
  // every block may wait on the block that finishes the last tile, so the
  // grid is no larger than the card holds at once
  const long long grid = grid_max;
  probe_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const long long*>(l_h1),
      static_cast<const uint8_t*>(l_mask), l_cap,
      static_cast<const long long*>(r_sorted), static_cast<const int*>(perm),
      r_cap, static_cast<const long long*>(a_words),
      static_cast<const uint8_t*>(a_valid),
      static_cast<const long long*>(b_words),
      static_cast<const uint8_t*>(b_valid), n_words, pair_cap, buckets,
      samples, L.n_tiles, ctrl, reinterpret_cast<int*>(ws + L.lo),
      reinterpret_cast<long long*>(ws + L.part),
      reinterpret_cast<long long*>(ws + L.tile_agg),
      reinterpret_cast<long long*>(ws + L.tile_prefix),
      reinterpret_cast<int*>(ws + L.probe_row),
      reinterpret_cast<int*>(ws + L.build_row),
      reinterpret_cast<uint8_t*>(ws + L.match),
      reinterpret_cast<long long*>(ws + L.total));
  return static_cast<int>(cudaGetLastError());
}
