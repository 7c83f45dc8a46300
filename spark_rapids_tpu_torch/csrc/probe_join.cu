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
// Bound: bytes moved.  The least work reads the probe side (hash, mask,
// words, validity) and the build side (sorted hashes, permutation, words,
// validity) once and writes three int32/bool outputs per slot; the
// comparisons are far below the card's integer rate.
//
// Design.  The TPU kernel was one program holding everything in VMEM,
// gated by a residency budget.  On this card the build side of a real
// join (Q3's lineitem: 2^23 rows, ~240 MB of int64 hashes and words and
// the permutation, at two words) cannot live in a block's 227 KB of
// shared memory, so everything is read from global memory, with no size
// gate: four launches on the caller's stream and no host sync.
//   1. bounds_scan: one thread per 4 probe rows: two bisections with
//      selects over r_sorted, the masked counts, and a block-local
//      inclusive scan of 1024 counts (warp shuffles), writing lo, the
//      tile-local cum and one sum per tile;
//   2. scan_tiles: one block scans the tile sums in chunks of 1024,
//      writing each tile's offset and the int64 total;
//   3. add_offsets: cum[i] += the offset of its tile;
//   4. expand_verify: one thread per pair slot: a bisection over cum, the
//      clipped build position, the permutation gather and the word
//      compare.
// The binary searches read r_sorted and cum from global memory; their top
// levels are shared by every thread and stay in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                    // probe rows per thread
constexpr int kTile = kThreads * kItems;     // probe rows per block
constexpr int kScanThreads = 1024;           // one block scans the tiles

// Number of elements of sorted[0, n) that are < key (strict) or <= key
// (!strict): the lower and upper bound, as jnp.searchsorted computes it.
__device__ __forceinline__ long long bound_u32(const long long* sorted,
                                               long long n, uint32_t key,
                                               bool strict) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const uint32_t v = static_cast<uint32_t>(sorted[mid]);
    const bool go_right = strict ? (v < key) : (v <= key);
    lo = go_right ? mid + 1 : lo;
    hi = go_right ? hi : mid;
  }
  return lo;
}

// Inclusive scan of one int32 per thread across the block (blockDim.x a
// multiple of 32, at most 1024).  Returns the thread's inclusive prefix;
// *block_total receives the block's sum.
__device__ __forceinline__ int block_inclusive_scan(int x, int* warp_sums,
                                                    int* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = static_cast<int>(static_cast<unsigned>(x) +
                                        static_cast<unsigned>(y));
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s = static_cast<int>(static_cast<unsigned>(s) +
                                          static_cast<unsigned>(y));
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) {
    x = static_cast<int>(static_cast<unsigned>(x) +
                         static_cast<unsigned>(warp_sums[warp - 1]));
  }
  *block_total = warp_sums[n_warps - 1];
  return x;
}

// Sum of one int64 per thread across the block, returned to every thread.
__device__ __forceinline__ long long block_sum64(long long x,
                                                 long long* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if (lane == 0) sums[warp] = x;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < n_warps; ++w) total += sums[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
bounds_scan_kernel(const long long* __restrict__ l_h1,
                   const uint8_t* __restrict__ l_mask, long long l_cap,
                   const long long* __restrict__ r_sorted, long long r_cap,
                   int* __restrict__ lo_out, int* __restrict__ cum_out,
                   long long* __restrict__ tile_sums) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ long long sums64[kThreads / 32];
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int counts[kItems];
  int local = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    counts[j] = 0;
    if (i < l_cap) {
      const uint32_t h = static_cast<uint32_t>(l_h1[i]);
      const long long lo = bound_u32(r_sorted, r_cap, h, true);
      lo_out[i] = static_cast<int>(lo);
      if (l_mask[i]) {
        counts[j] = static_cast<int>(bound_u32(r_sorted, r_cap, h, false) -
                                     lo);
      }
    }
    local = static_cast<int>(static_cast<unsigned>(local) +
                             static_cast<unsigned>(counts[j]));
  }
  int block_total;  // unused here: the tile's sum is taken in int64
  const int incl = block_inclusive_scan(local, warp_sums, &block_total);
  int run = static_cast<int>(static_cast<unsigned>(incl) -
                             static_cast<unsigned>(local));
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    run = static_cast<int>(static_cast<unsigned>(run) +
                           static_cast<unsigned>(counts[j]));
    if (i < l_cap) cum_out[i] = run;
  }
  // the tile's exact sum in int64 beside the wrapping int32 scan
  long long exact = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) exact += counts[j];
  const long long tile = block_sum64(exact, sums64);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = tile;
}

__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const long long* __restrict__ tile_sums, long long n_tiles,
                  int* __restrict__ tile_offsets,
                  long long* __restrict__ total_out) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ long long exact[kScanThreads / 32];
  long long carry = 0;       // exact int64 running total
  for (long long c = 0; c < n_tiles; c += kScanThreads) {
    const long long t = c + threadIdx.x;
    const long long v = t < n_tiles ? tile_sums[t] : 0;
    // the int32 offsets wrap as the reference's int32 cumsum does; the
    // total is summed exactly in int64 beside them
    int block_total;
    const int incl = block_inclusive_scan(static_cast<int>(v), warp_sums,
                                          &block_total);
    if (t < n_tiles) {
      tile_offsets[t] = static_cast<int>(
          static_cast<unsigned>(incl) - static_cast<unsigned>(v) +
          static_cast<unsigned>(carry));
    }
    carry += block_sum64(v, exact);
  }
  if (threadIdx.x == 0) *total_out = carry;
}

__global__ void __launch_bounds__(kThreads)
add_offsets_kernel(int* __restrict__ cum, long long l_cap,
                   const int* __restrict__ tile_offsets) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < l_cap; i += stride) {
    cum[i] = static_cast<int>(static_cast<unsigned>(cum[i]) +
                              static_cast<unsigned>(tile_offsets[i / kTile]));
  }
}

__global__ void __launch_bounds__(kThreads)
expand_verify_kernel(const int* __restrict__ cum,
                     const int* __restrict__ lo, long long l_cap,
                     const int* __restrict__ perm, long long r_cap,
                     const long long* __restrict__ a_words,
                     const uint8_t* __restrict__ a_valid,
                     const long long* __restrict__ b_words,
                     const uint8_t* __restrict__ b_valid, int n_words,
                     const long long* __restrict__ total, long long pair_cap,
                     int* __restrict__ probe_row_out,
                     int* __restrict__ build_row_out,
                     uint8_t* __restrict__ match_out) {
  const long long t = *total;
  const long long live = t < pair_cap ? t : pair_cap;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < pair_cap; k += stride) {
    // upper bound of k in cum: the number of cum entries <= k
    long long a = 0, b = l_cap;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      const bool go_right = static_cast<long long>(cum[mid]) <= k;
      a = go_right ? mid + 1 : a;
      b = go_right ? b : mid;
    }
    const long long p = a < l_cap - 1 ? a : l_cap - 1;
    const int start = p > 0 ? cum[p - 1] : 0;  // == cum[p] - counts[p]
    const int ordinal = static_cast<int>(static_cast<unsigned>(k) -
                                         static_cast<unsigned>(start));
    long long pos = static_cast<int>(static_cast<unsigned>(lo[p]) +
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
}

long long grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  l_h1: int64[l_cap] (u32
// values); l_mask: bool[l_cap]; r_sorted: int64[r_cap] ascending (u32
// values); perm: int32[r_cap], every entry in [0, r_cap); a_words:
// int64[n_words][l_cap]; a_valid: bool[l_cap]; b_words:
// int64[n_words][r_cap]; b_valid: bool[r_cap].  Scratch: lo and cum
// int32[l_cap], tile_sums int64[n_tiles], tile_offsets int32[n_tiles],
// n_tiles = ceil(l_cap / 1024).  Outputs: probe_row, build_row
// int32[pair_cap], match bool[pair_cap], total int64[1].  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int srt_probe_join(const void* l_h1, const void* l_mask,
                              long long l_cap, const void* r_sorted,
                              const void* perm, long long r_cap,
                              const void* a_words, const void* a_valid,
                              const void* b_words, const void* b_valid,
                              int n_words, long long pair_cap, void* lo,
                              void* cum, void* tile_sums, void* tile_offsets,
                              void* probe_row, void* build_row, void* match,
                              void* total, void* stream) {
  if (l_cap < 1 || r_cap < 1 || pair_cap < 1 || n_words < 1 ||
      l_cap >= (1LL << 31) || r_cap >= (1LL << 31) ||
      pair_cap >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (l_cap + kTile - 1) / kTile;
  bounds_scan_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const long long*>(l_h1),
      static_cast<const uint8_t*>(l_mask), l_cap,
      static_cast<const long long*>(r_sorted), r_cap,
      static_cast<int*>(lo), static_cast<int*>(cum),
      static_cast<long long*>(tile_sums));
  scan_tiles_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const long long*>(tile_sums), n_tiles,
      static_cast<int*>(tile_offsets), static_cast<long long*>(total));
  add_offsets_kernel<<<static_cast<unsigned>(grid_for(l_cap)), kThreads, 0,
                       s>>>(static_cast<int*>(cum), l_cap,
                            static_cast<const int*>(tile_offsets));
  expand_verify_kernel<<<static_cast<unsigned>(grid_for(pair_cap)), kThreads,
                         0, s>>>(
      static_cast<const int*>(cum), static_cast<const int*>(lo), l_cap,
      static_cast<const int*>(perm), r_cap,
      static_cast<const long long*>(a_words),
      static_cast<const uint8_t*>(a_valid),
      static_cast<const long long*>(b_words),
      static_cast<const uint8_t*>(b_valid), n_words,
      static_cast<const long long*>(total), pair_cap,
      static_cast<int*>(probe_row), static_cast<int*>(build_row),
      static_cast<uint8_t*>(match));
  return static_cast<int>(cudaGetLastError());
}
