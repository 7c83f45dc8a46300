// strings (contains): which rows of a string column hold a literal needle,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/pallas_strings.py
// contains_match / _match_kernel and its row reduction rows_with_match
// (and the XLA formulation spark_rapids_tpu/exprs/strings.py
// _find_matches + _rows_with_match that it stands in for):
//
//   out[r] = 1 if some p in [start_r, end_r - L] has
//            data[p + k] == needle[k] for every k < L, else 0
//   start_r = max(off[r], 0),  end_r = min(off[r+1], off[cap], nbytes)
//
// A match inside one row's window crosses no row start and ends by
// off[cap], which is the TPU kernel's per-byte rule; bytes past off[cap]
// are garbage and can never match.  Rows past num_rows have empty windows.
// The empty needle never reaches the kernel (every row matches).
//
// Bound: bytes moved.  The least work reads each live byte and the cap+1
// offsets once and writes one byte per row.
//
// Design: a block of 256 threads takes a tile of 512 rows, two a thread.
// The tile's offsets come into shared memory by coalesced loads, then the
// bytes of its span by 16-byte cp.async copies (up to 12 KiB; rows past
// that are read from device memory).  The scan is byte-parallel over the
// staged span: a thread takes an aligned 16-byte chunk (one shared-memory
// read, and the word after it), tests the needle's first four bytes at
// the chunk's 16 positions with funnel shifts, branch-free, verifies a
// position that passes in full, and stores the chunk's 16 match-start
// flags as one 16-bit word of a bitmap in shared memory (the TPU kernel's
// per-byte flags; no atomics, nothing to clear).  A row inside the staged
// bytes then holds the needle iff a bit is set in [start, end - len]: a
// match starting there ends by the row's end and crosses no row start,
// whatever the other rows' offsets are.  A thread writes its rows'
// answers (a warp's stores coalesce).  Rows outside the staged bytes, and
// every row of a tile that is not staged, are scanned from device memory:
// short rows a thread each, long ones a warp each (lanes take 16-byte
// chunks and read the needle's halo past their chunk from device memory).
// The needle lives on the device (the wrapper caches it); its first 256
// bytes are copied into shared memory once per block.
//
// The Pallas kernel computed a match flag for every byte position (with a
// halo block for matches that straddle two blocks) and reduced per row by
// a cumsum difference; here the flags stay in shared memory and the
// reduction is a few bitmap words per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows longer than this go one warp to a row, from device memory
constexpr long long kLongRow = 256;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes data[x .. x+16) into w (little-endian words), 0 outside
// [0, nbytes); x is 16-byte aligned in absolute address.
__device__ __forceinline__ void load16(const uint8_t* data, long long nbytes,
                                       long long x, uint32_t w[4]) {
  if (x >= 0 && x + 16 <= nbytes) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(data + x));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
  for (int j = 0; j < 4; ++j) {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const long long i = x + 4 * j + k;
      const uint32_t b = (i >= 0 && i < nbytes) ? data[i] : 0u;
      v |= b << (8 * k);
    }
    w[j] = v;
  }
}

// The index of the aligned 16-byte chunk holding data[s] (may be < 0).
__device__ __forceinline__ long long chunk_floor(const uint8_t* data,
                                                 long long s) {
  return s - static_cast<long long>(
                 (reinterpret_cast<uintptr_t>(data) +
                  static_cast<uintptr_t>(s)) & 15);
}

// Tiles: kTileRows consecutive rows, kRowsPerThread a thread.  The byte
// window is 16-byte aligned in absolute address (cp.async needs aligned
// sources) and spans at most kStageBytes: a tile whose span is larger
// stages its first kStageBytes.  A 16-byte chunk that crosses either end
// of the byte buffer (a view whose data_ptr() is not aligned, a size that
// is not a multiple of 16) is copied byte by byte, zero outside the
// buffer.  Bytes are staged only when 0 <= offsets[r0] <= offsets[r0+rows]
// <= limit; the staged bytes are a faithful copy of data[lo, shi).
constexpr int kRowsPerThread = 2;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kStageBytes = 6 * 1024 * kRowsPerThread;

struct Stage {
  alignas(16) int off[kTileRows + 4];  // offsets[r0 .. r0+rows]
  // the aligned byte window, and slack for word reads past its end
  alignas(16) uint8_t bytes[kStageBytes + 16];
};

// One tile's bytes as every thread of the block sees them.
struct Tile {
  int head;          // position in Stage::bytes of data[lo]
  long long lo, hi;  // offsets[r0], offsets[r0 + rows]
  long long shi;     // bytes [lo, shi) are staged (shi == lo: none)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Phase 1 of a tile: its rows + 1 offsets into st.off.  The caller
// synchronizes the block before reading them.
__device__ __forceinline__ void load_offsets(Stage& st, const int* offsets,
                                             long long r0, int rows) {
  for (int i = threadIdx.x; i <= rows; i += kThreads) {
    st.off[i] = __ldg(offsets + r0 + i);
  }
}

// Phase 2: the tile's bounds from the staged offsets, and the copies of
// its staged bytes [lo, shi) as 16-byte chunks of the aligned window.
// Bytes are staged when 0 <= lo <= hi <= limit.  The caller waits for the
// copies (cp_async_wait_all) and synchronizes the block before reading.
__device__ __forceinline__ Tile stage_bytes(Stage& st, const uint8_t* data,
                                            long long nbytes, long long limit,
                                            int rows) {
  Tile t;
  t.lo = st.off[0];
  t.hi = st.off[rows];
  const uintptr_t d0 = reinterpret_cast<uintptr_t>(data);
  t.head = static_cast<int>((d0 + static_cast<uintptr_t>(t.lo)) & 15);
  t.shi = t.lo;
  if (t.lo < 0 || t.lo > t.hi || t.hi > limit) return t;
  const long long room = kStageBytes - t.head;
  t.shi = t.hi - t.lo <= room ? t.hi : t.lo + room;
  const uintptr_t d1 = d0 + static_cast<uintptr_t>(nbytes);
  const uintptr_t a0 = d0 + static_cast<uintptr_t>(t.lo) - t.head;
  const int chunks = (t.head + static_cast<int>(t.shi - t.lo) + 15) >> 4;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const uintptr_t a = a0 + 16 * static_cast<uintptr_t>(c);
    if (a >= d0 && a + 16 <= d1) {
      cp_async16(&st.bytes[16 * c], reinterpret_cast<const void*>(a));
    } else {
      for (int k = 0; k < 16; ++k) {
        const uintptr_t x = a + k;
        st.bytes[16 * c + k] =
            (x >= d0 && x < d1) ? *reinterpret_cast<const uint8_t*>(x) : 0;
      }
    }
  }
  return t;
}

struct Needle {
  const uint8_t* bytes;  // on the device
  int len;               // >= 1
  uint32_t head;         // its first min(len, 4) bytes, little-endian
  uint32_t mask;         // the bits of head that count
};

// Whether the needle starts at data[p] (the caller keeps p + len within
// the row).
__device__ __forceinline__ bool match_at(const uint8_t* data, long long p,
                                         const Needle& n) {
  for (int k = 0; k < n.len; ++k) {
    if (__ldg(data + p + k) != __ldg(n.bytes + k)) return false;
  }
  return true;
}

// Thread-per-row scan of data[s, e) in device memory.
__device__ __forceinline__ bool scan_global(const uint8_t* data, long long s,
                                            long long e, const Needle& n) {
  const uint8_t first = static_cast<uint8_t>(n.head & 0xffu);
  for (long long p = s; p + n.len <= e; ++p) {
    if (__ldg(data + p) == first && match_at(data, p, n)) return true;
  }
  return false;
}

// One warp scans data[s, e) from device memory (0 <= s, e <= nbytes):
// each lane the positions of a 16-byte chunk of every 512-byte strip,
// with the needle's halo read past the chunk.  Every lane returns the
// answer.
__device__ __forceinline__ bool scan_warp(const uint8_t* data,
                                          long long nbytes, long long s,
                                          long long e, const Needle& n) {
  const int lane = threadIdx.x & 31;
  const long long last = e - n.len;  // the last position a match may take
  const uint32_t first = n.head & 0xffu;
  for (long long base = chunk_floor(data, s); base <= last; base += 512) {
    const long long x = base + 16 * lane;
    bool found = false;
    if (x <= last && x + 16 > s) {
      uint32_t w[4];
      load16(data, nbytes, x, w);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long long p = x + k;
        if (!found && p >= s && p <= last &&
            ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) == first) {
          found = match_at(data, p, n);
        }
      }
    }
    if (__any_sync(kFull, found)) return true;
  }
  return false;
}

constexpr int kNeedleShared = 256;  // needle bytes kept in shared memory
constexpr int kHitWords = (kStageBytes + 16 + 31) / 32;

// Byte-parallel scan of a staged tile: bit p of hits is set where the
// needle starts at stage position p, for p in [head, head + span - len];
// the 16-bit words of the chunks holding those positions are written
// (bits outside the range are 0), the others are never read.
__device__ __forceinline__ void scan_staged(const Stage& st, const Tile& t,
                                            const Needle& n,
                                            const uint8_t* nd,
                                            uint32_t* hits) {
  const long long span = t.shi - t.lo;
  if (span < n.len) return;
  const int pfirst = t.head;
  const int plast = t.head + static_cast<int>(span - n.len);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(st.bytes);
  const uint4* w128 = reinterpret_cast<const uint4*>(st.bytes);
  uint16_t* h16 = reinterpret_cast<uint16_t*>(hits);
  const uint32_t first4 = (n.head & 0xffu) * 0x01010101u;
  for (int c = (pfirst >> 4) + threadIdx.x; c <= (plast >> 4);
       c += kThreads) {
    const uint4 v = w128[c];
    const uint32_t w[5] = {v.x, v.y, v.z, v.w, w32[4 * c + 4]};
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m |= static_cast<uint32_t>((__funnelshift_r(w[j], w[j + 1], 8 * k) &
                                    n.mask) == n.head) << (4 * j + k);
      }
    }
    const int p0 = 16 * c;
    if (p0 < pfirst) m &= ~0u << (pfirst - p0);
    if (p0 + 15 > plast) m &= (1u << (plast - p0 + 1)) - 1;
    uint32_t bits = 0;
    while (m) {
      const int k = __ffs(m) - 1;
      m &= m - 1;
      bool ok = true;
      for (int j = 4; j < n.len && ok; ++j) {
        ok = st.bytes[p0 + k + j] == (j < kNeedleShared ? nd[j]
                                                        : __ldg(n.bytes + j));
      }
      if (ok) bits |= 1u << k;
    }
    h16[c] = static_cast<uint16_t>(bits);
  }
}

// Whether any bit of hits in positions [a, b] is set.
__device__ __forceinline__ bool any_hit(const uint32_t* hits, int a, int b) {
  if (b < a) return false;
  for (int w = a >> 5; w <= (b >> 5); ++w) {
    uint32_t v = hits[w];
    if (w == (a >> 5)) v &= ~0u << (a & 31);
    if (w == (b >> 5) && (b & 31) != 31) v &= (1u << ((b & 31) + 1)) - 1;
    if (v) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
contains_kernel(const uint8_t* __restrict__ data, long long nbytes,
                const int* __restrict__ offsets, long long cap,
                const uint8_t* __restrict__ needle, int needle_len,
                uint8_t* __restrict__ out) {
  __shared__ Stage st;
  __shared__ uint32_t hits[kHitWords];
  __shared__ uint8_t nd[kNeedleShared];
  const long long r0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long left = cap - r0;
  const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;
  long long limit = __ldg(offsets + cap);
  if (limit > nbytes) limit = nbytes;
  Needle n;
  n.bytes = needle;
  n.len = needle_len;
  n.head = 0;
  n.mask = 0;
  for (int k = 0; k < 4 && k < needle_len; ++k) {
    n.head |= static_cast<uint32_t>(__ldg(needle + k)) << (8 * k);
    n.mask |= 0xffu << (8 * k);
  }
  load_offsets(st, offsets, r0, rows);
  for (int j = threadIdx.x; j < needle_len && j < kNeedleShared;
       j += kThreads) {
    nd[j] = __ldg(needle + j);
  }
  __syncthreads();
  const Tile tile = stage_bytes(st, data, nbytes, limit, rows);
  cp_async_wait_all();
  __syncthreads();  // the tile's bytes have landed
  scan_staged(st, tile, n, nd, hits);
  __syncthreads();  // every match of the staged bytes is marked
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const bool live = i < rows;
    long long s = 0, e = 0;
    if (live) {
      s = st.off[i];
      e = st.off[i + 1];
      if (s < 0) s = 0;
      if (e > limit) e = limit;
    }
    // a row inside the staged bytes holds the needle iff a match starts
    // in [s, e - len]; any other row is scanned from device memory
    const bool inside = tile.lo <= s && e <= tile.shi;
    bool found = live && inside &&
                 any_hit(hits, tile.head + static_cast<int>(s - tile.lo),
                         tile.head + static_cast<int>(e - n.len - tile.lo));
    const bool rest = live && !inside;
    const bool long_row = rest && e - s > kLongRow;
    if (rest && !long_row) found = scan_global(data, s, e, n);
    unsigned longs = __ballot_sync(kFull, long_row);
    while (longs) {
      const int src = __ffs(longs) - 1;
      longs &= longs - 1;
      const bool f = scan_warp(data, nbytes,
                               __shfl_sync(kFull, s, src),
                               __shfl_sync(kFull, e, src), n);
      if (lane == src) found = f;
    }
    if (live) out[r0 + i] = found ? 1 : 0;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  data: u8[nbytes]; offsets:
// int32[cap+1]; needle: u8[needle_len] on the device, needle_len >= 1;
// out: bool (one byte) [cap].  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int srt_contains(const void* data, long long nbytes,
                            const void* offsets, long long cap,
                            const void* needle, int needle_len, void* out,
                            void* stream) {
  if (cap < 1 || cap >= (1LL << 31) || nbytes < 0 || needle_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (cap + kTileRows - 1) / kTileRows;
  contains_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes,
      static_cast<const int*>(offsets), cap,
      static_cast<const uint8_t*>(needle), needle_len,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
