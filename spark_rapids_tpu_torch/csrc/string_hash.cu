// stringHash: dual 32-bit polynomial row hashes of string columns, for
// Hopper (sm_90a), every column of one call in one launch.
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/pallas_tier.py
// string_hash_rows / _string_hash_kernel (and the weighted segment-sum of
// spark_rapids_tpu/exprs/strings.py string_hash2 that it stands in for):
//
//   h_b[r] = sum over i in [off[r], off[r+1]) of data[i] * b^(off[r+1]-1-i)
//            + (off[r+1] - off[r]) * 0x9E3779B9            (mod 2^32)
//
// for the bases b = base1, base2 (31 and 131).  uint32_t arithmetic wraps
// mod 2^32, so Horner over the row's bytes, or Horner over pieces joined
// by (h_a, p_a) + (h_b, p_b) = (h_a * p_b + h_b, p_a * p_b) with p = b^len,
// gives the reference's sum of powers in any association.  Rows past
// num_rows have zero length (offsets are constant there) and hash to 0.
// A byte index outside [0, nbytes) reads as 0, where the reference has no
// such position to add; with valid offsets (off[cap] <= nbytes) it never
// happens.
//
// Bound: bytes moved.  The least work reads each live byte once, the cap+1
// offsets once, and writes the two u32 hashes of each row (8 bytes); two
// multiply-adds per byte are far below the card's integer rate.  The port
// keeps u32 sort words in int64, so this kernel writes 16 bytes a row: on
// Q1's one-byte flag columns 16 of the 21 bytes it moves per row.
//
// Design: one thread per row, all the string columns of a call in one
// launch.  The table of columns goes by value as a __grid_constant__
// parameter, nothing copied to the device per call; the launch's blocks
// are shared out to the columns in proportion to their rows, so a block
// hashes one column, its threads striding over the column's rows (16
// blocks of 256 threads per SM; a warp on 32 consecutive rows: its offsets
// loads and its two 8-byte stores per row are coalesced).  A row's bytes
// are read through L1 four loads at a time, the bounds checked once per
// row, not once per byte: the rows of a warp lie next to each other.  A
// launch of one column reads the column's fields straight from the
// parameter (a kernel of its own), which keeps the registers at 28 and the
// SMs full of warps.  A long row is hashed by its thread: a warp-per-row
// path would put its vote and loop in every short row's path.  Staging a
// tile of rows in shared memory adds a barrier and a third dependent trip
// to a kernel bound by two dependent loads per row and by its stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxColumns = 32;
constexpr int kColumnWords = 6;  // data, nbytes, offsets, cap, h1, h2

struct Column {
  const uint8_t* data;
  long long nbytes;
  const int* offsets;
  long long cap;
  long long* h1;
  long long* h2;
  long long block_begin;  // the column's first block in the launch
};

struct Table {
  int n;       // columns
  int blocks;  // blocks over all columns
  Column col[kMaxColumns];
};

struct Bases {
  uint32_t b1, b2, golden;
};

__device__ __forceinline__ int column_of(const Table& tab, int block) {
  int c = 0;
  while (c + 1 < tab.n && block >= tab.col[c + 1].block_begin) ++c;
  return c;
}

// Thread-per-row Horner over data[s, e) in device memory (any offsets).
__device__ __forceinline__ void hash_global(const uint8_t* data,
                                            long long nbytes, long long s,
                                            long long e, Bases b,
                                            uint32_t& h1, uint32_t& h2) {
  for (long long i = s; i < e; ++i) {
    const uint32_t x = (i >= 0 && i < nbytes) ? __ldg(data + i) : 0u;
    h1 = h1 * b.b1 + x;
    h2 = h2 * b.b2 + x;
  }
}

// A block hashes rows of one column, its blocks striding over them.  With
// kOneColumn the column's fields are read at a constant offset of the
// parameter; otherwise the block looks its column up.
template <bool kOneColumn>
__global__ void __launch_bounds__(kThreads, 8)
hash_columns_kernel(const __grid_constant__ Table tab, Bases b) {
  const int c = kOneColumn ? 0 : column_of(tab, blockIdx.x);
  const Column& col = tab.col[c];
  const long long blocks =
      (c + 1 < tab.n ? tab.col[c + 1].block_begin : tab.blocks) -
      col.block_begin;
  const long long stride = blocks * kThreads;
  for (long long r = (blockIdx.x - col.block_begin) * kThreads + threadIdx.x;
       r < col.cap; r += stride) {
    const long long s = __ldg(col.offsets + r), e = __ldg(col.offsets + r + 1);
    uint32_t h1 = 0, h2 = 0;
    if (s >= 0 && e <= col.nbytes) {  // no byte needs its bounds check
#pragma unroll 4
      for (long long i = s; i < e; ++i) {
        const uint32_t x = __ldg(col.data + i);
        h1 = h1 * b.b1 + x;
        h2 = h2 * b.b2 + x;
      }
    } else {
      hash_global(col.data, col.nbytes, s, e, b, h1, h2);
    }
    const uint32_t mix = static_cast<uint32_t>(e - s) * b.golden;
    col.h1[r] = static_cast<long long>(h1 + mix);
    col.h2[r] = static_cast<long long>(h2 + mix);
  }
}

int g_sms[64];  // SMs per device, 0 = not read yet

}  // namespace

// Plain C entry point, loaded with ctypes.  desc: n_cols, then per column
// {data u8*, nbytes, offsets int32*, cap, h1 int64*, h2 int64*} (int64
// words): offsets int32[cap+1], h1/h2 int64[cap], each holding a u32
// value.  Columns of cap 0 are skipped; up to kMaxColumns columns go into
// one launch.  *launches receives the number of launches.  Returns
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a description the kernel does not take.
extern "C" int srt_string_hash_columns(const long long* desc,
                                       long long n_words, unsigned base1,
                                       unsigned base2, unsigned golden,
                                       int* launches, void* stream) {
  *launches = 0;
  if (n_words < 1 || desc[0] < 0 ||
      n_words != 1 + desc[0] * kColumnWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_cols = desc[0];
  for (long long i = 0; i < n_cols; ++i) {
    const long long* w = desc + 1 + i * kColumnWords;
    if (w[1] < 0 || w[3] < 0 || w[3] >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bases b{base1, base2, golden};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16 blocks of 256 threads per SM at a time, shared by the columns in
  // proportion to their rows (at least one each); a block loops over the
  // rest of its column
  const long long max_blocks = 16LL * g_sms[dev];
  long long i = 0;
  while (i < n_cols) {
    Table tab;
    tab.n = 0;
    tab.blocks = 0;
    long long rows = 0;
    const long long first = i;
    for (; i < n_cols && tab.n < kMaxColumns; ++i) {
      rows += desc[1 + i * kColumnWords + 3];
      if (desc[1 + i * kColumnWords + 3] > 0) ++tab.n;
    }
    if (tab.n == 0) break;
    const long long want = (rows + kThreads - 1) / kThreads;
    const long long total = want < max_blocks ? want : max_blocks;
    tab.n = 0;
    for (long long j = first; j < i; ++j) {
      const long long* w = desc + 1 + j * kColumnWords;
      if (w[3] == 0) continue;
      Column& col = tab.col[tab.n++];
      col.data = reinterpret_cast<const uint8_t*>(w[0]);
      col.nbytes = w[1];
      col.offsets = reinterpret_cast<const int*>(w[2]);
      col.cap = w[3];
      col.h1 = reinterpret_cast<long long*>(w[4]);
      col.h2 = reinterpret_cast<long long*>(w[5]);
      col.block_begin = tab.blocks;
      long long nb = (w[3] + kThreads - 1) / kThreads;
      const long long share = total * w[3] / rows;
      if (nb > share) nb = share > 0 ? share : 1;
      tab.blocks += static_cast<int>(nb);
    }
    if (tab.n == 1) {
      hash_columns_kernel<true><<<tab.blocks, kThreads, 0, s>>>(tab, b);
    } else {
      hash_columns_kernel<false><<<tab.blocks, kThreads, 0, s>>>(tab, b);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
  }
  return static_cast<int>(cudaGetLastError());
}
