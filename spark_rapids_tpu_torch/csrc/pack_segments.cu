// gatherScatter: k-way segment pack for Hopper (sm_90a), every buffer of a
// concat in one launch.
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/pallas_tier.py
// pack_segments / _pack_kernel (and the drop-mode scatter chain in
// spark_rapids_tpu/kernels/layout.py _pack_kway that it stands in for).
// For one buffer with k inputs and windows [lo_j, hi_j):
//
//   out[dst_j + t] = in_j[lo_j + t]   for t in [0, hi_j - lo_j)
//   dst_j          = sum over i < j of (hi_i - lo_i)
//   out[p]         = 0                for p >= dst_k (the live total)
//
// Nothing outside an input's window is read, so rows that a take_head
// truncated (num_rows lowered without repacking) never leak.  A "set" of
// windows is shared by the buffers that use it: a concat's row windows
// [0, num_rows_j) serve every column's validity and data, and each string
// column has a set of byte windows [0, offsets_j[num_rows_j]).  A third
// kind of buffer rebuilds a string column's offsets in the same launch:
//
//   out[dst_j + t] = L_j + in_j[lo_j + t] - in_j[lo_j]   (int32, wrapping)
//   L_j            = sum over i < j of (in_i[lo_i + n_i] - in_i[lo_i])
//   out[p]         = L_k              for p >= dst_k
//
// which is the cumsum of the packed row lengths that the JAX package's
// concat_kway builds (n_i the window's readable length).
//
// Bound: bytes moved.  The least work reads the live windows once and
// writes each output once; there is no arithmetic to speak of.  On the
// main path (the merge aggregate concatenating one partial per input
// batch) a concat moves a few MB over a dozen buffers, less than one
// launch's latency at the card's memory rate, so what costs is launches
// and host work: hence ONE launch for every buffer of a concat, with the
// window bounds read on the device (no host sync, no helper kernels).
//
// Design.  The whole description (pointers, sizes, bound pointers, one
// entry per buffer) goes into the launch by value as a __grid_constant__
// table: 4,000 bytes on any toolkit, 32,000 bytes where CUDA 12.1+ allows
// large kernel parameters.  Blocks are flattened over (buffer, tile): a
// block finds its buffer by bisection over the table's block starts, reads
// its set's k bounds (string byte ends indirectly, offsets_j[num_rows_j])
// and forms the destination starts in shared memory.  Each thread then
// moves four 16-byte chunks of the output, every load issued before any
// store so that all four are in flight: a chunk inside one window is one
// 16-byte load and store when the source is aligned, and two aligned
// loads joined by funnel shifts when it is not (string bytes and odd
// row counts); chunks that straddle a window edge or the zero tail go
// element by element.  The TPU kernel read every input whole into VMEM
// for each output block; here nothing is staged but the window table.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunksPerThread = 4;
constexpr long long kChunksPerBlock = kThreads * kChunksPerThread;  // 16 KB

// table layout (int64 words):
//   [0] k  [1] n_sets  [2] n_buffers
//   sets:    n_sets x k x {lo_ptr, hi_ptr, hi_index_ptr, size}
//   buffers: n_buffers x {out_ptr, out_elems, meta, block_start, in_ptr[k]}
// lo_ptr null: lo = 0; hi_ptr null: hi = size; hi_index_ptr non-null:
// hi = hi_index[*hi_ptr].  meta = width | kind << 8 | set << 16.
constexpr int kHeader = 3;
constexpr int kSetWords = 4;   // per input
constexpr int kBufWords = 4;   // per buffer, before its k input pointers
constexpr int kKindCopy = 0;
constexpr int kKindOffsets = 1;

constexpr int kSmallWords = 500;   // 4,000 bytes: every toolkit's limit
#if CUDART_VERSION >= 12010
constexpr int kLargeWords = 4000;  // 32,000 bytes (limit 32,764)
#else
constexpr int kLargeWords = kSmallWords;
#endif

template <int W>
struct Table {
  long long w[W];
};

__device__ __forceinline__ uint4 join_shifted(uint4 x, uint4 y, int mis) {
  // bytes [mis, mis + 16) of the 32 bytes x:y (little-endian)
  uint32_t b0, b1, b2, b3, b4;
  switch (mis >> 2) {
    case 0: b0 = x.x; b1 = x.y; b2 = x.z; b3 = x.w; b4 = y.x; break;
    case 1: b0 = x.y; b1 = x.z; b2 = x.w; b3 = y.x; b4 = y.y; break;
    case 2: b0 = x.z; b1 = x.w; b2 = y.x; b3 = y.y; b4 = y.z; break;
    default: b0 = x.w; b1 = y.x; b2 = y.y; b3 = y.z; b4 = y.w; break;
  }
  const unsigned r = (mis & 3) * 8;
  return make_uint4(__funnelshift_r(b0, b1, r), __funnelshift_r(b1, b2, r),
                    __funnelshift_r(b2, b3, r), __funnelshift_r(b3, b4, r));
}

// 16 contiguous source bytes.  When the source is not 16-byte aligned,
// the two aligned words that hold its bytes are read: both hold bytes of
// the window, so neither leaves its allocation.
__device__ __forceinline__ uint4 load16(const char* src) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const int mis = static_cast<int>(sa & 15);
  if (mis == 0) return __ldg(reinterpret_cast<const uint4*>(src));
  const uint4* base = reinterpret_cast<const uint4*>(sa - mis);
  return join_shifted(__ldg(base), __ldg(base + 1), mis);
}

// Exclusive prefix of n values in shared memory, by warp 0 (in place):
// v[i] <- sum of v[0..i), v[n] <- the total.  T is int64 or uint32.
template <typename T>
__device__ __forceinline__ void warp0_exclusive_scan(T* v, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  T carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const T x = i < n ? v[i] : T(0);
    T incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (i < n) v[i] = carry + incl - x;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) v[n] = carry;
}

// The last window whose destination start is <= e (empty windows share
// their start with the next one and are passed over).
__device__ __forceinline__ int window_of(const long long* dst, int k,
                                         long long e) {
  int a = 0, hi = k - 1;
  while (a < hi) {
    const int mid = (a + hi + 1) >> 1;
    if (dst[mid] <= e) a = mid; else hi = mid - 1;
  }
  return a;
}

template <typename T>
__device__ __forceinline__ void copy_elements(char* out, long long e0,
                                              long long e1, long long total,
                                              int k, int a,
                                              const long long* dst,
                                              const char* const* src,
                                              const long long* avail) {
  for (long long e = e0; e < e1; ++e) {
    T v = T(0);
    if (e < total) {
      while (a < k - 1 && dst[a + 1] <= e) ++a;
      const long long t = e - dst[a];
      if (t < avail[a]) v = reinterpret_cast<const T*>(src[a])[t];
    }
    reinterpret_cast<T*>(out)[e] = v;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
pack_multi_kernel(const __grid_constant__ Table<W> tab) {
  const long long* w = tab.w;
  const int k = static_cast<int>(w[0]);
  const int n_sets = static_cast<int>(w[1]);
  const int n_buf = static_cast<int>(w[2]);
  const long long* bufs = w + kHeader + n_sets * kSetWords * k;
  const int buf_stride = kBufWords + k;

  // this block's buffer: the last whose block start is <= blockIdx.x
  const long long bid = blockIdx.x;
  int b = 0;
  {
    int hi = n_buf - 1;
    while (b < hi) {
      const int mid = (b + hi + 1) >> 1;
      if (bufs[mid * buf_stride + 3] <= bid) b = mid; else hi = mid - 1;
    }
  }
  const long long* bw = bufs + b * buf_stride;
  char* out = reinterpret_cast<char*>(bw[0]);
  const long long out_elems = bw[1];
  const int width = static_cast<int>(bw[2] & 0xff);
  const int kind = static_cast<int>((bw[2] >> 8) & 0xff);
  const int set = static_cast<int>(bw[2] >> 16);
  const long long* sw = w + kHeader + set * kSetWords * k;
  const long long tile = bid - bw[3];

  extern __shared__ long long smem[];
  long long* dst = smem;                                   // [k + 1]
  long long* avail = dst + (k + 1);                        // [k]
  const char** src = reinterpret_cast<const char**>(avail + k);  // [k]
  uint32_t* lsum = reinterpret_cast<uint32_t*>(src + k);   // [k + 1]
  uint32_t* base = lsum + (k + 1);                         // [k]

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long* s = sw + j * kSetWords;
    const long long size = s[3];
    const long long lo = s[0] ? *reinterpret_cast<const int*>(s[0]) : 0;
    long long hi = s[1] ? *reinterpret_cast<const int*>(s[1]) : size;
    if (s[2]) hi = reinterpret_cast<const int*>(s[2])[hi];
    const long long len = hi - lo;
    const long long av = size - lo > 0 ? size - lo : 0;
    const char* in = reinterpret_cast<const char*>(bw[kBufWords + j]) +
                     lo * width;
    dst[j] = len;
    avail[j] = av;
    src[j] = in;
    if (kind == kKindOffsets) {
      // the readable part of the window; offsets hold one entry more
      const long long n = len < av ? (len > 0 ? len : 0) : av;
      const int* offs = reinterpret_cast<const int*>(in);
      base[j] = static_cast<uint32_t>(offs[0]);
      lsum[j] = static_cast<uint32_t>(offs[n]) - base[j];
    }
  }
  __syncthreads();
  warp0_exclusive_scan(dst, k);
  if (kind == kKindOffsets) warp0_exclusive_scan(lsum, k);
  __syncthreads();

  const long long total = dst[k];
  const long long out_bytes = out_elems * width;
  const long long n_chunks = (out_bytes + 15) >> 4;
  const long long per_chunk = 16 / width;
  if (kind == kKindOffsets) {
    for (int i = 0; i < kChunksPerThread; ++i) {  // four int32 per chunk
      const long long c =
          tile * kChunksPerBlock + i * kThreads + threadIdx.x;
      if (c >= n_chunks) break;
      const long long e0 = c * per_chunk;
      const long long e1 = e0 + per_chunk < out_elems ? e0 + per_chunk
                                                      : out_elems;
      int a = 0;
      if (e0 < total) a = window_of(dst, k, e0);
      int v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long e = e0 + q;
        uint32_t x = lsum[k];
        if (e < total) {
          while (a < k - 1 && dst[a + 1] <= e) ++a;
          long long t = e - dst[a];
          t = t < avail[a] ? t : avail[a];
          x = lsum[a] + static_cast<uint32_t>(
                            reinterpret_cast<const int*>(src[a])[t]) -
              base[a];
        }
        v[q] = static_cast<int>(x);
      }
      if (e1 - e0 == per_chunk) {
        *reinterpret_cast<int4*>(out + (c << 4)) =
            make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (e0 + q < e1) reinterpret_cast<int*>(out)[e0 + q] = v[q];
        }
      }
    }
    return;
  }
  // copies: every chunk's loads are issued before any store, so a thread
  // keeps its four chunks in flight at once
  uint4 vals[kChunksPerThread];
  int how[kChunksPerThread];  // 0 none, 1 zeros, 2 one window, 3 by element
  int win[kChunksPerThread];
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const long long c = tile * kChunksPerBlock + i * kThreads + threadIdx.x;
    how[i] = 0;
    win[i] = 0;
    if (c >= n_chunks) continue;
    const long long e0 = c * per_chunk;
    const bool full = e0 + per_chunk <= out_elems;
    if (e0 >= total) {
      how[i] = full ? 1 : 3;
      continue;
    }
    const int a = window_of(dst, k, e0);
    const long long e1 = e0 + per_chunk;
    win[i] = a;
    if (full && e1 <= total && e1 <= dst[a + 1] && e1 - dst[a] <= avail[a]) {
      how[i] = 2;
      vals[i] = load16(src[a] + (e0 - dst[a]) * width);
    } else {
      how[i] = 3;
    }
  }
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const long long c = tile * kChunksPerBlock + i * kThreads + threadIdx.x;
    char* o = out + (c << 4);
    if (how[i] == 1) {
      *reinterpret_cast<uint4*>(o) = make_uint4(0, 0, 0, 0);
    } else if (how[i] == 2) {
      *reinterpret_cast<uint4*>(o) = vals[i];
    } else if (how[i] == 3) {
      const long long e0 = c * per_chunk;
      const long long e1 = e0 + per_chunk < out_elems ? e0 + per_chunk
                                                      : out_elems;
      const int a = win[i];
      switch (width) {  // block-uniform
        case 1:
          copy_elements<uint8_t>(out, e0, e1, total, k, a, dst, src, avail);
          break;
        case 2:
          copy_elements<uint16_t>(out, e0, e1, total, k, a, dst, src,
                                  avail);
          break;
        case 4:
          copy_elements<uint32_t>(out, e0, e1, total, k, a, dst, src,
                                  avail);
          break;
        default:
          copy_elements<unsigned long long>(out, e0, e1, total, k, a, dst,
                                            src, avail);
          break;
      }
    }
  }
}

// Dynamic shared memory of a block: the window table of k inputs.  At
// most ~29 KB: a launch's table holds at most ~800 inputs.
size_t smem_bytes(int k) {
  return static_cast<size_t>(k + 1) * 8 + static_cast<size_t>(k) * 16 +
         static_cast<size_t>(2 * k + 1) * 4;
}

template <int W>
cudaError_t launch_table(const long long* words, int n_words,
                         long long blocks, size_t smem, cudaStream_t s) {
  // host staging, one per calling thread (ctypes drops the GIL); the
  // launch copies it by value
  thread_local Table<W> tab;
  memcpy(tab.w, words, sizeof(long long) * n_words);
  pack_multi_kernel<W><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      tab);
  return cudaGetLastError();
}

long long buffer_blocks(const long long* bw) {
  const long long width = bw[2] & 0xff;
  const long long chunks = (bw[1] * width + 15) >> 4;
  return (chunks + kChunksPerBlock - 1) / kChunksPerBlock;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  desc holds n_words int64 words
// in the table layout above (block_start words are filled here).  Buffers
// are packed into as few launches as the parameter limit allows (one,
// unless the description exceeds it); *launches receives their number.
// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a description the kernel does not take (a
// width other than 1/2/4/8, offsets that are not int32, or sets of k
// inputs that leave no room for one buffer in a launch).
extern "C" int srt_pack_multi(const long long* desc, long long n_words,
                              int* launches, void* stream) {
  *launches = 0;
  if (n_words < kHeader) return static_cast<int>(cudaErrorInvalidValue);
  const long long k = desc[0], n_sets = desc[1], n_buf = desc[2];
  const long long fixed = kHeader + n_sets * kSetWords * k;
  const long long per_buf = kBufWords + k;
  if (k < 1 || n_sets < 1 || n_buf < 1 || n_sets > 0xffff ||
      n_words != fixed + n_buf * per_buf || fixed + per_buf > kLargeWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (long long b = 0; b < n_buf; ++b) {
    const long long* bw = desc + fixed + b * per_buf;
    const long long width = bw[2] & 0xff, kind = (bw[2] >> 8) & 0xff;
    const long long set = bw[2] >> 16;
    if ((width != 1 && width != 2 && width != 4 && width != 8) ||
        (kind != kKindCopy && kind != kKindOffsets) ||
        (kind == kKindOffsets && width != 4) || set >= n_sets ||
        bw[1] < 0 || bw[1] >= (1LL << 40)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(static_cast<int>(k));
  // group buffers into launches; each launch's table repeats the header
  // and the sets, then lists its buffers with block starts of its own
  thread_local long long words[kLargeWords];
  long long b = 0;
  while (b < n_buf) {
    memcpy(words, desc, sizeof(long long) * fixed);
    long long n = fixed, blocks = 0, in_launch = 0;
    while (b < n_buf && n + per_buf <= kLargeWords) {
      const long long* bw = desc + fixed + b * per_buf;
      const long long nb = buffer_blocks(bw);
      ++b;
      if (nb == 0) continue;  // an empty output: nothing to write
      if (blocks + nb >= (1LL << 31)) { --b; break; }
      memcpy(words + n, bw, sizeof(long long) * per_buf);
      words[n + 3] = blocks;
      blocks += nb;
      n += per_buf;
      ++in_launch;
    }
    if (in_launch == 0) {
      if (b < n_buf) return static_cast<int>(cudaErrorInvalidValue);
      break;
    }
    words[2] = in_launch;
    const cudaError_t e =
        n <= kSmallWords
            ? launch_table<kSmallWords>(words, static_cast<int>(n), blocks,
                                        smem, s)
            : launch_table<kLargeWords>(words, static_cast<int>(n), blocks,
                                        smem, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
  }
  return static_cast<int>(cudaGetLastError());
}

// The most int64 words one launch's table takes.
extern "C" int srt_pack_max_words() { return kLargeWords; }
