// strings (contains): which rows of a string column hold a literal needle,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/pallas_strings.py
// contains_match / _match_kernel and its row reduction rows_with_match
// (and the XLA formulation spark_rapids_tpu/exprs/strings.py
// _find_matches + _rows_with_match that it stands in for):
//
//   out[r] = 1 if some p in [off[r], end_r - L] has
//            data[p + k] == needle[k] for every k < L, else 0
//   end_r  = min(off[r+1], off[cap], nbytes)
//
// A match inside one row's window crosses no row start and ends by
// off[cap], which is the TPU kernel's per-byte rule; bytes past off[cap]
// are garbage and can never match.  Rows past num_rows have empty windows.
// The empty needle never reaches the kernel (every row matches).
//
// Bound: bytes moved.  The least work reads each live byte and the cap+1
// offsets once and writes one byte per row.  The naive scan compares up
// to L bytes per position, but a mismatch on the first byte (the common
// case) costs one compare, so the scan stays near one read per byte.
//
// Design: one thread per row scans its own window and stops at the first
// match.  The needle lives on the device (the wrapper caches it per needle
// and device, so a call copies nothing from the host); every thread of a
// warp reads the same needle byte at a step, which the cache broadcasts.
// Neighbouring threads scan neighbouring rows, so on the short rows of the
// main path (p_name, ~18 bytes) a warp's reads stay within a few cache
// lines.  The kernel reads the offsets itself: one launch, no host sync.
//
// The Pallas kernel computed a match flag for every byte position (with a
// halo block for matches that straddle two blocks) and reduced per row by
// a cumsum difference; here the per-row answer is the scan's own result,
// so neither the per-byte flags nor the cumsum touch device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
contains_kernel(const uint8_t* __restrict__ data, long long nbytes,
                const int* __restrict__ offsets, long long cap,
                const uint8_t* __restrict__ needle, int needle_len,
                uint8_t* __restrict__ out) {
  long long limit = offsets[cap];
  if (limit > nbytes) limit = nbytes;
  const uint8_t first = needle[0];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < cap; r += stride) {
    long long start = offsets[r];
    long long end = offsets[r + 1];
    if (start < 0) start = 0;
    if (end > limit) end = limit;
    uint8_t found = 0;
    for (long long p = start; p + needle_len <= end; ++p) {
      if (data[p] != first) continue;
      int k = 1;
      while (k < needle_len && data[p + k] == needle[k]) ++k;
      if (k == needle_len) {
        found = 1;
        break;
      }
    }
    out[r] = found;
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
  if (cap < 1 || nbytes < 0 || needle_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (cap + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  contains_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes,
      static_cast<const int*>(offsets), cap,
      static_cast<const uint8_t*>(needle), needle_len,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
