// stringHash: dual 32-bit polynomial row hashes of a string column, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/pallas_tier.py
// string_hash_rows / _string_hash_kernel (and the weighted segment-sum of
// spark_rapids_tpu/exprs/strings.py string_hash2 that it stands in for):
//
//   h_b[r] = sum over i in [off[r], off[r+1]) of data[i] * b^(off[r+1]-1-i)
//            + (off[r+1] - off[r]) * 0x9E3779B9            (mod 2^32)
//
// for the bases b = base1, base2 (31 and 131).  uint32_t arithmetic wraps
// mod 2^32, so Horner over the row's bytes gives the same value as the
// reference's sum of powers in any association.  Rows past num_rows have
// zero length (offsets are constant there) and hash to 0.  A byte index
// at or past nbytes reads as 0, where the reference has no such position
// to add; with valid offsets (off[cap] <= nbytes) it never happens.
//
// Bound: bytes moved.  The least work reads each byte once, the cap+1
// offsets once, and writes two 8-byte words per row (the port keeps u32
// sort words in int64); two multiply-adds per byte are far below the
// card's integer rate.
//
// Design: one thread per row, Horner over the row's own window, both
// bases in one pass.  The kernel reads the offsets itself, so the host
// never learns a size: one launch, no sync.  Neighbouring threads walk
// neighbouring rows, whose bytes lie next to each other, so the byte reads
// of a warp fall into a few cache lines per step on short strings (the
// 1-25 byte keys of the main path).  A 64 KiB row keeps one thread busy
// for 64 Ki steps: right, slow, and not on the main path.
//
// The Pallas kernel held the whole byte buffer in VMEM and looped every
// row block to the block's longest row; here each thread stops at its
// own row's end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
string_hash_kernel(const uint8_t* __restrict__ data, long long nbytes,
                   const int* __restrict__ offsets, long long cap,
                   uint32_t base1, uint32_t base2, uint32_t golden,
                   long long* __restrict__ h1_out,
                   long long* __restrict__ h2_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < cap; r += stride) {
    const long long start = offsets[r];
    const long long end = offsets[r + 1];
    uint32_t h1 = 0, h2 = 0;
    for (long long i = start; i < end; ++i) {
      const uint32_t b = (i >= 0 && i < nbytes) ? data[i] : 0u;
      h1 = h1 * base1 + b;
      h2 = h2 * base2 + b;
    }
    const uint32_t mix = static_cast<uint32_t>(end - start) * golden;
    h1_out[r] = static_cast<long long>(h1 + mix);
    h2_out[r] = static_cast<long long>(h2 + mix);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  data: u8[nbytes]; offsets:
// int32[cap+1]; h1/h2: int64[cap], each holding a u32 value.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int srt_string_hash(const void* data, long long nbytes,
                               const void* offsets, long long cap,
                               unsigned int base1, unsigned int base2,
                               unsigned int golden, void* h1, void* h2,
                               void* stream) {
  if (cap < 1 || nbytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (cap + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  string_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes,
      static_cast<const int*>(offsets), cap, base1, base2, golden,
      static_cast<long long*>(h1), static_cast<long long*>(h2));
  return static_cast<int>(cudaGetLastError());
}
