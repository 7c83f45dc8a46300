// gatherScatter: k-way segment pack for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/pallas_tier.py
// pack_segments / _pack_kernel (and the drop-mode scatter chain in
// spark_rapids_tpu/kernels/layout.py _pack_kway that it stands in for):
//
//   out[dst_j + t] = in_j[lo_j + t]   for t in [0, hi_j - lo_j)
//   dst_j          = sum over i < j of (hi_i - lo_i)
//   out[p]         = 0                for p >= dst_k (the live total)
//
// Nothing outside an input's window [lo_j, hi_j) is read, so rows that a
// take_head truncated (num_rows lowered without repacking) never leak.
//
// Bound: bytes moved.  The least work is reading the live windows once,
// sum(hi_j - lo_j) * width bytes, and writing out_cap * width bytes; there
// is no arithmetic to speak of.  On the main path (the merge aggregate
// concatenating one partial per input batch) each column is a few hundred
// KB, so a call is bound by launch latency, not by bandwidth: the design
// therefore takes ONE launch per call and no helper kernels.
//
// Design: the window bounds are read straight from the callers' 0-d device
// tensors (a batch's num_rows), so the host never learns a row count and
// nothing is launched to build a segment table: each block's prologue
// reads the k bounds and forms the (k+1) cumulative destination starts in
// shared memory, beside the k input pointers, sizes and source starts.
// Then one thread per output element, grid-stride; each element finds its
// segment by binary search over the destination starts (log2 k steps in
// shared memory).  Consecutive threads read consecutive source elements of
// one segment and write consecutive output elements, so both streams are
// coalesced.  The kernel allocates nothing and runs on the caller's stream;
// the C entry point returns cudaGetLastError() after the launch.
//
// The Pallas kernel read every input whole into VMEM for each output
// block; here nothing is staged but the segment table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxInputs = 64;  // keep the by-value argument under 4 KB
constexpr int kThreads = 256;

struct PackInputs {
  const void* ptrs[kMaxInputs];
  long long sizes[kMaxInputs];
  const int* los[kMaxInputs];  // null: the window starts at 0
  const int* his[kMaxInputs];  // null: the window ends at sizes[j]
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_segments_kernel(T* __restrict__ out, long long out_cap,
                     const PackInputs inputs, int k) {
  extern __shared__ long long smem_ll[];
  long long* sizes = smem_ll;                                  // [k]
  long long* lo = sizes + k;                                   // [k]
  long long* dst = lo + k;                                     // [k+1]
  const T** ptrs = reinterpret_cast<const T**>(dst + k + 1);   // [k]
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const long long n = inputs.sizes[i];
    const long long l = inputs.los[i] ? *inputs.los[i] : 0;
    const long long h = inputs.his[i] ? *inputs.his[i] : n;
    sizes[i] = n;
    lo[i] = l;
    dst[i + 1] = h - l;  // window length, prefix-summed below
    ptrs[i] = static_cast<const T*>(inputs.ptrs[i]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    dst[0] = 0;
    for (int i = 1; i <= k; ++i) dst[i] += dst[i - 1];
  }
  __syncthreads();

  const long long total = dst[k];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < out_cap; p += stride) {
    T v = T(0);
    if (p < total) {
      // last segment whose destination start is <= p; empty segments
      // share their start with the next one and are skipped past
      int a = 0, b = k - 1;
      while (a < b) {
        const int m = (a + b + 1) >> 1;
        if (dst[m] <= p) a = m; else b = m - 1;
      }
      const long long src = lo[a] + (p - dst[a]);
      if (src >= 0 && src < sizes[a]) v = ptrs[a][src];
    }
    out[p] = v;
  }
}

template <typename T>
cudaError_t launch(void* out, long long out_cap, const PackInputs& inputs,
                   int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * k + 1) * sizeof(long long) +
                      static_cast<size_t>(k) * sizeof(void*);
  long long blocks = (out_cap + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  pack_segments_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(static_cast<T*>(out), out_cap, inputs,
                                      k);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  ptrs/sizes/los/his are host
// arrays of k entries: device pointers to the inputs, their element
// counts, and device pointers to int32 0-d window bounds (null lo = 0,
// null hi = the input's size).  width is the element size in bytes (bool
// rides as 1).  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int srt_pack_segments(void* out, long long out_cap, int width,
                                 const void* const* ptrs,
                                 const long long* sizes,
                                 const void* const* los,
                                 const void* const* his, int k,
                                 void* stream) {
  if (k < 1 || k > kMaxInputs || out_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackInputs inputs;
  for (int i = 0; i < k; ++i) {
    inputs.ptrs[i] = ptrs[i];
    inputs.sizes[i] = sizes[i];
    inputs.los[i] = static_cast<const int*>(los[i]);
    inputs.his[i] = static_cast<const int*>(his[i]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<uint8_t>(out, out_cap, inputs, k, s);
    case 2: return launch<uint16_t>(out, out_cap, inputs, k, s);
    case 4: return launch<uint32_t>(out, out_cap, inputs, k, s);
    case 8: return launch<unsigned long long>(out, out_cap, inputs, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int srt_max_inputs() { return kMaxInputs; }
