// DCRA histogram kernel for Hopper (sm_90a). Plain C interface, loaded with
// ctypes by repro_torch/kernels/_build.py; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhistogram.so histogram.cu
//
// histogram — replaces src/repro/kernels/histogram.py:histogram_pallas
// (_hist_kernel). out[b] += number of i with elements[i] == b, for b in
// [0, n_bins); ids below 0 or from n_bins on are skipped. out must be zero
// on entry (the wrapper allocates it with torch.zeros).
//
// Bound: 4 B read per element plus 4 B written per bin, over the card's
// 3.35 TB/s; one integer compare and one add per element, far below the
// card's integer rate. The TPU kernel compares each element tile with a
// tile of bin ids and sums the one-hot matrix down the element axis, so
// its work is N * n_bins; a scatter of +1 is N atomics instead. Here each
// block strides over the elements with 16-byte loads and counts into a
// private copy of the bins in shared memory (integer atomicAdd there is
// exact in any order), then adds its nonzero bins to out with one global
// atomicAdd each. When the bins do not fit the shared memory the launch
// asks for (kMaxSmemBytes, granted with cudaFuncSetAttribute), the same
// kernel counts straight into out with global atomics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 192 * 1024;       // of the 227 KB a block may use
constexpr int kBlocksPerSm = 2;                 // blocks resident per SM (smem)

template <bool kShared>
__global__ void hist_kernel(const int32_t* __restrict__ elems, int64_t n,
                            int32_t n_bins, int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  int32_t* counts = kShared ? bins : out;
  if (kShared) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) bins[b] = 0;
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t nb = (uint32_t)n_bins;
  // 16-byte loads from the first 16-byte boundary on; the head before it
  // and the tail after the last whole vector one element a thread
  const int64_t head = (int64_t)(((16 - ((uintptr_t)elems & 15)) & 15) / 4);
  const int64_t lead = head < n ? head : n;
  const int64_t n4 = (n - lead) / 4;
  const int4* v4 = reinterpret_cast<const int4*>(elems + lead);
  for (int64_t i = tid; i < n4; i += stride) {
    const int4 v = v4[i];
    if ((uint32_t)v.x < nb) atomicAdd(&counts[v.x], 1);
    if ((uint32_t)v.y < nb) atomicAdd(&counts[v.y], 1);
    if ((uint32_t)v.z < nb) atomicAdd(&counts[v.z], 1);
    if ((uint32_t)v.w < nb) atomicAdd(&counts[v.w], 1);
  }
  const int64_t rest = lead + (n - lead - 4 * n4);
  if (tid < rest) {
    const int64_t i = tid < lead ? tid : lead + 4 * n4 + (tid - lead);
    const int32_t d = elems[i];
    if ((uint32_t)d < nb) atomicAdd(&counts[d], 1);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
      const int32_t c = bins[b];
      if (c) atomicAdd(&out[b], c);
    }
  }
}

}  // namespace

extern "C" {

// elements: [n] int32; out: [n_bins] int32, zero on entry.
int dcra_histogram(const int32_t* elements, int64_t n, int32_t n_bins,
                   int32_t* out, cudaStream_t stream) {
  if (n <= 0 || n_bins <= 0) return (int)cudaGetLastError();
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t per_thread = 16;                // elements a thread at least
  int64_t want = (n + (int64_t)kThreads * per_thread - 1)
                 / ((int64_t)kThreads * per_thread);
  const size_t smem = (size_t)n_bins * sizeof(int32_t);
  if (smem <= (size_t)kMaxSmemBytes) {
    const int64_t cap = (int64_t)sms * kBlocksPerSm;
    const unsigned blocks = (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(hist_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    hist_kernel<true><<<blocks, kThreads, smem, stream>>>(elements, n, n_bins,
                                                          out);
  } else {
    const int64_t cap = (int64_t)sms * 8;
    const unsigned blocks = (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
    hist_kernel<false><<<blocks, kThreads, 0, stream>>>(elements, n, n_bins,
                                                        out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
