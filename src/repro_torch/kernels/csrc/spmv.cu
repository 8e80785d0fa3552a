// DCRA block-sparse-row SpMV kernel for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by repro_torch/kernels/_build.py; launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libspmv.so spmv.cu
//
// bsr_spmv — replaces src/repro/kernels/spmv.py:bsr_spmv_pallas
// (_spmv_kernel). y[r*BS + i] = sum_k sum_j blocks[r,k,i,j] *
// x[block_cols[r,k]*BS + j], accumulated in f32 (the TPU kernel's
// preferred_element_type=f32). Padded blocks (column 0, all zeros) are
// read like any other, as the TPU kernel reads them.
//
// Bound: the blocks, 4*BS*BS B a stored block, are read once; x (4*Ncb*BS
// B, read once from HBM: a tile named again comes from L2), block_cols
// (4 B a block) and y (4*BS B a row block) are small beside them. Two
// flops per 4-byte block entry is half a flop a byte, far under the
// card's f32 rate, so the bytes bound it, over 3.35 TB/s. The TPU kernel runs the [BS, BS] x [BS]
// product on the MXU with the x tile fetched by a prefetched block-column
// index; a matrix-vector product has nothing for the tensor cores to
// reuse, so here it is plain FMAs. One block of 256 threads per row block:
// for each k the x tile named by block_cols[r, k] is staged in shared
// memory, each warp takes rows i = warp, warp + 8, ..., its lanes read
// row i of the [BS, BS] block at consecutive columns (coalesced), multiply
// by the staged x and reduce with warp shuffles; lane 0 adds the row's
// partial sum into a per-row accumulator in shared memory, which only that
// warp touches. A block column outside [0, Ncb) reads as a zero x tile.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void bsr_spmv_kernel(const int32_t* __restrict__ block_cols,
                                const float* __restrict__ blocks,
                                const float* __restrict__ x, int64_t kb,
                                int bs, int64_t ncb, float* __restrict__ y) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [bs] the x tile of this step
  float* acc = smem + bs;           // [bs] the row block's sums
  const int64_t r = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) acc[i] = 0.0f;
  const int64_t block_elems = (int64_t)bs * bs;
  for (int64_t k = 0; k < kb; ++k) {
    const int64_t c = block_cols[r * kb + k];
    const bool in_range = c >= 0 && c < ncb;
    __syncthreads();                // the previous step is done with xs
    for (int j = threadIdx.x; j < bs; j += blockDim.x)
      xs[j] = in_range ? x[c * bs + j] : 0.0f;
    __syncthreads();
    const float* a = blocks + (r * kb + k) * block_elems;
    for (int i = warp; i < bs; i += kWarps) {
      const float* row = a + (int64_t)i * bs;
      float part = 0.0f;
#pragma unroll 4
      for (int j = lane; j < bs; j += 32) part = fmaf(row[j], xs[j], part);
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) acc[i] += part;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bs; i += blockDim.x) y[r * bs + i] = acc[i];
}

}  // namespace

extern "C" {

// block_cols: [r, kb] int32; blocks: [r, kb, bs, bs] f32; x: [ncb * bs] f32;
// y: [r * bs] f32.
int dcra_bsr_spmv(const int32_t* block_cols, const float* blocks,
                  const float* x, int64_t r, int64_t kb, int32_t bs,
                  int64_t ncb, float* y, cudaStream_t stream) {
  if (r <= 0 || bs <= 0) return (int)cudaGetLastError();
  const size_t smem = 2 * (size_t)bs * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(bsr_spmv_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  bsr_spmv_kernel<<<(unsigned)r, kThreads, smem, stream>>>(
      block_cols, blocks, x, kb, bs, ncb, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
