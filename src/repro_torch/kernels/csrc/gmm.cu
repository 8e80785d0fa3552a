// DCRA grouped (expert) matmul for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by repro_torch/kernels/_build.py; launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgmm.so gmm.cu
//
// gmm — replaces src/repro/kernels/moe_gmm.py:gmm_pallas (_gmm_kernel).
// out[t, :] = x[t, :] @ w[group_ids[t / rt]], accumulated in f32 and
// stored in x's type. x is expert-bucketed and capacity-padded, so each
// row tile of rt rows belongs to one expert: the layout the MoE dispatch
// builds. The TPU kernel scalar-prefetches the group ids and lets the
// weight BlockSpec pick the expert's [D, ft] slab for the MXU; here each
// thread block reads its own group id.
//
// Design: one thread block per (BM-row tile, 64-column tile) of the
// output, BM the largest of 64/32/16/8 dividing rt, so a block never
// crosses a group boundary. The block walks D in steps of 16: the x tile
// [BM, 16] (stored transposed, padded against bank conflicts) and the
// expert's w tile [16, 64] are staged in shared memory as f32 (bf16 is
// widened with __bfloat162float), and each of the BM*4 threads keeps a
// 4 x 4 block of f32 accumulators in registers (rows ty + i*BM/4,
// columns tx + 16*j: warp lanes read neighbouring w columns, and x rows
// as broadcasts). Plain FMAs, no tensor cores and no TF32, so an f32
// result matches the plain version to f32 rounding. Columns past F and
// depth past D are masked; a tile whose group id lies outside [0, E) is
// written as zeros (w is never read out of bounds).
//
// Bound: 2*T*D*F flops. At the MoE layer's expert buckets (T = 204,800
// rows, D = 2048, F = 1024) that is 8.6e11 flops, 12.8 ms at the card's
// 67 TFLOP/s of f32 outside the tensor cores, against 3.05 GB of x, w
// and out (0.91 ms at 3.35 TB/s): the f32 operations bind it. A SIMT
// design pays for that bound twice: two shared-memory loads for every
// four FMAs of the 4 x 4 register tile keep it well under the f32 peak,
// and in bf16 the tensor cores' 989 TFLOP/s (wgmma) are not used at all.
// A wgmma pipeline with TMA-fed shared-memory rings is the later PR.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 64;   // output columns a block
constexpr int kBK = 16;   // depth a step
constexpr int kTM = 4;    // accumulator rows a thread
constexpr int kTN = 4;    // accumulator columns a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype
}

template <typename T, int BM>
__global__ void __launch_bounds__(BM * 4)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int32_t* __restrict__ group_ids, T* __restrict__ out,
               int d, int f, int rt, int n_groups) {
  constexpr int kThreads = BM * 4;
  constexpr int kRowStep = BM / kTM;
  __shared__ float xs[kBK][BM + 1];   // x tile, transposed
  __shared__ float ws[kBK][kBN];
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * kBN;
  const int g = group_ids[row0 / rt];
  const bool in_range = g >= 0 && g < n_groups;
  const T* wg = w + (int64_t)(in_range ? g : 0) * d * f;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; in_range && k0 < d; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int m = e / kBK, k = e % kBK;
      xs[k][m] = k0 + k < d ? to_f32(x[(row0 + m) * d + k0 + k]) : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      ws[k][n] = (k0 + k < d && col0 + n < f)
                     ? to_f32(wg[(int64_t)(k0 + k) * f + col0 + n])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[k][ty + i * kRowStep];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = row0 + ty + i * kRowStep;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < f) store(out + row * f + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int32_t* gid, void* out,
           int64_t t_rows, int d, int f, int rt, int n_groups, int bm,
           cudaStream_t stream) {
  const dim3 grid((unsigned)(t_rows / bm), (unsigned)((f + kBN - 1) / kBN));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  switch (bm) {
    case 64:
      gmm_kernel<T, 64><<<grid, 256, 0, stream>>>(xp, wp, gid, op, d, f, rt,
                                                  n_groups);
      break;
    case 32:
      gmm_kernel<T, 32><<<grid, 128, 0, stream>>>(xp, wp, gid, op, d, f, rt,
                                                  n_groups);
      break;
    case 16:
      gmm_kernel<T, 16><<<grid, 64, 0, stream>>>(xp, wp, gid, op, d, f, rt,
                                                 n_groups);
      break;
    case 8:
      gmm_kernel<T, 8><<<grid, 32, 0, stream>>>(xp, wp, gid, op, d, f, rt,
                                                n_groups);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [t_rows, d]; w: [n_groups, d, f]; group_ids: [t_rows / rt] int32;
// out: [t_rows, f]; dtype 0 = float32, 1 = bfloat16 (x, w and out alike);
// bm in {64, 32, 16, 8} divides rt, and rt divides t_rows.
int dcra_gmm(const void* x, const void* w, const int32_t* group_ids,
             void* out, int64_t t_rows, int32_t d, int32_t f, int32_t rt,
             int32_t n_groups, int32_t dtype, int32_t bm,
             cudaStream_t stream) {
  if (t_rows <= 0 || f <= 0) return (int)cudaGetLastError();
  if (bm <= 0 || rt <= 0 || rt % bm || t_rows % rt)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, group_ids, out, t_rows, d, f, rt, n_groups, bm,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, group_ids, out, t_rows, d, f, rt,
                                 n_groups, bm, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
