// DCRA flash attention for Hopper (sm_90a). Plain C interface, loaded with
// ctypes by repro_torch/kernels/_build.py; launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
//
// flash_attention — replaces
// src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel). o = softmax(q k^T * hd^-0.5 [causal mask]) v over
// q, k, v [BH, S, hd], with the TPU kernel's numerics: f32 logits
// (bf16 products are exact in f32), the causal mask value -1e30, an
// online softmax whose running max m, sum l and accumulator stay in f32,
// p rounded to v's type before the p.v product, l clamped at 1e-30, the
// output stored in q's type. K/V tiles above the diagonal are not
// visited, and the tiles are visited in order from the first, so every
// row's max is finite after the first tile, as in the TPU kernel.
//
// Design: one thread block of 256 threads per (bh, 64-row q tile). The
// TPU kernel's sequential kv grid axis, with m/l/acc carried in VMEM
// scratch from step to step, becomes a loop inside the block. The q
// tile sits in shared memory (f32, rows padded to hd + 1 floats against
// bank conflicts) for the whole loop; each step stages one 64-row K tile
// (padded the same way) and V tile in shared memory, the 16 x 16 threads
// each compute a 4 x 4 block of logits (rows ty + 16i, columns tx + 16j),
// reduce each row's max and sum over the 16 lanes that share it with
// shuffles, write the rounded p to shared memory, and add p.v into a
// 4 x 8 register block of the [64, hd] accumulator (columns tx + 16c).
// hd <= 128. Keys past S (a ragged last tile) get -inf: they are not
// keys, and add nothing. Shared memory at hd = 128 is
// 2*64*129*4 + 64*128*4 + 64*65*4 = 115,456 B, past the 48 KB default:
// the launch raises the dynamic shared-memory limit first.
//
// Bound: 4*BH*S^2*hd flops without the mask, about half with it (the
// tiles below and on the diagonal): at B = 2, H = 16, S = 4096, hd = 128
// causal, 1.4e11 flops, 2.1 ms at 67 TFLOP/s in f32 and 0.14 ms at the
// tensor cores' 989 TFLOP/s in bf16, against 4*BH*S*hd elements of
// q, k, v and o (0.27 GB in f32, 0.08 ms at 3.35 TB/s): the operations
// bind it. This SIMT kernel reaches neither rate, and in bf16 it leaves
// the tensor cores idle; a wgmma/TMA kernel is the later PR.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // q rows and k rows a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxHd = 128;
constexpr int kHdPerThread = kMaxHd / 16;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// p cast to v's type before p.v (astype in the TPU kernel)
__device__ __forceinline__ float round_like(float v, const float*) {
  return v;
}
__device__ __forceinline__ float round_like(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (2 * (size_t)kTile * (hd + 1) + (size_t)kTile * hd +
                          (size_t)kTile * (kTile + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s_len,
                 int hd, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                     // [kTile][ld]
  float* ks = qs + kTile * ld;          // [kTile][ld]
  float* vs = ks + kTile * ld;          // [kTile][hd]
  float* ps = vs + kTile * hd;          // [kTile][kTile + 1]
  const int64_t base = (int64_t)blockIdx.y * s_len * hd;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < kTile * hd; e += kThreads) {
    const int r = e / hd, c = e % hd;
    qs[r * ld + c] =
        q0 + r < s_len ? to_f32(q[base + (int64_t)(q0 + r) * hd + c]) : 0.0f;
  }
  float m[4], l[4], acc[4][kHdPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kHdPerThread; ++c) acc[i][c] = 0.0f;
  }
  const int n_tiles = (s_len + kTile - 1) / kTile;
  // causal: visit tile j while its first key <= the q tile's last row
  const int n_visit = causal ? min(n_tiles, (q0 + kTile - 1) / kTile + 1)
                             : n_tiles;
  for (int j = 0; j < n_visit; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous step is done with ks, vs and ps
    for (int e = tid; e < kTile * hd; e += kThreads) {
      const int r = e / hd, c = e % hd;
      const bool ok = k0 + r < s_len;
      const int64_t g = base + (int64_t)(k0 + r) * hd + c;
      ks[r * ld + c] = ok ? to_f32(k[g]) : 0.0f;
      vs[r * hd + c] = ok ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < hd; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + dd];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = ks[(tx + 16 * jj) * ld + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(a[i], b[jj], sc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = k0 + tx + 16 * jj;
        float s = sc[i][jj] * scale;
        if (kj >= s_len) s = -INFINITY;           // not a key
        else if (causal && kj > qi) s = kMaskValue;
        sc[i][jj] = s;
        mx = fmaxf(mx, s);
      }
      for (int off = 8; off > 0; off >>= 1)        // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        sum += p;
        ps[(ty + 16 * i) * (kTile + 1) + tx + 16 * jj] =
            round_like(p, (const T*)nullptr);
      }
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kHdPerThread; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kTile + 1) + kk];
#pragma unroll
      for (int c = 0; c < kHdPerThread; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float vv = vs[kk * hd + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s_len) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kHdPerThread; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) store(o + base + (int64_t)qi * hd + col, acc[i][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int s_len, int hd, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((s_len + kTile - 1) / kTile), (unsigned)bh);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, hd, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: [bh, s_len, hd], contiguous; dtype 0 = float32, 1 =
// bfloat16 (all four alike); 1 <= hd <= 128; bh <= 65535.
int dcra_flash_attention(const void* q, const void* k, const void* v,
                         void* o, int64_t bh, int32_t s_len, int32_t hd,
                         float scale, int32_t causal, int32_t dtype,
                         cudaStream_t stream) {
  if (bh <= 0 || s_len <= 0) return (int)cudaGetLastError();
  if (hd < 1 || hd > kMaxHd || bh > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, bh, s_len, hd, scale, causal, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, bh, s_len, hd, scale, causal,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
