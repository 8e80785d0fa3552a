// DCRA flash attention for Hopper (sm_90a). Plain C interface, loaded with
// ctypes by repro_torch/kernels/_build.py; launches on the caller's
// stream, allocates nothing and returns a cudaError_t.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
//
// flash_attention — replaces
// src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel). o = softmax(q k^T * hd^-0.5 [causal mask]) v over
// q, k, v [BH, S, hd], with the TPU kernel's numerics: f32 logits
// (bf16 products are exact in f32), the causal mask value -1e30, an
// online softmax over 64-key tiles whose running max m, sum l and
// accumulator stay in f32, p rounded to v's type before the p.v product,
// l clamped at 1e-30, the output stored in q's type. Key tiles above the
// diagonal are not visited, and the tiles are visited in order from the
// first, so every row's max is finite after the first tile, as in the TPU
// kernel. Keys past S (a ragged last tile) get -inf: they are not keys,
// and add nothing. The TPU kernel's sequential kv grid axis, with m/l/acc
// carried in VMEM scratch from step to step, becomes a loop inside a
// block.
//
// Bound: 4*BH*S^2*hd flops without the mask, about half with it: at
// B = 2, H = 16, S = 4096, hd = 128 causal, 1.4e11 flops, 0.14 ms at the
// tensor cores' 989 TFLOP/s in bf16 and 2.1 ms at 67 TFLOP/s in f32,
// against 4*BH*S*hd elements of q, k, v and o (0.27 GB in f32, 0.08 ms
// at 3.35 TB/s): the operations bind it.
//
// Three designs, chosen by the wrapper's launch_plan from the dtype, the
// shape and the alignment (never by a failed launch); each launcher refuses
// a plan whose tile, grid, threads, stages or shared memory differ from its
// own:
//  * wgmma (bf16, hd % 8 == 0, 16-byte aligned q, k, v): FlashAttention-
//    3's structure, kept simple. One block of four warpgroups per
//    (192-row q tile, bh); bh is blockIdx.x and the q tiles run from the
//    last (the longest under the causal mask) to the first. The fourth
//    warpgroup's first thread loads the q tile once and keeps [64 keys,
//    hd] K and V tiles in flight through a 3-stage ring of shared memory
//    with TMA and full / empty mbarriers, over a 3D tensor map on [BH,
//    S, hd], so rows past S (and columns past hd, up to the padded width
//    HDP of 64 or 128) arrive as zeros rather than the next head's rows.
//    Each of the three consumer warpgroups owns 64 q rows: S = q k^T is
//    an SS m64n64k16 wgmma (both K-major) into f32 registers; mask and
//    online softmax run on that fragment, a row's four lanes combining by
//    shuffles, each exponent one FMA and one ex2; p, rounded to bf16, is
//    already in the A-operand register layout, and each 64-column half
//    of p v is an RS m64n64k16 wgmma (v MN-major, the transpose bit) into
//    a fresh fragment, folded into o by a float32 FMA: accumulating into o
//    inside the tensor cores drifted from the exact sums as S grew (on an
//    H100 at S 32768: a mean error 0.2 of the p-rounding gap, against the
//    plain version's float32 sums at 0.009). A key tile wholly
//    above a warpgroup's rows, or any tile of a warpgroup whose rows all
//    lie past S, is only released (the mask would leave m, l and o
//    unchanged exactly). setmaxnreg gives the consumers 160 registers and
//    the producer 24. Three consumer warpgroups, because with fewer each
//    SM scheduler holds too few consumer warps to hide the softmax's
//    dependent instructions, and the tensor cores wait for them.
//  * blocked (f32, hd % 4 == 0, 16-byte aligned q, k, v): float32 FFMA,
//    no tensor cores (TF32 would round the products, and error_bound is
//    built on float32 roundoff). Bound on this card by the FFMA rate (2.05
//    ms at the shape above), so the design is about feeding the FMA pipes
//    from registers: one block of 256 threads per (bh, 128-row q tile),
//    the longest causal tiles first, one block an SM. q sits transposed in
//    shared memory ([hd][128], loaded once); each 64-key step computes S =
//    q k^T with every thread owning an 8-row x 4-key tile (rows 4ty..+3 and
//    64+4ty..+3, keys tx + 16j), read as float4: per 4 of depth, 8 q loads
//    (two rows of a warp's lanes share each) and 4 k loads (K rows padded to
//    132 floats, so 16 lanes hit distinct bank groups) feed 128 FMAs. The
//    online softmax runs on those registers (row max over the 16 lanes of a
//    row by shuffles, each lane keeping its own part of l, summed at the
//    end), p goes to shared memory transposed ([64][132]), and o += p v
//    gives every thread an 8 x 8 block of o (columns 4tx..+3 and
//    64+4tx..+3): per key, 2 float4 of p and 2 of v feed 64 FMAs. K and V
//    are staged with 16-byte cp.async.cg copies (rows past S zero-filled)
//    into a two-slot ring in which they alternate: V(j) lands while S(j)
//    and the softmax run, K(j+1) while p v(j) runs, so no step waits on a
//    load and each step takes two __syncthreads. Shared memory: 165,888 B
//    (q 65,536, K 33,792, V 32,768, p 33,792) at every hd; hd < 128 leaves
//    part of it unused and computes o columns past hd that are not stored.
//  * simt (f32 with hd % 4 != 0 or unaligned bases, bf16 with hd % 8 != 0
//    or unaligned bases): one block of 256 threads per
//    (bh, 64-row q tile). The q tile sits in shared memory (f32, rows
//    padded to hd + 1 floats against bank conflicts) for the whole loop;
//    each step stages one 64-row K tile (padded the same way) and V tile
//    in shared memory, the 16 x 16 threads each compute a 4 x 4 block of
//    logits (rows ty + 16i, columns tx + 16j), reduce each row's max and
//    sum over the 16 lanes that share it with shuffles, write the rounded
//    p to shared memory, and add p.v into a 4 x 8 register block of the
//    [64, hd] accumulator (columns tx + 16c). hd <= 128. Shared memory at
//    hd = 128 is 2*64*129*4 + 64*128*4 + 64*65*4 = 115,456 B. It reaches
//    neither the f32 rate nor, in bf16, the tensor cores.
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// simt: f32 or bf16, any hd <= 128
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// blocked: f32, hd % 4 == 0, 16-byte aligned q, k, v
// ---------------------------------------------------------------------------
constexpr int kBq = 128;                  // q rows a block
constexpr int kBHalf = kBq / 2;           // a thread's second row group
constexpr int kBThreads = 256;            // 16 row groups x 16 key groups
constexpr int kBStages = 2;               // the ring's slots: K and V
constexpr int kBKld = kMaxHd + 4;         // K row stride, floats (528 B)
constexpr int kBPld = kBq + 4;            // p^T row stride, floats
constexpr int kBQFloats = kMaxHd * kBq;   // q^T [hd][kBq]
constexpr int kBKFloats = kTile * kBKld;  // K [kTile][kBKld]
constexpr int kBVFloats = kTile * kMaxHd; // V [kTile][kMaxHd]
constexpr int kBPFloats = kTile * kBPld;  // p^T [kTile][kBPld]
constexpr int kBSmem =
    4 * (kBQFloats + kBKFloats + kBVFloats + kBPFloats);   // 165,888 B

// 16 bytes global -> shared, asynchronously; zeros where !ok (src unread)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows k0 .. k0 + 63 of a [s_len, hd] matrix into dst [64][ld] with
// 16-byte copies; rows past s_len as zeros
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int k0,
                                           int s_len, int hd) {
  const int per_row = hd / 4;
  for (int e = threadIdx.x; e < kTile * per_row; e += kBThreads) {
    const int r = e / per_row, c = 4 * (e - r * per_row);
    const bool ok = k0 + r < s_len;
    cp_async16(dst + r * ld + c, ok ? src + (int64_t)(k0 + r) * hd + c : src,
               ok);
  }
}

// the 8 floats p[0..3] and p[half..half+3]: a thread's rows r0..r0+3 and
// r0+kBHalf.., or its o columns 4tx..4tx+3 and 64+4tx..64+4tx+3
__device__ __forceinline__ void load8(const float* p, int half,
                                      float (&out)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 t = *reinterpret_cast<const float4*>(p + half * h);
    out[4 * h] = t.x; out[4 * h + 1] = t.y;
    out[4 * h + 2] = t.z; out[4 * h + 3] = t.w;
  }
}

__global__ void __launch_bounds__(kBThreads, 1)
    flash_blocked_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int s_len, int hd, float scale, int causal) {
  extern __shared__ __align__(16) float bsmem[];
  float* qt = bsmem;                   // [hd][kBq]: q transposed
  float* ks = qt + kBQFloats;          // [kTile][kBKld]
  float* vs = ks + kBKFloats;          // [kTile][kMaxHd]
  float* pt = vs + kBVFloats;          // [kTile][kBPld]: p transposed
  const int64_t base = (int64_t)blockIdx.x * s_len * hd;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;   // longest tiles first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = 4 * ty;   // this thread's rows r0..r0+3, r0+kBHalf..+3
  const int hd4 = hd / 4;
  const int n_tiles = (s_len + kTile - 1) / kTile;
  // causal: visit tile j while its first key <= the q tile's last row
  const int n_visit = causal ? min(n_tiles, (q0 + kBq - 1) / kTile + 1)
                             : n_tiles;

  stage_rows(ks, kBKld, kb, 0, s_len, hd);   // K(0) lands while q^T fills
  cp_async_commit();
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int rr = lane; rr < kBq; rr += 32) {
      const int qi = q0 + rr;
      for (int c4 = warp; c4 < hd4; c4 += kBThreads / 32) {
        const float4 val =
            qi < s_len
                ? *reinterpret_cast<const float4*>(qb + (int64_t)qi * hd +
                                                   4 * c4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
        qt[(4 * c4 + 0) * kBq + rr] = val.x;
        qt[(4 * c4 + 1) * kBq + rr] = val.y;
        qt[(4 * c4 + 2) * kBq + rr] = val.z;
        qt[(4 * c4 + 3) * kBq + rr] = val.w;
      }
    }
  }
  float acc[8][8], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }
  for (int j = 0; j < n_visit; ++j) {
    const int k0 = j * kTile;
    cp_async_wait_all();
    __syncthreads();   // K(j) and q^T visible; p v(j-1) done with vs and pt
    stage_rows(vs, kMaxHd, vb, k0, s_len, hd);
    cp_async_commit();

    // S = q k^T: this thread's rows, keys tx + 16 jj
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < hd4; ++d4) {
      float kv[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 t = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * jj) * kBKld + 4 * d4);
        kv[jj][0] = t.x; kv[jj][1] = t.y; kv[jj][2] = t.z; kv[jj][3] = t.w;
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float a[8];
        load8(qt + (4 * d4 + dd) * kBq + r0, kBHalf, a);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sc[i][jj] = fmaf(a[i], kv[jj][dd], sc[i][jj]);
      }
    }

    // online softmax on the registers; p^T to shared memory
    const bool edge =
        (causal && k0 + kTile - 1 > q0) || k0 + kTile > s_len;
    float alpha[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + r0 + (i < 4 ? i : kBHalf - 4 + i);
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float s = sc[i][jj] * scale;
        if (edge) {
          const int kj = k0 + tx + 16 * jj;
          if (kj >= s_len) s = -INFINITY;           // not a key
          else if (causal && kj > qi) s = kMaskValue;
        }
        sc[i][jj] = s;
        mx = fmaxf(mx, s);
      }
      for (int off = 8; off > 0; off >>= 1)        // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        sc[i][jj] = expf(sc[i][jj] - m_new);
        sum += sc[i][jj];
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;   // this lane's keys; lanes summed last
      m[i] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(pt + (tx + 16 * jj) * kBPld + r0 +
                                   kBHalf * h) =
            make_float4(sc[4 * h][jj], sc[4 * h + 1][jj], sc[4 * h + 2][jj],
                        sc[4 * h + 3][jj]);
    cp_async_wait_all();
    __syncthreads();   // p^T and V(j) visible; S(j) done with ks
    if (j + 1 < n_visit) {
      stage_rows(ks, kBKld, kb, k0 + kTile, s_len, hd);
      cp_async_commit();
    }

    // o = o alpha + p v: this thread's rows, columns 4tx.. and 64 + 4tx..
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha[i];
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      float p[8], w[8];
      load8(pt + kk * kBPld + r0, kBHalf, p);
      load8(vs + kk * kMaxHd + 4 * tx, 64, w);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qi = q0 + r0 + (i < 4 ? i : kBHalf - 4 + i);
    if (qi >= s_len) continue;
    const float inv = 1.0f / fmaxf(lt, 1e-30f);
    float* orow = o + base + (int64_t)qi * hd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 64 * h + 4 * tx;
      if (col < hd)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv,
                        acc[i][4 * h + 2] * inv, acc[i][4 * h + 3] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: bf16, hd padded to HDP = 64 or 128
// ---------------------------------------------------------------------------
constexpr int kWGroups = 3;      // consumer warpgroups, 64 q rows each
constexpr int kWq = 64 * kWGroups;                 // q rows a block
constexpr int kWStages = 3;                        // K/V ring
constexpr int kWThreads = 128 * (kWGroups + 1);    // + the producer
constexpr int kBox = sm90::kBoxBytes;
constexpr float kLog2e = 1.4426950408889634f;

template <int HDP>
struct WgmmaTile {
  static constexpr int kBoxes = HDP / 64;           // boxes a 64-row tile
  static constexpr int kQBytes = kWGroups * kBoxes * kBox;
  static constexpr int kKvBytes = kBoxes * kBox;    // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;
  // q, the ring, 1 + 2 a stage mbarriers, slack to align to 1024 bytes
  static constexpr int kSmem = kQBytes + kWStages * kStageBytes +
                               (1 + 2 * kWStages) * 8 + sm90::kAtomBytes;
};

__device__ __forceinline__ float ex2(float x) {   // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = q k^T for one key tile: HDP / 16 SS wgmmas, committed as one group
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const uint8_t* q,
                                         const uint8_t* kt) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 32;
    sm90::wgmma_m64n64k16_ss<0>(
        sc, sm90::desc_sw128(q + off, 0, sm90::kAtomBytes),
        sm90::desc_sw128(kt + off, 0, sm90::kAtomBytes), kk > 0);
  }
  sm90::wgmma_commit();
}

// p v for one key tile and one 64-column half of v (vh: that half's box):
// 4 RS m64n64k16 wgmmas (v MN-major) into a fresh fragment, one group
__device__ __forceinline__ void issue_pv_half(float (&pv)[32],
                                              uint32_t (&p)[4][4],
                                              const uint8_t* vh) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_m64n64k16_rs<1>(
        pv, p[kk],
        sm90::desc_sw128(vh + 16 * sm90::kSwizzleBytes * kk, kBox,
                         sm90::kAtomBytes),
        kk > 0);
  sm90::wgmma_commit();
}

// The online softmax of one key tile for this thread's rows qi0 and qi1 =
// qi0 + 8 (i & 2 picks the row of fragment element i). The running max m
// is kept on the scaled logits x = s hd^-0.5, as the reference keeps it;
// since rounding is monotone, the max of the rounded x is the rounded
// scale times the max of s, so the max is taken on s and each exponent is
// one FMA, 2^(s (scale log2 e) - m log2 e). p, rounded to bf16, lands in
// the A-operand layout (pairs of neighbouring columns); l sums this lane's
// unrounded p. Returns the factors by which o must be rescaled.
struct Softmax {
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.0f, l1 = 0.0f;

  __device__ __forceinline__ void step(float (&sc)[32], uint32_t (&p)[4][4],
                                       float& alpha0, float& alpha1, int k0,
                                       bool edge, int qi0, int col,
                                       int s_len, int causal, float scale) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (edge) {
      const float masked = kMaskValue / scale;  // scales back to -1e30
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kj = k0 + 8 * (i / 4) + col + (i & 1);
        const int qi = qi0 + ((i & 2) ? 8 : 0);
        if (kj >= s_len) sc[i] = -INFINITY;     // not a key
        else if (causal && kj > qi) sc[i] = masked;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {    // the row's four lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale), mn1 = fmaxf(m1, mx1 * scale);
    const float c0 = mn0 * kLog2e, c1 = mn1 * kLog2e;
    alpha0 = ex2(fmaf(m0, kLog2e, -c0));
    alpha1 = ex2(fmaf(m1, kLog2e, -c1));
    m0 = mn0;
    m1 = mn1;
    const float sl2 = scale * kLog2e;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float c = (i & 2) ? c1 : c0;
      const float pa = ex2(fmaf(sc[i], sl2, -c));
      const float pb = ex2(fmaf(sc[i + 1], sl2, -c));
      if (i & 2) sum1 += pa + pb;
      else sum0 += pa + pb;
      p[i / 8][(i % 8) / 2] = sm90::pack_bf16(pa, pb);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  }
};

template <int HDP>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int s_len, int hd,
                       float scale, int causal) {
  using Tile = WgmmaTile<HDP>;
  constexpr int kN = HDP / 2;                       // o floats a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((sm90::kAtomBytes -
                               (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_tile = smem;
  uint8_t* k_tiles = smem + Tile::kQBytes;                    // [stage]
  uint8_t* v_tiles = k_tiles + kWStages * Tile::kKvBytes;     // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      smem + Tile::kQBytes + kWStages * Tile::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWStages;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWq;   // longest tiles first
  const int n_tiles = (s_len + 63) / 64;
  // causal: visit key tile j while its first key <= the q tile's last row
  const int n_visit = causal ? min(n_tiles, (q0 + kWq - 1) / 64 + 1)
                             : n_tiles;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWGroups);   // one arrive a consumer group
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kWGroups) {
    // ---- producer: one thread issues every TMA load ----
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * kWGroups) {
      sm90::mbar_expect_tx(q_full, Tile::kQBytes);
      for (int h = 0; h < kWGroups; ++h)
        for (int c = 0; c < Tile::kBoxes; ++c)
          sm90::tma_load_3d(q_tile + (h * Tile::kBoxes + c) * kBox, &qmap,
                            q_full, 64 * c, q0 + 64 * h, bh);
      for (int j = 0; j < n_visit; ++j) {
        const int s = j % kWStages;
        sm90::mbar_wait(&empty[s], ((j / kWStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], Tile::kStageBytes);
        for (int c = 0; c < Tile::kBoxes; ++c) {
          sm90::tma_load_3d(k_tiles + s * Tile::kKvBytes + c * kBox, &kmap,
                            &full[s], 64 * c, 64 * j, bh);
          sm90::tma_load_3d(v_tiles + s * Tile::kKvBytes + c * kBox, &vmap,
                            &full[s], 64 * c, 64 * j, bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    sm90::setmaxnreg_inc<160>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    const int row_first = q0 + 64 * wg;
    // this thread's two rows of every fragment, and its first column
    const int qi0 = row_first + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);
    const uint8_t* q = q_tile + wg * Tile::kBoxes * kBox;
    // the tiles this warpgroup computes: none past S, and none wholly above
    // its rows; the others it only releases
    const int n_mine = row_first >= s_len ? 0
                       : causal ? min(n_visit, (row_first + 63) / 64 + 1)
                                : n_visit;
    float acc[kN], sc[32], alpha0, alpha1;
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    uint32_t p[4][4];
    Softmax sm;
    sm90::mbar_wait(q_full, 0);
    for (int j = 0; j < n_visit; ++j) {
      const int s = j % kWStages, k0 = 64 * j;
      sm90::mbar_wait(&full[s], (j / kWStages) & 1);
      if (j < n_mine) {
        issue_qk<HDP>(sc, q, k_tiles + s * Tile::kKvBytes);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm.step(sc, p, alpha0, alpha1, k0,
                (causal && k0 + 63 > row_first) || k0 + 64 > s_len, qi0, col,
                s_len, causal, scale);
        // o = o alpha + p v, a 64-column half at a time: the tile's p v
        // in a fresh fragment, folded into o by a float32 FMA (the tensor
        // cores' own accumulation does not round to nearest, and over S / 64
        // tiles its error would grow with S); half h is o's elements
        // 32 h .. 32 h + 31
#pragma unroll
        for (int h = 0; h < Tile::kBoxes; ++h) {
          float pv[32];
          issue_pv_half(pv, p, v_tiles + s * Tile::kKvBytes + h * kBox);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(pv);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            acc[32 * h + i] = fmaf(acc[32 * h + i],
                                   (i & 2) ? alpha1 : alpha0, pv[i]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(p[kk]);
      }
      // released only after its full phase, so the arrive counts for it
      if (leader) sm90::mbar_arrive(&empty[s]);
    }
    float l0 = sm.l0, l1 = sm.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    const int qi1 = qi0 + 8;
    __nv_bfloat16* ob = o + (int64_t)bh * s_len * hd;
#pragma unroll
    for (int jj = 0; jj < kN / 4; ++jj) {
      const int c = 8 * jj + col;
      if (c < hd) {
        if (qi0 < s_len)
          *reinterpret_cast<uint32_t*>(ob + (int64_t)qi0 * hd + c) =
              sm90::pack_bf16(acc[4 * jj] * inv0, acc[4 * jj + 1] * inv0);
        if (qi1 < s_len)
          *reinterpret_cast<uint32_t*>(ob + (int64_t)qi1 * hd + c) =
              sm90::pack_bf16(acc[4 * jj + 2] * inv1, acc[4 * jj + 3] * inv1);
      }
    }
  }
}

template <int HDP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int64_t bh, int s_len, int hd, float scale, int causal,
                 const sm90::LaunchPlan& plan, cudaStream_t stream) {
  constexpr int smem = WgmmaTile<HDP>::kSmem;
  const dim3 grid((unsigned)bh, (unsigned)((s_len + kWq - 1) / kWq));
  if (!sm90::plan_is(plan, kWq, grid, kWThreads, kWStages, smem))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)s_len,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)s_len * hd * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  for (int i = 0; i < 3; ++i) {
    const int err = sm90::bf16_map(&maps[i], bases[i], 3, dims, strides, box);
    if (err) return err;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  flash_wgmma_kernel<HDP><<<grid, kWThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), s_len, hd,
      scale, causal);
  return (int)cudaGetLastError();
}

int launch_blocked(const void* q, const void* k, const void* v, void* o,
                   int64_t bh, int s_len, int hd, float scale, int causal,
                   const sm90::LaunchPlan& plan, cudaStream_t stream) {
  const dim3 grid((unsigned)bh, (unsigned)((s_len + kBq - 1) / kBq));
  if (!sm90::plan_is(plan, kBq, grid, kBThreads, kBStages, kBSmem))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBSmem);
  if (err != cudaSuccess) return (int)err;
  flash_blocked_kernel<<<grid, kBThreads, kBSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s_len, hd, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                int64_t bh, int s_len, int hd, float scale, int causal,
                const sm90::LaunchPlan& plan, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  const dim3 grid((unsigned)((s_len + kTile - 1) / kTile), (unsigned)bh);
  if (!sm90::plan_is(plan, kTile, grid, kThreads, 1, smem))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, hd, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: [bh, s_len, hd], contiguous; dtype 0 = float32, 1 =
// bfloat16 (all four alike); 1 <= hd <= 128; bh <= 65535. plan: the
// wrapper's launch plan, its path 0 = simt, 1 = wgmma (bf16, hd % 8 ==
// 0), 2 = blocked (f32, hd % 4 == 0); launched only as planned.
int dcra_flash_attention(const void* q, const void* k, const void* v,
                         void* o, int64_t bh, int32_t s_len, int32_t hd,
                         float scale, int32_t causal, int32_t dtype,
                         const sm90::LaunchPlan* plan, cudaStream_t stream) {
  if (bh <= 0 || s_len <= 0) return (int)cudaGetLastError();
  if (plan == nullptr || hd < 1 || hd > kMaxHd || bh > 65535)
    return (int)cudaErrorInvalidValue;
  if (plan->path == 1) {
    if (dtype != 1 || hd % 8) return (int)cudaErrorInvalidValue;
    return hd <= 64 ? launch_wgmma<64>(q, k, v, o, bh, s_len, hd, scale,
                                       causal, *plan, stream)
                    : launch_wgmma<128>(q, k, v, o, bh, s_len, hd, scale,
                                        causal, *plan, stream);
  }
  if (plan->path == 2) {
    if (dtype != 0 || hd % 4) return (int)cudaErrorInvalidValue;
    return launch_blocked(q, k, v, o, bh, s_len, hd, scale, causal, *plan,
                          stream);
  }
  if (plan->path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_simt<float>(q, k, v, o, bh, s_len, hd, scale, causal,
                              *plan, stream);
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(q, k, v, o, bh, s_len, hd, scale,
                                      causal, *plan, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
