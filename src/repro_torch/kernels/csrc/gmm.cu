// DCRA grouped (expert) matmul for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by repro_torch/kernels/_build.py; launches on the
// caller's stream, allocates nothing and returns a cudaError_t.
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
// thread block reads the group id of its row tile and makes it a
// coordinate of its weight loads. No pass over w mixes two experts' rows
// (below). A tile whose group id lies outside [0, E) is written as zeros
// (w is never read out of bounds).
//
// Bound: 2*T*D*F flops. At the MoE layer's expert buckets (T = 204,800
// rows, D = 2048, F = 1024, rt 64) that is 8.6e11 flops: 12.8 ms at the
// card's 67 TFLOP/s of f32 outside the tensor cores, 0.87 ms at the tensor
// cores' 989 TFLOP/s in bf16, against 3.05 GB of x, w and out in f32
// (0.91 ms at 3.35 TB/s) and 1.53 GB in bf16 (0.46 ms): the operations
// bind it in both types.
//
// Three designs, chosen by the wrapper's launch_plan from the dtype and
// the shape (never by a failed launch); each launcher refuses a plan whose
// tile, grid, threads, stages or shared memory differ from its own:
//  * wgmma (bf16; rt % 64 == 0, D and F multiples of 8, 16-byte aligned
//    x and w): one block of three warpgroups per 128 x 256 output tile.
//    The third warpgroup's first thread keeps TMA loads of x [128 or 64,
//    64] and w[g] [64, 256] (as four 64-column boxes) in flight through a
//    4-stage ring of shared memory with full / empty mbarriers; the two
//    consumer warpgroups run wgmma on each stage (x K-major, w[g]
//    MN-major with the transpose bit), one group in flight while the
//    next stage's products are issued. Where the block's two 64-row
//    halves share a group id (always for rt % 128 == 0, and for the
//    dispatch's 64-row tiles inside one expert bucket) each consumer takes
//    64 rows x 256 columns (m64n256k16) and every w tile serves 128 rows;
//    otherwise the block makes one pass a half, the consumers splitting
//    its 256 columns (m64n128k16). Reading w once for 128 rows halves the
//    w bytes each flop pulls through L2 and shared memory. Depth past D
//    and columns past F are zero-filled by TMA. setmaxnreg moves
//    registers from the producer to the consumers.
//  * blocked (f32; rt % 64 == 0, D and F multiples of 4, 16-byte aligned
//    x and w): a register-blocked SIMT GEMM, 64 x 256 output tiles of 256
//    threads, 8 x 8 f32 accumulators a thread fed by float4 reads of
//    shared memory (x stored transposed); depth in steps of 16, each
//    step's 16-byte global loads held in registers while the other
//    shared-memory stage is computed. Plain FMAs, no TF32, so an f32
//    result matches the plain version to f32 rounding.
//  * simt (every other shape, either type): one block per (BM-row tile,
//    64-column tile), BM the largest of 64/32/16/8 dividing rt (so a
//    block reads one expert); each
//    thread keeps a 4 x 4 block of f32 accumulators; operands staged in
//    shared memory as f32 (bf16 widened). Columns past F and depth past
//    D are masked.
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// simt: any shape, f32 or bf16, 4 x 4 accumulators a thread
// ---------------------------------------------------------------------------
constexpr int kBN = 64;   // output columns a block
constexpr int kBK = 16;   // depth a step
constexpr int kTM = 4;    // accumulator rows a thread
constexpr int kTN = 4;    // accumulator columns a thread
// the static shared memory of a BM-row block (its xs and ws below)
template <int BM>
constexpr int kSimtSmem = 4 * kBK * (BM + 1 + kBN);

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
  static_assert(sizeof(xs) + sizeof(ws) == kSimtSmem<BM>);
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

// ---------------------------------------------------------------------------
// blocked: f32, 64 x 256 tiles, 8 x 8 accumulators a thread
// ---------------------------------------------------------------------------
constexpr int kFm = 64, kFn = 256, kFk = 16, kFThreads = 256;
constexpr int kFStages = 2;   // shared-memory stages (the loop's buf ^ 1)
constexpr int kFSmem = 4 * kFStages * kFk * (kFm + kFn);   // xs and ws

__global__ void __launch_bounds__(kFThreads, 2)
    gmm_blocked_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const int32_t* __restrict__ group_ids,
                       float* __restrict__ out, int d, int f, int rt,
                       int n_groups, int n_col_blocks) {
  __shared__ __align__(16) float xs[kFStages][kFk][kFm];   // transposed
  __shared__ __align__(16) float ws[kFStages][kFk][kFn];
  static_assert(sizeof(xs) + sizeof(ws) == kFSmem);
  const int64_t row0 = (int64_t)(blockIdx.x / n_col_blocks) * kFm;
  const int col0 = (blockIdx.x % n_col_blocks) * kFn;
  const int g = group_ids[row0 / rt];
  const bool in_range = g >= 0 && g < n_groups;
  const float* wg = w + (int64_t)(in_range ? g : 0) * d * f;
  const int tid = threadIdx.x;
  // this thread's rows r0..r0+3 and r0+32..r0+35 (a warp's rows, read as
  // broadcasts), columns c0..c0+3 and c0+128..c0+131 (neighbouring lanes
  // on neighbouring float4s)
  const int r0 = 4 * (tid / 32), c0 = 4 * (tid % 32);
  constexpr int rh = 32, ch = 128;
  // this thread's loads: x row lr, depth 4 * lc..; w rows wr + 4i, cols 4 wc..
  const int lr = tid % kFm, lc = tid / kFm;
  const int wr = tid / 64, wc = tid % 64;
  const float* xrow = x + (row0 + lr) * d;
  const bool wcol_ok = col0 + 4 * wc < f;
  float4 xa, wb[4];
  auto load = [&](int k0) {
    xa = k0 + 4 * lc < d
             ? *reinterpret_cast<const float4*>(xrow + k0 + 4 * lc)
             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + wr + 4 * i;
      wb[i] = (k < d && wcol_ok)
                  ? *reinterpret_cast<const float4*>(wg + (int64_t)k * f +
                                                     col0 + 4 * wc)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
    xs[buf][4 * lc + 0][lr] = xa.x;
    xs[buf][4 * lc + 1][lr] = xa.y;
    xs[buf][4 * lc + 2][lr] = xa.z;
    xs[buf][4 * lc + 3][lr] = xa.w;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&ws[buf][wr + 4 * i][4 * wc]) = wb[i];
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int n_k = in_range ? (d + kFk - 1) / kFk : 0;
  if (n_k > 0) {
    load(0);
    stash(0);
  }
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load((kt + 1) * kFk);   // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < kFk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][k][r0]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][k][r0 + rh]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][k][c0]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][k][c0 + ch]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < n_k) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = row0 + r0 + (i < 4 ? i : rh + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + c0 + ch * h;
      if (col < f)
        *reinterpret_cast<float4*>(out + row * f + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: bf16, TMA ring, two consumer warpgroups and one producer
// ---------------------------------------------------------------------------
constexpr int kWm = 128, kWn = 256;   // a block's output tile
constexpr int kWk = 64;               // depth a stage (one 128-byte box row)
constexpr int kWStages = 4;
constexpr int kWThreads = 384;        // consumers: warpgroups 0, 1; producer 2
constexpr int kBox = sm90::kBoxBytes;
constexpr int kWABytes = kWm * kWk * 2;
constexpr int kWBBytes = kWk * kWn * 2;
constexpr int kWStageBytes = kWABytes + kWBBytes;
// tiles, 2 mbarriers a stage, and slack to align the base to 1024 bytes
constexpr int kWSmem =
    kWStages * kWStageBytes + 2 * kWStages * 8 + sm90::kAtomBytes;

// A block owns rows [r0, r0 + 128) and columns [c0, c0 + 256). Where both
// 64-row halves belong to one expert (always when rt % 128 == 0; for rt =
// 64 wherever two neighbouring row tiles share a group id) it makes one
// "wide" pass: each consumer warpgroup 64 rows x 256 columns, sharing every
// w tile. Otherwise it makes one "narrow" pass a half, 64 rows x 256
// columns, the warpgroups splitting the columns. So w is read once for
// 128 rows wherever the layout allows, and a pass never mixes experts.
struct GmmPasses {
  int r0, g0, g1;
  bool wide, two;
  __device__ GmmPasses(const int32_t* group_ids, int64_t t_rows, int rt,
                       int pair) {
    r0 = pair * kWm;
    two = r0 + 64 < t_rows;
    g0 = group_ids[r0 / rt];
    g1 = two ? group_ids[(r0 + 64) / rt] : g0;
    wide = two && g1 == g0;
  }
  __device__ int count() const { return two && !wide ? 2 : 1; }
  __device__ int group(int h) const { return h ? g1 : g0; }
};

__global__ void __launch_bounds__(kWThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const int32_t* __restrict__ group_ids,
                     __nv_bfloat16* __restrict__ out, int64_t t_rows, int d,
                     int f, int rt, int n_groups, int n_col_blocks) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((sm90::kAtomBytes -
                               (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_tiles = smem;                                  // [stage][A]
  uint8_t* b_tiles = smem + kWStages * kWABytes;            // [stage][B]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kWStageBytes);
  uint64_t* empty = full + kWStages;
  const GmmPasses passes(group_ids, t_rows, rt, blockIdx.x / n_col_blocks);
  const int c0 = (blockIdx.x % n_col_blocks) * kWn;
  const int n_k = (d + kWk - 1) / kWk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);      // one arrive a consumer warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int h = 0; h < passes.count(); ++h) {
        const int g = passes.group(h);
        if (g < 0 || g >= n_groups) continue;
        const int rows = passes.wide ? 128 : 64;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kWStages;
          sm90::mbar_wait(&empty[s], ((it / kWStages) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], rows * kWk * 2 + kWBBytes);
          for (int r = 0; r < rows; r += 64)
            sm90::tma_load_2d(a_tiles + s * kWABytes + r * sm90::kSwizzleBytes,
                              &xmap, &full[s], kt * kWk,
                              passes.r0 + 64 * h + r);
          for (int c = 0; c < kWn / 64; ++c)
            sm90::tma_load_3d(b_tiles + s * kWBBytes + c * kBox, &wmap,
                              &full[s], c0 + 64 * c, kt * kWk, g);
        }
      }
    }
  } else {
    // ---- consumers ----
    sm90::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[128];
    float(&half)[64] = *reinterpret_cast<float(*)[64]>(acc);
    int it = 0;
    for (int h = 0; h < passes.count(); ++h) {
      const int g = passes.group(h);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      if (g >= 0 && g < n_groups) {
        // wide: rows 64 wg.., all 256 columns; narrow: the pass's 64 rows,
        // columns 128 wg..
        const int a_off = passes.wide ? wg * 64 * sm90::kSwizzleBytes : 0;
        const int b_off = passes.wide ? 0 : wg * 2 * kBox;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kWStages;
          sm90::mbar_wait(&full[s], (it / kWStages) & 1);
          const uint8_t* a = a_tiles + s * kWABytes + a_off;
          const uint8_t* b = b_tiles + s * kWBBytes + b_off;
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWk / 16; ++kk) {
            const uint64_t da =
                sm90::desc_sw128(a + 32 * kk, 0, sm90::kAtomBytes);
            const uint64_t db = sm90::desc_sw128(
                b + 16 * sm90::kSwizzleBytes * kk, kBox, sm90::kAtomBytes);
            if (passes.wide)
              sm90::wgmma_m64n256k16_ss<1>(acc, da, db, 1);
            else
              sm90::wgmma_m64n128k16_ss<1>(half, da, db, 1);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();          // the previous stage's products
          if (kt > 0 && leader)
            sm90::mbar_arrive(&empty[(it - 1) % kWStages]);
        }
        sm90::wgmma_wait<0>();
        if (leader) sm90::mbar_arrive(&empty[(it - 1) % kWStages]);
      }
      sm90::fence_regs(acc);
      const int64_t row = passes.r0 + 64 * (passes.wide ? wg : h) +
                          16 * warp + lane / 4;
      const int n_cols = passes.wide ? 256 : 128;
      const int col_base = c0 + (passes.wide ? 0 : 128 * wg) + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = col_base + 8 * j;
        if (8 * j < n_cols && col < f) {
          *reinterpret_cast<uint32_t*>(out + row * f + col) =
              sm90::pack_bf16(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(out + (row + 8) * f + col) =
              sm90::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

int launch_wgmma(const void* x, const void* w, const int32_t* gid, void* out,
                 int64_t t_rows, int d, int f, int rt, int n_groups,
                 const sm90::LaunchPlan& plan, cudaStream_t stream) {
  const int n_col_blocks = (f + kWn - 1) / kWn;
  const int64_t blocks = (t_rows + kWm - 1) / kWm * n_col_blocks;
  if (rt % 64 || t_rows % 64 || blocks > 0x7fffffff ||
      !sm90::plan_is(plan, kWm, dim3((unsigned)blocks), kWThreads, kWStages,
                     kWSmem))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)t_rows};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t xbox[2] = {kWk, 64};
  int err = sm90::bf16_map(&xmap, x, 2, xdims, xstrides, xbox);
  if (err) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)f, (cuuint64_t)d,
                               (cuuint64_t)n_groups};
  const cuuint64_t wstrides[2] = {(cuuint64_t)f * 2, (cuuint64_t)d * f * 2};
  const cuuint32_t wbox[3] = {64, kWk, 1};
  err = sm90::bf16_map(&wmap, w, 3, wdims, wstrides, wbox);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err) return err;
  gmm_wgmma_kernel<<<(unsigned)blocks, kWThreads, kWSmem, stream>>>(
      xmap, wmap, gid, static_cast<__nv_bfloat16*>(out), t_rows, d, f, rt,
      n_groups, n_col_blocks);
  return (int)cudaGetLastError();
}

int launch_blocked(const void* x, const void* w, const int32_t* gid,
                   void* out, int64_t t_rows, int d, int f, int rt,
                   int n_groups, const sm90::LaunchPlan& plan,
                   cudaStream_t stream) {
  const int n_col_blocks = (f + kFn - 1) / kFn;
  const int64_t blocks = t_rows / kFm * n_col_blocks;
  if (rt % kFm || blocks > 0x7fffffff ||
      !sm90::plan_is(plan, kFm, dim3((unsigned)blocks), kFThreads, kFStages,
                     kFSmem))
    return (int)cudaErrorInvalidValue;
  gmm_blocked_kernel<<<(unsigned)blocks, kFThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gid,
      static_cast<float*>(out), d, f, rt, n_groups, n_col_blocks);
  return (int)cudaGetLastError();
}

template <typename T, int BM>
int launch_simt_rows(const void* x, const void* w, const int32_t* gid,
                     void* out, int64_t t_rows, int d, int f, int rt,
                     int n_groups, const sm90::LaunchPlan& plan,
                     cudaStream_t stream) {
  const dim3 grid((unsigned)(t_rows / BM), (unsigned)((f + kBN - 1) / kBN));
  if (rt % BM || !sm90::plan_is(plan, BM, grid, BM * 4, 1, kSimtSmem<BM>))
    return (int)cudaErrorInvalidValue;
  gmm_kernel<T, BM><<<grid, BM * 4, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gid,
      static_cast<T*>(out), d, f, rt, n_groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const void* x, const void* w, const int32_t* gid, void* out,
                int64_t t_rows, int d, int f, int rt, int n_groups,
                const sm90::LaunchPlan& plan, cudaStream_t stream) {
  switch (plan.rows) {
    case 64:
      return launch_simt_rows<T, 64>(x, w, gid, out, t_rows, d, f, rt,
                                     n_groups, plan, stream);
    case 32:
      return launch_simt_rows<T, 32>(x, w, gid, out, t_rows, d, f, rt,
                                     n_groups, plan, stream);
    case 16:
      return launch_simt_rows<T, 16>(x, w, gid, out, t_rows, d, f, rt,
                                     n_groups, plan, stream);
    case 8:
      return launch_simt_rows<T, 8>(x, w, gid, out, t_rows, d, f, rt,
                                    n_groups, plan, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [t_rows, d]; w: [n_groups, d, f]; group_ids: [t_rows / rt] int32;
// out: [t_rows, f]; dtype 0 = float32, 1 = bfloat16 (x, w and out alike);
// rt divides t_rows. plan: the wrapper's launch plan, its path 0 = simt
// (rows in {64, 32, 16, 8} dividing rt), 1 = blocked (f32, rt % 64 == 0),
// 2 = wgmma (bf16, rt % 64 == 0); launched only as planned.
int dcra_gmm(const void* x, const void* w, const int32_t* group_ids,
             void* out, int64_t t_rows, int32_t d, int32_t f, int32_t rt,
             int32_t n_groups, int32_t dtype, const sm90::LaunchPlan* plan,
             cudaStream_t stream) {
  if (t_rows <= 0 || f <= 0) return (int)cudaGetLastError();
  if (plan == nullptr || rt <= 0 || t_rows % rt)
    return (int)cudaErrorInvalidValue;
  if (plan->path == 2 && dtype == 1 && d % 8 == 0 && f % 8 == 0)
    return launch_wgmma(x, w, group_ids, out, t_rows, d, f, rt, n_groups,
                        *plan, stream);
  if (plan->path == 1 && dtype == 0 && d % 4 == 0 && f % 4 == 0)
    return launch_blocked(x, w, group_ids, out, t_rows, d, f, rt, n_groups,
                          *plan, stream);
  if (plan->path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_simt<float>(x, w, group_ids, out, t_rows, d, f, rt,
                              n_groups, *plan, stream);
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(x, w, group_ids, out, t_rows, d, f,
                                      rt, n_groups, *plan, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
