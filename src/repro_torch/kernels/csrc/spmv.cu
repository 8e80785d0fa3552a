// DCRA block-sparse-row SpMV kernels for Hopper (sm_90a). Plain C interface,
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
// read like any other, as the TPU kernel reads them. A block column
// outside [0, Ncb) reads as a zero x tile.
//
// Bound: the blocks, 4*BS*BS B a stored block, are read once; x (4*Ncb*BS
// B, read once from HBM: a tile named again comes from L2), block_cols
// (4 B a block) and y (4*BS B a row block) are small beside them. Two
// flops per 4-byte block entry is half a flop a byte, far under the
// card's f32 rate, so the bytes bound it, over 3.35 TB/s. The TPU kernel
// runs the [BS, BS] x [BS] product on the MXU with the x tile fetched by a
// prefetched block-column index; a matrix-vector product has nothing for
// the tensor cores to reuse, so here it is plain FMAs, and what the card
// needs is enough 16-byte loads in flight to cover HBM's latency.
//
// Two designs, chosen by the wrapper's launch_plan from BS and the
// alignment; the entry point refuses a plan whose rows, grid, threads,
// stages or shared memory differ from its own:
//  * split (BS % 4 == 0, 16-byte aligned blocks and x): the Kb loop is cut
//    into `splits` slices, one block of 256 threads per (row block r,
//    slice s), walking k in [s*Kb/splits, (s+1)*Kb/splits). splits is
//    1 where R already gives kTargetBlocks blocks (8 an SM on 132 SMs),
//    else the power of two that reaches them, at most Kb, so no slice is
//    empty: at R = 128 that is 16 slices of 8 blocks, 2,048 blocks in
//    all (two resident an SM, at 128 registers a thread). Each warp owns
//    16 rows of a 128-row pass; for each k a lane reads a float4 of each
//    of its 16 rows (16 independent 16-byte loads in flight, streamed
//    past L1) and the float4 of the x tile it needs
//    (from L2: no shared stage, no __syncthreads), and keeps the 16 row
//    partials in registers across the slice; they are summed over the
//    warp by shuffles once a slice. With one slice the sums are y; with
//    more they go to a [splits, R*BS] scratch that bsr_combine_kernel
//    sums in slice order, so two runs give the same bits (no float
//    atomics).
//  * rowblock (any BS, or unaligned bases): one block of 256 threads per
//    row block: for each k the x tile named by block_cols[r, k] is staged
//    in shared memory, each warp takes rows i = warp, warp + 8, ..., its
//    lanes read row i of the [BS, BS] block at consecutive columns
//    (coalesced), multiply by the staged x and reduce with warp shuffles;
//    lane 0 adds the row's partial sum into a per-row accumulator in
//    shared memory, which only that warp touches. At R = 128 its 128
//    blocks of 8 warps hold too few loads in flight (4.0x its bound).
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// rowblock: any BS
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// split: BS % 4 == 0, 16-byte aligned blocks and x
// ---------------------------------------------------------------------------
constexpr int kRowsPerWarp = 16;                   // row partials a lane
constexpr int kPassRows = kRowsPerWarp * kWarps;   // 128 rows a pass
constexpr int64_t kTargetBlocks = 8 * 132;         // 8 blocks an SM

// the launch_plan's slice count (kernels/spmv.py::n_splits)
int64_t n_splits(int64_t r, int64_t kb) {
  if (kb < 1 || r >= kTargetBlocks) return 1;
  const int64_t want = (kTargetBlocks + r - 1) / r;
  int64_t p = 1;
  while (p < want) p <<= 1;
  return p < kb ? p : kb;
}

__global__ void __launch_bounds__(kThreads, 2)
    bsr_split_kernel(const int32_t* __restrict__ block_cols,
                     const float* __restrict__ blocks,
                     const float* __restrict__ x, int64_t kb, int bs,
                     int64_t ncb, int splits, float* __restrict__ out,
                     int64_t out_stride) {
  const int64_t r = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int64_t k_lo = s * kb / splits, k_hi = (s + 1) * kb / splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = bs / 4;                           // float4 a row
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float* dst = out + s * out_stride + r * bs;
  for (int pass = 0; pass < bs; pass += kPassRows) {
    const int row0 = pass + warp * kRowsPerWarp;   // rows row0..row0+15
    float part[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) part[u] = 0.0f;
    for (int64_t k = k_lo; k < k_hi; ++k) {
      const int64_t c = block_cols[r * kb + k];
      const bool in_range = c >= 0 && c < ncb;
      const float4* a = reinterpret_cast<const float4*>(
          blocks + ((r * kb + k) * bs + row0) * (int64_t)bs);
      for (int ch = lane; ch < nc; ch += 32) {
        float4 av[kRowsPerWarp];
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u)
          av[u] = row0 + u < bs ? __ldcs(a + (int64_t)u * nc + ch)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 xv = in_range ? __ldg(x4 + c * nc + ch)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u) {
          part[u] = fmaf(av[u].x, xv.x, part[u]);
          part[u] = fmaf(av[u].y, xv.y, part[u]);
          part[u] = fmaf(av[u].z, xv.z, part[u]);
          part[u] = fmaf(av[u].w, xv.w, part[u]);
        }
      }
    }
    float mine = 0.0f;                 // lane u keeps row row0 + u's sum
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      float t = part[u];
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == u) mine = t;
    }
    if (lane < kRowsPerWarp && row0 + lane < bs) dst[row0 + lane] = mine;
  }
}

// y[i] = sum over the slices, in slice order
__global__ void bsr_combine_kernel(const float* __restrict__ scratch,
                                   int splits, int64_t n,
                                   float* __restrict__ y) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = scratch[i];
  for (int s = 1; s < splits; ++s) sum += scratch[s * n + i];
  y[i] = sum;
}

int launch_split(const int32_t* block_cols, const float* blocks,
                 const float* x, int64_t r, int64_t kb, int bs, int64_t ncb,
                 float* y, float* scratch, const sm90::LaunchPlan& plan,
                 cudaStream_t stream) {
  const int64_t splits = n_splits(r, kb);
  if (!sm90::plan_is(plan, kPassRows, dim3((unsigned)(r * splits)), kThreads,
                     1, 0))
    return (int)cudaErrorInvalidValue;
  if (bs % 4 || (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t n = r * bs;
  bsr_split_kernel<<<(unsigned)(r * splits), kThreads, 0, stream>>>(
      block_cols, blocks, x, kb, bs, ncb, (int)splits,
      splits > 1 ? scratch : y, n);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bsr_combine_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(scratch, (int)splits, n, y);
  }
  return (int)cudaGetLastError();
}

int launch_rowblock(const int32_t* block_cols, const float* blocks,
                    const float* x, int64_t r, int64_t kb, int bs,
                    int64_t ncb, float* y, const sm90::LaunchPlan& plan,
                    cudaStream_t stream) {
  const size_t smem = 2 * (size_t)bs * sizeof(float);
  if (!sm90::plan_is(plan, bs, dim3((unsigned)r), kThreads, 1, smem))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_spmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bsr_spmv_kernel<<<(unsigned)r, kThreads, smem, stream>>>(
      block_cols, blocks, x, kb, bs, ncb, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// block_cols: [r, kb] int32; blocks: [r, kb, bs, bs] f32; x: [ncb * bs] f32;
// y: [r * bs] f32; scratch: [splits, r * bs] f32 where the split plan has
// more than one slice (else unused). plan: the wrapper's launch plan, its
// path 0 = rowblock, 1 = split (bs % 4 == 0); launched only as planned.
int dcra_bsr_spmv(const int32_t* block_cols, const float* blocks,
                  const float* x, int64_t r, int64_t kb, int32_t bs,
                  int64_t ncb, float* y, float* scratch,
                  const sm90::LaunchPlan* plan, cudaStream_t stream) {
  if (r <= 0 || bs <= 0) return (int)cudaGetLastError();
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  if (plan->path == 1)
    return launch_split(block_cols, blocks, x, r, kb, bs, ncb, y, scratch,
                        *plan, stream);
  if (plan->path == 0)
    return launch_rowblock(block_cols, blocks, x, r, kb, bs, ncb, y, *plan,
                           stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
