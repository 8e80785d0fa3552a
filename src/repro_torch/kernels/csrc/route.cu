// DCRA routing kernels for Hopper (sm_90a): the three kernels of the
// owner-routed round, over S virtual shards stacked on the leading
// dimension of one card. Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py; every entry launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdcra_route.so route.cu
//
// All three are memory-bound: each task is a handful of bytes and a few
// integer operations, so the bound is bytes over the card's 3.35 TB/s.
// Offsets into the [S, ...] arrays are computed in int64: at RMAT-22 on
// 64 shards the bucket arrays hold ~5e8 slots, near 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRankTile = 1024;               // tasks per block, one a thread
constexpr int kRankWarps = kRankTile / 32;
constexpr int kThreads = 256;                 // scatter / reduce / fill

// ---------------------------------------------------------------------------
// bucket_rank — replaces src/repro/kernels/route.py:bucket_rank_pallas
// (_rank_kernel). pos[s, i] = number of valid j < i in shard s with
// dest[s, j] == dest[s, i]; 0 for an invalid task.
//
// Bound: reads dest (4 B) + valid (1 B), writes pos (4 B) per task.
// The TPU kernel walks the tiles in order and carries the per-destination
// counts in VMEM; blocks on Hopper run in no order, and atomic counters
// would give an arbitrary, not a stable, rank. So: pass 1 counts each
// destination per 1024-task tile (shared-memory atomics), pass 2 turns
// the [S, B, tiles] counts into exclusive prefixes over tiles (one warp
// per (shard, destination) row), pass 3 ranks within the tile with
// __match_any_sync + popc of the lower lanes, plus the counts of the
// earlier warps of the tile. Passes 1 and 3 read the tasks once each;
// the tile counts are S*B*N/1024 ints, a small fraction of the stream.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int32_t task_dest(const int32_t* dest,
                                             const uint8_t* valid, int64_t g,
                                             int nb) {
  const int32_t d = dest[g];
  return (valid[g] && d >= 0 && d < nb) ? d : -1;
}

__global__ void rank_count_kernel(const int32_t* __restrict__ dest,
                                  const uint8_t* __restrict__ valid,
                                  int64_t n, int nb, int tiles,
                                  int32_t* __restrict__ tile_counts) {
  extern __shared__ int32_t cnt[];                         // [nb]
  const int t = blockIdx.x, s = blockIdx.y;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  const int64_t i = (int64_t)t * kRankTile + threadIdx.x;
  if (i < n) {
    const int32_t d = task_dest(dest, valid, (int64_t)s * n + i, nb);
    if (d >= 0) atomicAdd(&cnt[d], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    tile_counts[((int64_t)s * nb + b) * tiles + t] = cnt[b];
}

__global__ void rank_scan_kernel(int32_t* __restrict__ tile_counts,
                                 int64_t rows, int tiles) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32)
                      + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                                 // whole warp
  int32_t* p = tile_counts + row * tiles;
  int32_t carry = 0;
  for (int base = 0; base < tiles; base += 32) {
    const int k = base + lane;
    const int32_t v = k < tiles ? p[k] : 0;
    int32_t x = v;                                         // inclusive scan
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (k < tiles) p[k] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
}

__global__ void rank_kernel(const int32_t* __restrict__ dest,
                            const uint8_t* __restrict__ valid,
                            int64_t n, int nb, int tiles,
                            const int32_t* __restrict__ tile_base,
                            int32_t* __restrict__ pos) {
  extern __shared__ int32_t wcnt[];                        // [warps, nb]
  const int t = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kRankWarps * nb; k += blockDim.x) wcnt[k] = 0;
  __syncthreads();
  const int64_t i = (int64_t)t * kRankTile + threadIdx.x;
  const int32_t d = i < n ? task_dest(dest, valid, (int64_t)s * n + i, nb)
                          : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const unsigned lower = peers & ((1u << lane) - 1u);
  if (d >= 0 && lower == 0) wcnt[warp * nb + d] = __popc(peers);
  __syncthreads();
  if (i < n) {
    int32_t r = 0;
    if (d >= 0) {
      r = tile_base[((int64_t)s * nb + d) * tiles + t] + __popc(lower);
      for (int w = 0; w < warp; ++w) r += wcnt[w * nb + d];
    }
    pos[(int64_t)s * n + i] = r;
  }
}

// ---------------------------------------------------------------------------
// bucket_scatter — replaces src/repro/kernels/route.py:bucket_scatter_pallas
// (_scatter_kernel). With the stable rank from bucket_rank, a kept task
// (valid, rank < cap) owns slot dest*cap + rank of its shard's [B*cap]
// buckets outright, so the rows are plain stores: no atomics on the data.
// Empty slots hold 0 (xb) and -1 (ints), written by fill_kernel first.
//
// Bound: reads x (4*D B), dest, valid, rank, aux (4*k B) per task and
// writes xb, ints and task_slot; the fill writes the whole [S, B*cap]
// buffers once, which at capacity factor 4 is the larger share. The drop
// count is a block-wide __syncthreads_count and one atomicAdd per block.
// ---------------------------------------------------------------------------

__global__ void fill_kernel(int32_t* __restrict__ p, int64_t count,
                            int32_t value) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride)
    p[i] = value;
}

__global__ void scatter_kernel(const float* __restrict__ x,
                               const int32_t* __restrict__ dest,
                               const uint8_t* __restrict__ valid,
                               const int32_t* __restrict__ aux,
                               const int32_t* __restrict__ rank,
                               int64_t n, int d_cols, int k, int nb,
                               int64_t cap, int n_shards,
                               float* __restrict__ xb,
                               int32_t* __restrict__ ints,
                               int32_t* __restrict__ task_slot,
                               int32_t* __restrict__ n_drop) {
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)nb * cap;
  int dropped = 0;
  if (i < n) {
    const int64_t g = (int64_t)s * n + i;
    const int32_t d = task_dest(dest, valid, g, nb);
    const int32_t r = rank[g];
    int32_t out = -1;
    if (d >= 0 && r < cap) {
      const int64_t slot = (int64_t)d * cap + r;
      const int64_t o = (int64_t)s * total + slot;
      for (int c = 0; c < d_cols; ++c)
        xb[o * d_cols + c] = x[g * d_cols + c];
      for (int j = 0; j < k; ++j)
        ints[((int64_t)j * n_shards + s) * total + slot] =
            aux[((int64_t)j * n_shards + s) * n + i];
      out = (int32_t)slot;
    }
    task_slot[g] = out;
    dropped = d >= 0 && out < 0;
  }
  const int block_drops = __syncthreads_count(dropped);
  if (threadIdx.x == 0 && block_drops) atomicAdd(&n_drop[s], block_drops);
}

// ---------------------------------------------------------------------------
// reduce_received — replaces src/repro/kernels/route.py:
// reduce_received_pallas (_reduce_kernel). Folds (slot, value) into
// y[S, n_local] by add / min / store (max value wins).
//
// Bound: reads slot + value (8 B) per received entry, writes y once.
// The TPU kernel folds the stream in order; here every entry is one
// atomic. There is no float atomicMin, so min/store map the f32 bits to
// an order-preserving int32 (b >= 0 ? b : b ^ 0x7fffffff), run
// atomicMin / atomicMax on it, and a finish pass maps back and applies
// route.py:386-390 (a non-finite min reads +inf, a non-finite store 0).
// min and store are exact whatever the order; add is an f32 atomicAdd,
// whose order varies from run to run.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int32_t f2ord(float f) {
  const int32_t b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float ord2f(int32_t o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

constexpr int kAdd = 0, kMin = 1, kStore = 2;

__global__ void reduce_init_kernel(int32_t* __restrict__ y, int64_t count,
                                   int32_t value) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride)
    y[i] = value;
}

template <int OP>
__global__ void reduce_kernel(const int32_t* __restrict__ slot,
                              const float* __restrict__ val, int64_t m,
                              int64_t n_local, int32_t* __restrict__ y) {
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t g = (int64_t)s * m + i;
  const int32_t q = slot[g];
  if (q < 0 || q >= n_local) return;
  int32_t* out = y + (int64_t)s * n_local + q;
  const float v = val[g];
  if (OP == kAdd) atomicAdd(reinterpret_cast<float*>(out), v);
  else if (OP == kMin) atomicMin(out, f2ord(v));
  else atomicMax(out, f2ord(v));
}

template <int OP>
__global__ void reduce_finish_kernel(int32_t* __restrict__ y,
                                     int64_t count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float f = ord2f(y[i]);
  if (!isfinite(f)) f = OP == kMin ? __int_as_float(0x7f800000) : 0.0f;
  y[i] = __float_as_int(f);
}

inline unsigned blocks_for(int64_t count, int threads) {
  return (unsigned)((count + threads - 1) / threads);
}

inline unsigned fill_blocks(int64_t count) {
  const int64_t b = (count + kThreads - 1) / kThreads;
  return (unsigned)(b < 65536 ? b : 65536);
}

inline int32_t host_f2ord(float f) {
  int32_t b;
  static_assert(sizeof(b) == sizeof(f), "f32");
  __builtin_memcpy(&b, &f, sizeof(b));
  return b >= 0 ? b : b ^ 0x7fffffff;
}

}  // namespace

extern "C" {

int dcra_rank_tile(void) { return kRankTile; }

// dest, valid, pos: [n_shards, n]; tile_counts: scratch [n_shards, nb, tiles]
// with tiles = ceil(n / dcra_rank_tile()).
int dcra_bucket_rank(const int32_t* dest, const uint8_t* valid,
                     int64_t n_shards, int64_t n, int32_t nb,
                     int32_t* tile_counts, int32_t* pos,
                     cudaStream_t stream) {
  if (n_shards == 0 || n == 0) return (int)cudaGetLastError();
  const int tiles = (int)((n + kRankTile - 1) / kRankTile);
  const dim3 grid(tiles, (unsigned)n_shards);
  rank_count_kernel<<<grid, kRankTile, nb * sizeof(int32_t), stream>>>(
      dest, valid, n, nb, tiles, tile_counts);
  const int64_t rows = n_shards * nb;
  const int warps_per_block = kThreads / 32;
  rank_scan_kernel<<<blocks_for(rows, warps_per_block), kThreads, 0,
                     stream>>>(tile_counts, rows, tiles);
  const size_t smem = (size_t)kRankWarps * nb * sizeof(int32_t);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(rank_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  rank_kernel<<<grid, kRankTile, smem, stream>>>(dest, valid, n, nb, tiles,
                                                 tile_counts, pos);
  return (int)cudaGetLastError();
}

// x: [n_shards, n, d_cols] f32; dest, valid, rank: [n_shards, n];
// aux: [k, n_shards, n] i32; xb: [n_shards, nb*cap, d_cols];
// ints: [k, n_shards, nb*cap]; task_slot: [n_shards, n]; n_drop: [n_shards].
// rank must come from dcra_bucket_rank on the same dest/valid.
int dcra_bucket_scatter(const float* x, const int32_t* dest,
                        const uint8_t* valid, const int32_t* aux,
                        const int32_t* rank, int64_t n_shards, int64_t n,
                        int32_t d_cols, int32_t k, int32_t nb, int64_t cap,
                        float* xb, int32_t* ints, int32_t* task_slot,
                        int32_t* n_drop, cudaStream_t stream) {
  const int64_t slots = n_shards * (int64_t)nb * cap;
  if (slots * d_cols > 0)
    fill_kernel<<<fill_blocks(slots * d_cols), kThreads, 0, stream>>>(
        reinterpret_cast<int32_t*>(xb), slots * d_cols, 0);
  if (slots * k > 0)
    fill_kernel<<<fill_blocks(slots * k), kThreads, 0, stream>>>(
        ints, slots * k, -1);
  if (n_shards > 0)
    fill_kernel<<<1, kThreads, 0, stream>>>(n_drop, n_shards, 0);
  if (n_shards > 0 && n > 0) {
    const dim3 grid(blocks_for(n, kThreads), (unsigned)n_shards);
    scatter_kernel<<<grid, kThreads, 0, stream>>>(
        x, dest, valid, aux, rank, n, d_cols, k, nb, cap, (int)n_shards, xb,
        ints, task_slot, n_drop);
  }
  return (int)cudaGetLastError();
}

// slot, val: [n_shards, m]; y: [n_shards, n_local] f32. op: 0 add,
// 1 min, 2 store.
int dcra_reduce_received(const int32_t* slot, const float* val,
                         int64_t n_shards, int64_t m, int64_t n_local,
                         int32_t op, float* y, cudaStream_t stream) {
  int32_t* yi = reinterpret_cast<int32_t*>(y);
  const int64_t count = n_shards * n_local;
  const float inf = __builtin_huge_valf();
  const int32_t init = op == kAdd ? 0 : host_f2ord(op == kMin ? inf : -inf);
  if (count > 0)
    reduce_init_kernel<<<fill_blocks(count), kThreads, 0, stream>>>(
        yi, count, init);
  if (count > 0 && m > 0) {
    const dim3 grid(blocks_for(m, kThreads), (unsigned)n_shards);
    if (op == kAdd)
      reduce_kernel<kAdd><<<grid, kThreads, 0, stream>>>(slot, val, m,
                                                         n_local, yi);
    else if (op == kMin)
      reduce_kernel<kMin><<<grid, kThreads, 0, stream>>>(slot, val, m,
                                                         n_local, yi);
    else
      reduce_kernel<kStore><<<grid, kThreads, 0, stream>>>(slot, val, m,
                                                           n_local, yi);
  }
  if (count > 0 && op == kMin)
    reduce_finish_kernel<kMin><<<blocks_for(count, kThreads), kThreads, 0,
                                 stream>>>(yi, count);
  if (count > 0 && op == kStore)
    reduce_finish_kernel<kStore><<<blocks_for(count, kThreads), kThreads, 0,
                                   stream>>>(yi, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
