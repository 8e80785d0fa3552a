// DCRA routing kernels for Hopper (sm_90a): the kernels of the
// owner-routed round, over S virtual shards stacked on the leading
// dimension of one card. Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py; every entry launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdcra_route.so route.cu
//
// All of them are memory-bound: each task is a handful of bytes and a few
// integer operations, so the bound is bytes over the card's 3.35 TB/s.
// Offsets into the [S, ...] arrays are computed in int64: at RMAT-22 on
// 64 shards the bucket arrays hold ~5.7e8 slots.
//
// Each entry point launches the design of the wrapper's launch plan
// (kernels/route.py), chosen from the inputs alone, and refuses a plan
// whose rows, grid, threads, stages or shared memory differ from the
// geometry it computes (sm90::plan_is). bucket_rank has one design,
// lookback (one pass, decoupled look-back); the others have two each:
//  * bucket_scatter: staged (rank, capacity test and scatter fused, every
//    slot written once) or ranked (the bucket_rank kernel, a fill of every
//    slot, then one store a kept task);
//  * reduce_received: private (per-block copies of the outputs in shared
//    memory, for small n_local) or atomic (one global atomic an entry).
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;                 // scatter / reduce / fill
constexpr int64_t kSmemLimit = 232448;        // a block's shared memory
constexpr int kTargetBlocks = 8 * 132;        // 8 blocks on each of 132 SMs

// the lanes of the warp whose key equals this lane's (key < 2^bits)
__device__ __forceinline__ unsigned warp_peers(int key, int bits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool set = (key >> b) & 1;
    const unsigned vote = __ballot_sync(0xffffffffu, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

__device__ __forceinline__ int32_t task_dest(const int32_t* dest,
                                             const uint8_t* valid, int64_t g,
                                             int nb) {
  const int32_t d = dest[g];
  return (valid[g] && d >= 0 && d < nb) ? d : -1;
}

// ---------------------------------------------------------------------------
// bucket_rank — replaces src/repro/kernels/route.py:bucket_rank_pallas
// (_rank_kernel). pos[s, i] = number of valid j < i in shard s with
// dest[s, j] == dest[s, i]; 0 for an invalid task or a dest outside
// [0, nb).
//
// Bound: reads dest (4 B) + valid (1 B), writes pos (4 B) per task: 9 B.
// The TPU kernel walks the tiles in order and carries the per-destination
// counts in VMEM. Blocks on Hopper run in no order, and an atomic counter
// a bucket would give an arbitrary rank, not a stable one. So one pass
// with decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016), one counter a bucket:
//  * a block takes the next tile of 4096 tasks from an atomic counter
//    (not blockIdx), so it only ever waits on tiles that blocks already
//    running hold; each shard's tiles form their own chain, and the
//    shards' chains interleave in that order (tile t of shard s is the
//    (t * S + s)-th), so a tile's predecessor started S tiles earlier
//    and has mostly published its inclusive prefix already;
//  * a warp loads its 512 tasks as int4 (dest) and 4-byte words (valid),
//    restages the keys through shared memory so that lane l holds tasks
//    32k + l, and ranks them stably: a ballot of valid at nb == 1,
//    ballots of the key bits (warp_peers) and a per-warp running count a
//    bucket in shared memory above; an exclusive scan of the 8 warps'
//    counts gives each warp's base and the tile's aggregate;
//  * the block publishes the aggregate (AGGREGATE flag; tile 0 its
//    inclusive prefix at once), warp 0 walks back over the predecessors'
//    flags 32 at a time until an INCLUSIVE one, waiting only while a
//    flag in its way reads 0, the block sums the aggregates it passed
//    and that prefix (every bucket, its threads sharing the tiles and
//    the buckets), publishes its own inclusive prefix, and stores pos
//    coalesced. The ranks wait in shared memory, packed with their keys
//    in place of the keys, so a block holds 16 tasks a thread in few
//    registers (8 blocks an SM at one bucket, 5 above).
// A tile's flag sits in a 64-bit status word, written with st.release.gpu
// and read with ld.acquire.gpu. At one bucket the word also holds the
// count, so one load reads both. Above it, one flag guards the tile's nb
// values: the block's threads write them with st.cg, a barrier, then
// thread 0's st.release.gpu (a gpu-scope release fence and the store;
// the barrier puts the block's writes before it, the pattern of a
// grid-wide barrier); on the other side lane 0's ld.acquire.gpu, a
// barrier, and the block reads the values with ld.cg, which bypasses
// the L1 (a weak load could return a stale line there). The prefixes are
// int32, the aggregates uint16 (at most a tile), read 8 buckets a 16-byte
// load, four loads in flight a thread. The task stream is read once; the
// status, 8 B a tile and about 6*nb B more above one bucket, is the only
// extra traffic. Tiles start on a 16-byte boundary of dest (a shard's
// first tile is shorter by the row's misalignment), so a view at any
// offset whose dest and valid sit equally off 16 bytes still takes the
// vector loads; other views take scalar loads at the same positions. The
// ranked design of bucket_scatter runs it; the staged one ranks in its
// own passes.
// ---------------------------------------------------------------------------

constexpr int kRankTile = 4096;               // tasks a tile, one block each
constexpr int kMaxBuckets = 1024;             // route.MAX_BUCKETS
constexpr int64_t kRankMaxTasks = (int64_t(1) << 31) - 2 * 4096;  // a row
constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankItems = kRankTile / kRankThreads;     // 16 a thread
constexpr int kRankRun = kRankTile / kRankWarps;         // 512 a warp
constexpr int kRankLoads = kRankItems / 4;               // int4 a lane
constexpr int32_t kAggregate = 1, kInclusive = 2;        // tile flags
constexpr int kKeyBits = 11;                  // key + 1 <= kMaxBuckets

constexpr int kRankParts = 8 * kRankThreads;  // look-back partial sums

// keys, then ranks [T], per-warp counts [warps, nb], the tile's
// aggregate and exclusive prefix [2, nb], above one bucket the
// look-back's partial sums [8 * threads], tile id and the nearest
// inclusive tile [4]
inline int64_t rank_smem(int nb) {
  return 4 * ((int64_t)kRankTile + (int64_t)(kRankWarps + 2) * nb +
              (nb > 1 ? kRankParts : 0) + 4);
}

inline int64_t rank_tiles(int64_t n) {
  return n > 0 ? (n + 3 + kRankTile - 1) / kRankTile : 0;
}

// int32 ahead of the per-bucket arrays: the counter, a pad, a 64-bit
// status word a tile (all zeroed a launch); above one bucket an int32
// inclusive prefix and a uint16 aggregate (at most a tile's 4096) a
// bucket a tile follow
__host__ __device__ inline int64_t rank_status_ints(int64_t n_tiles) {
  return 2 + 2 * n_tiles;
}

// the int32 offset of the uint16 aggregates: after the words and the
// inclusive prefixes, on a 16-byte boundary; a tile's row of them is
// padded to a multiple of 8 buckets (16 bytes), read 8 at a time
__host__ __device__ inline int64_t rank_aggs_offset(int64_t n_tiles, int nb) {
  return (rank_status_ints(n_tiles) + n_tiles * nb + 3) & ~int64_t(3);
}

__host__ __device__ inline int rank_agg_row(int nb) { return (nb + 7) & ~7; }

// a tile's status word: its flag in the high half and, at one bucket, its
// count (aggregate or inclusive prefix) in the low half, so one load
// reads both
__device__ __forceinline__ uint64_t status_word(int32_t flag, int32_t v) {
  return (uint64_t)(uint32_t)flag << 32 | (uint32_t)v;
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void add8(int32_t (&acc)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc[2 * u] += w[u] & 0xffff;
    acc[2 * u + 1] += w[u] >> 16;
  }
}

// the aggregates a[j * row + 8 grp + u], u < 8, of tiles j = j0, j0 +
// step, ... below t, summed into acc: one 16-byte load a tile (a 16-byte
// aligned, row % 8 == 0), four in flight
__device__ __forceinline__ void sum_aggs8(const uint16_t* a, int row, int grp,
                                          int j, int t, int step,
                                          int32_t (&acc)[8]) {
  const uint4* col = reinterpret_cast<const uint4*>(a) + grp;
  const int64_t stride = row / 8;
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 0;
  for (; j + 3 * step < t; j += 4 * step) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldcg(col + (j + u * step) * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) add8(acc, v[u]);
  }
  for (; j < t; j += step) add8(acc, __ldcg(col + j * stride));
}

// status: [1] tile counter, [1] pad, [S * tiles] status words, then at
// nb > 1 [S * tiles, nb] int32 inclusive prefixes and [S * tiles, nb
// padded to 8] uint16 aggregates; counter and words zeroed before the
// launch. vec: dest and
// valid sit equally far (shift elements) off a 16-byte boundary, so tiles
// start on one and take vector loads.
template <bool ONE>
__global__ void __launch_bounds__(kRankThreads, ONE ? 8 : 5)
rank_lookback_kernel(const int32_t* __restrict__ dest,
                     const uint8_t* __restrict__ valid, int n, int nb,
                     int key_bits, int tiles, int n_shards, bool vec,
                     int shift, int32_t* __restrict__ status,
                     int32_t* __restrict__ pos) {
  extern __shared__ int32_t sm[];
  int32_t* keys = sm;                                      // [T]
  int32_t* wcnt = keys + kRankTile;                        // [warps, nb]
  int32_t* agg = wcnt + kRankWarps * nb;                   // [nb]
  int32_t* excl = agg + nb;                                // [nb]
  int32_t* part = excl + nb;                               // [8 * threads]
  int32_t* misc = part + (ONE ? 0 : kRankParts);           // [4]
  const int64_t n_tiles = (int64_t)n_shards * tiles;
  uint64_t* words = reinterpret_cast<uint64_t*>(status + 2);
  int32_t* incls = status + rank_status_ints(n_tiles);     // [tiles, nb]
  uint16_t* aggs =
      reinterpret_cast<uint16_t*>(status + rank_aggs_offset(n_tiles, nb));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) misc[0] = atomicAdd(status, 1);
  if (!ONE)
    for (int i = threadIdx.x; i < kRankWarps * nb; i += kRankThreads)
      wcnt[i] = 0;
  __syncthreads();
  // tile t of shard s is the block's (g = t * S + s)-th: the shards'
  // chains interleave, so a tile's predecessor started S tiles earlier
  const int g = misc[0];
  const int s = g % n_shards, t = g / n_shards;
  const int64_t me = (int64_t)s * tiles + t;               // status index
  const int64_t row = (int64_t)s * n;
  dest += row, valid += row, pos += row;
  // the row index of the tile's position 0: tiles start where dest does
  // on a 16-byte boundary
  const int first = t * kRankTile - (vec ? (int)((shift + row) & 3) : 0);

  // this lane's 16 tasks: loads r at run positions 128r + 4l + j
  int32_t dv[kRankItems];
  uint32_t vv[kRankLoads];
#pragma unroll
  for (int r = 0; r < kRankLoads; ++r) {
    const int i = first + warp * kRankRun + r * 128 + lane * 4;
    if (vec && i >= 0 && i + 4 <= n) {
      const int4 d4 = __ldg(reinterpret_cast<const int4*>(dest + i));
      vv[r] = __ldg(reinterpret_cast<const uint32_t*>(valid + i));
      dv[4 * r] = d4.x, dv[4 * r + 1] = d4.y, dv[4 * r + 2] = d4.z;
      dv[4 * r + 3] = d4.w;
    } else {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = i + j >= 0 && i + j < n;
        dv[4 * r + j] = in ? __ldg(dest + i + j) : -1;
        v |= (uint32_t)(in ? __ldg(valid + i + j) : 0) << (8 * j);
      }
      vv[r] = v;
    }
  }
  // keys (-1: not ranked) to shared memory, read back striped below: lane
  // l takes the warp's tasks 32k + l, k = 0..15, in array order
  int32_t* run = keys + warp * kRankRun;
#pragma unroll
  for (int r = 0; r < kRankLoads; ++r) {
    int32_t k4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t d = dv[4 * r + j];
      k4[j] = ((vv[r] >> (8 * j)) & 0xff) && d >= 0 && d < nb ? d : -1;
    }
    *reinterpret_cast<int4*>(run + r * 128 + lane * 4) =
        make_int4(k4[0], k4[1], k4[2], k4[3]);
  }
  __syncwarp();

  // the rank within the warp's run (earlier rounds + lower peers), packed
  // in place of its key: one bucket, the rank or -1; more, rank << 11 |
  // key + 1 (each lane rewrites only its own entries)
  const unsigned lower = (1u << lane) - 1u;
  if (ONE) {
    int32_t count = 0;
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) {
      const bool on = run[k * 32 + lane] >= 0;
      const unsigned peers = __ballot_sync(0xffffffffu, on);
      run[k * 32 + lane] = on ? count + __popc(peers & lower) : -1;
      count += __popc(peers);
    }
    if (lane == 0) wcnt[warp] = count;
  } else {
    int32_t* mine = wcnt + warp * nb;
#pragma unroll
    for (int k = 0; k < kRankItems; ++k) {
      const int32_t key = run[k * 32 + lane];
      const unsigned peers = warp_peers(key + 1, key_bits);
      const int32_t prior = key >= 0 ? mine[key] : 0;
      __syncwarp();
      if (key >= 0 && (peers & lower) == 0) mine[key] = prior + __popc(peers);
      __syncwarp();
      run[k * 32 + lane] =
          (prior + __popc(peers & lower)) << kKeyBits | (key + 1);
    }
  }
  __syncthreads();

  // each bucket: the warps' exclusive prefix and the tile's aggregate,
  // published (tile 0: as its inclusive prefix) by one release store of
  // thread 0 after the block's value stores (the barrier orders them)
  for (int b = threadIdx.x; b < nb; b += kRankThreads) {
    int32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kRankWarps; ++w) {
      const int32_t c = wcnt[w * nb + b];
      wcnt[w * nb + b] = sum;
      sum += c;
    }
    agg[b] = sum;
    if (t == 0) excl[b] = 0;
    if (!ONE && t == 0) __stcg(incls + me * nb + b, sum);
    if (!ONE && t > 0)
      __stcg(aggs + me * rank_agg_row(nb) + b, (uint16_t)sum);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    st_release(words + me, status_word(t == 0 ? kInclusive : kAggregate,
                                      ONE ? agg[0] : 0));

  if (t > 0) {
    // warp 0 walks back 32 tiles at a time: lane l reads tile lo - l. The
    // window counts once every tile from lo to the nearest inclusive one
    // has published. Lanes before the shard's first tile read as
    // inclusive; tile 0 publishes its inclusive prefix at once, so the
    // walk ends there at the latest and never counts them.
    if (warp == 0) {
      const uint64_t* row_words = words + (int64_t)s * tiles;
      int lo = t - 1;
      int32_t sum = 0;
      for (;;) {
        const int j = lo - lane;
        const uint64_t w = j >= 0 ? ld_acquire(row_words + j)
                                  : status_word(kInclusive, 0);
        const int32_t f = (int32_t)(w >> 32);
        const unsigned inc = __ballot_sync(0xffffffffu, f == kInclusive);
        const unsigned zero = __ballot_sync(0xffffffffu, f == 0);
        const unsigned near = inc & (0u - inc);
        const unsigned need = inc ? near | (near - 1u) : 0xffffffffu;
        if (zero & need) {
          __nanosleep(20);
          continue;                 // a predecessor has published nothing
        }
        if (ONE) {
          int32_t v = (need >> lane) & 1 ? (int32_t)(uint32_t)w : 0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          sum += v;
        }
        if (inc) {
          if (lane == 0) {
            misc[1] = lo - (__ffs(inc) - 1);
            if (ONE) {
              excl[0] = sum;
              st_release(words + me, status_word(kInclusive, sum + agg[0]));
            }
          }
          break;
        }
        lo -= 32;
      }
    }
    __syncthreads();
    if (!ONE) {
      // the nearest inclusive prefix k and the aggregates of the span
      // tiles between it and this one (often none: the predecessor, S
      // tiles earlier, has published its prefix): a thread takes a group
      // of 8 buckets (one 16-byte load; the row's padding is summed and
      // never read) and every per-th tile, `per` threads a group (no more
      // than the span), their partial sums through shared memory
      const int k = misc[1], span = t - 1 - k;
      const int row = rank_agg_row(nb), groups = row / 8;
      const int most = groups < kRankThreads ? kRankThreads / groups : 1;
      const int per = span < most ? span : most;
      const uint16_t* ag = aggs + (int64_t)s * tiles * row;
      for (int x = threadIdx.x; x < per * groups; x += kRankThreads) {
        const int grp = x % groups, q = x / groups;
        int32_t acc[8];
        sum_aggs8(ag, row, grp, k + 1 + q, t, per, acc);
#pragma unroll
        for (int u = 0; u < 8; ++u) part[q * row + grp * 8 + u] = acc[u];
      }
      if (per > 0) __syncthreads();
      const int32_t* at = incls + ((int64_t)s * tiles + k) * nb;
      for (int b = threadIdx.x; b < nb; b += kRankThreads) {
        int32_t e = __ldcg(at + b);
        for (int q = 0; q < per; ++q) e += part[q * row + b];
        excl[b] = e;
        __stcg(incls + me * nb + b, e + agg[b]);
      }
      __syncthreads();
      if (threadIdx.x == 0) st_release(words + me, status_word(kInclusive, 0));
    }
  }

  // pos: the tile's prefix + the earlier warps' counts + the rank in the
  // warp, coalesced (the lanes of a store hold consecutive tasks)
#pragma unroll
  for (int k = 0; k < kRankItems; ++k) {
    const int i = first + warp * kRankRun + k * 32 + lane;
    if (i < 0 || i >= n) continue;
    const int32_t rk = run[k * 32 + lane];
    int32_t out = 0;
    if (ONE) {
      if (rk >= 0) out = excl[0] + wcnt[warp] + rk;
    } else {
      const int32_t key = (rk & ((1 << kKeyBits) - 1)) - 1;
      if (key >= 0) out = excl[key] + wcnt[warp * nb + key] + (rk >> kKeyBits);
    }
    pos[i] = out;
  }
}

// ---------------------------------------------------------------------------
// bucket_scatter — replaces src/repro/kernels/route.py:bucket_scatter_pallas
// (_scatter_kernel). A kept task (valid, stable rank < cap) owns slot
// dest*cap + rank of its shard's [B*cap] buckets outright, so the rows are
// plain stores: no atomics on the data. Empty slots hold 0 (xb) and -1
// (ints); n_drop[s] counts the valid tasks past their bucket's cap.
//
// Bound: reads x (4*D B), dest, valid, aux (4*k B) per task once, writes
// task_slot per task and xb, ints per slot once (17 B a task + 8 B a slot
// + 4 B a shard at D 1, k 1). At the flat BFS round (capacity factor 4)
// the slots are 4.58 of the 7.01 GB, and 3/4 of them are empty.
//
// ranked (payloads too wide to stage, B*cap >= 2^31): bucket_rank writes
// the rank to device memory, fill_kernel writes every slot of xb and
// ints, then scatter_kernel writes each kept task's row again, one 4-byte
// store a thread to scattered addresses; drops are a block-wide
// __syncthreads_count and one atomicAdd per block. Five launches, the
// slots written up to twice, the rank written and read back.
//
// staged (the staging below within a block's shared memory, B*cap <
// 2^31): four launches, the task stream read about 1.3 times (dest and
// valid twice), every slot written once.
//  1. staged_count_kernel, grid (tiles, S): a tile of 2048 tasks, 256
//     threads of 8, each task one shared-memory atomicAdd on its
//     destination's count (faster on the card than a leader adding popc
//     of its peers, and than __match_any_sync). The [B] counts are
//     written coalesced to counts[S, tiles, B].
//  2. staged_scan_kernel, grid S, 1024 threads: for each 32 buckets (one a
//     lane), warp w sums its share of the tiles, the block adds the
//     warps' sums, and warp w rewrites its counts as exclusive prefixes
//     over tiles (tile_base). Bucket totals give lo = min(total, cap) and
//     n_drop[s] = sum_b max(total_b - cap, 0): computed once, no atomics,
//     the same on every run.
//  3. staged_fill_kernel: only the empty slots [lo_b, cap) of each bucket
//     get 0 / -1, in coalesced runs of 16-byte stores, about 16K slots a
//     block (one block a bucket left a long tail of the grid).
//  4. staged_place_kernel, grid (tiles, S): the tile's tasks again, each
//     warp 256 consecutive ones, 32 at a time. A lane finds the lanes of
//     its destination by one __ballot_sync a key bit (warp_peers:
//     ceil(log2(B+1)) ballots, faster than __match_any_sync); the
//     stable rank is tile_base[d] + the tile's earlier warps' counts of d
//     + the running count of the warp's earlier rounds + popc of the
//     lower peers: array order. task_slot is written coalesced. The kept
//     rows (slot, x, aux) are staged in shared memory grouped by bucket
//     (a local counting sort: bucket d's kept tasks of the tile take
//     [loc_d, loc_d + kept_d)), then stored in staging order, so each
//     bucket's run goes to consecutive slots d*cap + tile_base[d] + j and
//     the stores coalesce. A 2048-task tile keeps it at 48 registers (5
//     blocks an SM); 4096 tasks a block held twice the registers and ran
//     slower. Prefetching x and aux with cp.async, or the fill on a second
//     stream beside this kernel, gained nothing in probes on the card.
// The staged kernels read their inputs with coalesced 4-byte (1-byte for
// valid) loads, 8 a thread in flight: tiles start at any task of a
// shard, so 16-byte loads would not line up, and a view at any offset
// takes staged. The 16-byte stores are to the wrapper's fresh outputs,
// whose alignment launch_staged checks.
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

constexpr int kStageTile = 2048;              // tasks a block
constexpr int kStageThreads = 256;
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kStageRounds = kStageTile / kStageThreads;   // tasks a thread
constexpr int kWarpTasks = kStageTile / kStageWarps;       // a warp's run
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int64_t kFillSlots = 16384;         // slots a fill block, about
constexpr int64_t kFillMinSlots = 4096;       // least slots a fill block

// [warps, B] counts, [B] offsets, [B] tile bases, 16 scan ints, then the
// staged rows: [T] slots, [T, D] x, [k, T] aux
inline int64_t staged_smem(int nb, int d_cols, int k) {
  return 4 * ((int64_t)(kStageWarps + 2) * nb + 16 +
              (int64_t)kStageTile * (1 + d_cols + k));
}

// the destinations of this thread's 8 tasks of tile t (-1: none),
// warp w's tasks being [t*T + w*256, t*T + w*256 + 256) in rounds of 32
__device__ __forceinline__ void load_dests(const int32_t* __restrict__ dest,
                                          const uint8_t* __restrict__ valid,
                                          int64_t n, int nb, int64_t g0,
                                          int64_t first,
                                          int32_t (&d)[kStageRounds]) {
  int32_t dv[kStageRounds];
  uint8_t vv[kStageRounds];
#pragma unroll
  for (int r = 0; r < kStageRounds; ++r) {
    const int64_t i = first + r * 32;
    dv[r] = i < n ? __ldg(dest + g0 + i) : -1;
    vv[r] = i < n ? __ldg(valid + g0 + i) : 0;
  }
#pragma unroll
  for (int r = 0; r < kStageRounds; ++r)
    d[r] = (vv[r] && dv[r] >= 0 && dv[r] < nb) ? dv[r] : -1;
}

__global__ void __launch_bounds__(kStageThreads)
staged_count_kernel(const int32_t* __restrict__ dest,
                    const uint8_t* __restrict__ valid, int64_t n, int nb,
                    int64_t tiles,
                    int32_t* __restrict__ counts) {
  extern __shared__ int32_t cnt[];                         // [nb]
  const int64_t t = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  int32_t d[kStageRounds];
  load_dests(dest, valid, n, nb, (int64_t)s * n,
             t * kStageTile + warp * kWarpTasks + lane, d);
#pragma unroll
  for (int r = 0; r < kStageRounds; ++r)
    if (d[r] >= 0) atomicAdd(&cnt[d[r]], 1);
  __syncthreads();
  int32_t* out = counts + ((int64_t)s * tiles + t) * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) out[b] = cnt[b];
}

__global__ void __launch_bounds__(kScanThreads)
staged_scan_kernel(int32_t* __restrict__ counts, int64_t tiles, int nb,
                   int64_t cap, int32_t* __restrict__ lo,
                   int32_t* __restrict__ n_drop) {
  __shared__ int32_t part[kScanWarps][33];
  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t per = (tiles + kScanWarps - 1) / kScanWarps;
  const int64_t t0 = warp * per;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  int32_t* c = counts + (int64_t)s * tiles * nb;
  int64_t drops = 0;
  for (int g = 0; g < nb; g += 32) {
    const int b = g + lane;
    const bool on = b < nb;
    int32_t sum = 0;
    for (int64_t t = t0; t < t1; ++t) sum += on ? c[t * nb + b] : 0;
    part[warp][lane] = sum;
    __syncthreads();
    int32_t run = 0, total = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      const int32_t v = part[w][lane];
      run += w < warp ? v : 0;
      total += v;
    }
    if (on) {
      for (int64_t t = t0; t < t1; ++t) {
        const int32_t v = c[t * nb + b];
        c[t * nb + b] = run;
        run += v;
      }
      if (warp == 0) {
        lo[(int64_t)s * nb + b] = (int32_t)(total < cap ? total : cap);
        drops += total > cap ? total - cap : 0;
      }
    }
    __syncthreads();                      // part is rewritten next group
  }
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1)
      drops += __shfl_xor_sync(0xffffffffu, drops, o);
    if (lane == 0) n_drop[s] = (int32_t)drops;
  }
}

// p[a, e) = v by the block, 16-byte stores where p + i is 16-byte aligned
// (p itself is)
__device__ __forceinline__ void fill_range(int32_t* __restrict__ p,
                                          int64_t a, int64_t e, int32_t v) {
  const int64_t a4 = ((a + 3) & ~int64_t(3)) < e ? (a + 3) & ~int64_t(3) : e;
  const int64_t e4 = (e & ~int64_t(3)) > a4 ? e & ~int64_t(3) : a4;
  for (int64_t i = a + threadIdx.x; i < a4; i += blockDim.x) p[i] = v;
  const int4 v4 = make_int4(v, v, v, v);
  int4* p4 = reinterpret_cast<int4*>(p);
  for (int64_t i = a4 / 4 + threadIdx.x; i < e4 / 4; i += blockDim.x)
    p4[i] = v4;
  for (int64_t i = e4 + threadIdx.x; i < e; i += blockDim.x) p[i] = v;
}

// block q * parts + part fills part `part` of bucket q = s * B + b's
// empty slots [lo[q], cap)
__global__ void __launch_bounds__(kThreads)
staged_fill_kernel(const int32_t* __restrict__ lo, int nb, int64_t cap,
                   int d_cols, int k, int n_shards, int64_t parts,
                   float* __restrict__ xb, int32_t* __restrict__ ints) {
  const int64_t q = blockIdx.x / parts, part = blockIdx.x % parts;
  const int64_t s = q / nb, b = q % nb;
  const int64_t first = lo[q], len = cap - first;
  if (len <= 0) return;
  const int64_t a = first + len * part / parts;
  const int64_t e = first + len * (part + 1) / parts;
  const int64_t total = (int64_t)nb * cap;
  const int64_t row = s * total + b * cap;
  fill_range(reinterpret_cast<int32_t*>(xb), (row + a) * d_cols,
             (row + e) * d_cols, 0);
  for (int j = 0; j < k; ++j) {
    const int64_t off = (int64_t)j * n_shards * total + row;
    fill_range(ints, off + a, off + e, -1);
  }
}

__global__ void __launch_bounds__(kStageThreads)
staged_place_kernel(const float* __restrict__ x,
                    const int32_t* __restrict__ dest,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ aux, int64_t n, int d_cols,
                    int k, int nb, int key_bits, int64_t cap, int n_shards,
                    int64_t tiles, const int32_t* __restrict__ tile_base,
                    float* __restrict__ xb, int32_t* __restrict__ ints,
                    int32_t* __restrict__ task_slot) {
  extern __shared__ int32_t sm[];
  int32_t* wcnt = sm;                                      // [warps, nb]
  int32_t* loc = wcnt + kStageWarps * nb;                  // [nb]
  int32_t* base = loc + nb;                                // [nb]
  int32_t* wsum = base + nb;                               // [16]
  int32_t* st_slot = wsum + 16;                            // [T]
  float* st_x = reinterpret_cast<float*>(st_slot + kStageTile);  // [T, D]
  int32_t* st_aux = reinterpret_cast<int32_t*>(st_x) +
                    (int64_t)kStageTile * d_cols;          // [k, T]
  const int64_t t = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g0 = (int64_t)s * n;
  const int64_t first = t * kStageTile + warp * kWarpTasks + lane;
  for (int i = threadIdx.x; i < kStageWarps * nb; i += blockDim.x) wcnt[i] = 0;
  const int32_t* tb = tile_base + ((int64_t)s * tiles + t) * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) base[b] = tb[b];
  __syncthreads();

  // the rank within the warp's run: earlier rounds + lower peers
  int32_t d[kStageRounds], rk[kStageRounds];
  load_dests(dest, valid, n, nb, g0, first, d);
  int32_t* mine = wcnt + warp * nb;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kStageRounds; ++r) {
    const unsigned peers = warp_peers(d[r] + 1, key_bits);
    const int32_t prior = d[r] >= 0 ? mine[d[r]] : 0;
    __syncwarp();
    if (d[r] >= 0 && (peers & lower) == 0) mine[d[r]] = prior + __popc(peers);
    __syncwarp();
    rk[r] = prior + __popc(peers & lower);
  }
  __syncthreads();

  // per bucket: the earlier warps' counts (exclusive prefix over warps),
  // the tile's kept count, and its staging offset (block scan)
  const int per = (nb + kStageThreads - 1) / kStageThreads;
  const int b0 = threadIdx.x * per;
  int32_t sum = 0;
  for (int j = 0; j < per; ++j) {
    const int b = b0 + j;
    if (b >= nb) break;
    int32_t run = 0;
    for (int w = 0; w < kStageWarps; ++w) {
      const int32_t c = wcnt[w * nb + b];
      wcnt[w * nb + b] = run;
      run += c;
    }
    const int64_t room = cap - base[b];
    const int32_t kept = room <= 0 ? 0 : (room < run ? (int32_t)room : run);
    loc[b] = kept;
    sum += kept;
  }
  int32_t incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int32_t excl = incl - sum, kept_all = 0;
  for (int w = 0; w < kStageWarps; ++w) {
    excl += w < warp ? wsum[w] : 0;
    kept_all += wsum[w];
  }
  for (int j = 0; j < per; ++j) {
    const int b = b0 + j;
    if (b >= nb) break;
    const int32_t kept = loc[b];
    loc[b] = excl;
    excl += kept;
  }
  __syncthreads();

  // task_slot, and each kept row's staging position
  int32_t pos[kStageRounds];
#pragma unroll
  for (int r = 0; r < kStageRounds; ++r) {
    const int64_t i = first + r * 32;
    int32_t out = -1;
    pos[r] = -1;
    if (d[r] >= 0) {
      const int32_t rt = wcnt[warp * nb + d[r]] + rk[r];   // rank in tile
      const int64_t rank = (int64_t)base[d[r]] + rt;
      if (rank < cap) {
        out = (int32_t)((int64_t)d[r] * cap + rank);
        pos[r] = loc[d[r]] + rt;
        st_slot[pos[r]] = out;
      }
    }
    if (i < n) task_slot[g0 + i] = out;
  }
  for (int c = 0; c < d_cols; ++c) {
    float v[kStageRounds];
#pragma unroll
    for (int r = 0; r < kStageRounds; ++r)
      v[r] = pos[r] >= 0 ? __ldg(x + (g0 + first + r * 32) * d_cols + c)
                         : 0.0f;
#pragma unroll
    for (int r = 0; r < kStageRounds; ++r)
      if (pos[r] >= 0) st_x[(int64_t)pos[r] * d_cols + c] = v[r];
  }
  for (int j = 0; j < k; ++j) {
    const int32_t* a = aux + ((int64_t)j * n_shards + s) * n;
    int32_t v[kStageRounds];
#pragma unroll
    for (int r = 0; r < kStageRounds; ++r)
      v[r] = pos[r] >= 0 ? __ldg(a + first + r * 32) : 0;
#pragma unroll
    for (int r = 0; r < kStageRounds; ++r)
      if (pos[r] >= 0) st_aux[j * kStageTile + pos[r]] = v[r];
  }
  __syncthreads();

  // the staged rows in bucket order: each bucket's run to consecutive slots
  const int64_t total = (int64_t)nb * cap;
  for (int p = threadIdx.x; p < kept_all; p += blockDim.x) {
    const int64_t slot = st_slot[p];
    const int64_t o = (int64_t)s * total + slot;
    for (int c = 0; c < d_cols; ++c)
      xb[o * d_cols + c] = st_x[(int64_t)p * d_cols + c];
    for (int j = 0; j < k; ++j)
      ints[((int64_t)j * n_shards + s) * total + slot] =
          st_aux[j * kStageTile + p];
  }
}

// ---------------------------------------------------------------------------
// reduce_received — replaces src/repro/kernels/route.py:
// reduce_received_pallas (_reduce_kernel). Folds (slot, value) into
// y[S, n_local] by add / min / store (max value wins).
//
// Bound: reads slot + value (8 B) per received entry, writes y once.
// There is no float atomicMin, so min/store map the f32 bits to an
// order-preserving int32 (b >= 0 ? b : b ^ 0x7fffffff) and run
// atomicMin / atomicMax on it; a finish pass maps back and applies
// route.py:386-390 (a non-finite min reads +inf, a non-finite store 0).
// The reference's minimum / maximum carry a NaN through, so a slot that
// received one ends non-finite; here a NaN goes in as -inf (min) or +inf
// (store), which wins the fold, and the finish pass gives the same +inf
// or 0. add carries a NaN through atomicAdd as it is. min and store are
// exact whatever the order; add is an f32 sum whose order varies from
// run to run.
//
// atomic (n_local past the private threshold, or unaligned views): one
// global atomic an entry; fine while the outputs are many (BFS's and
// PageRank's 65,536 a shard), serialised in L2 when they are few (the
// routed histogram's 64: 2^28 atomics on 4,096 addresses).
// private (small n_local, 16-byte aligned): grid (chunks, S), chunks
// enough for 8 blocks an SM; a block reads its run of one shard's stream
// with 16-byte loads (4 a thread in flight) and folds it into its own
// copies of that shard's [n_local] outputs in shared memory (one copy a
// warp while 8 copies fit in 48 KB, else one a block), then one global
// atomic an output and block folds them into y.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int32_t f2ord(float f) {
  const int32_t b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float ord2f(int32_t o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

constexpr int kAdd = 0, kMin = 1, kStore = 2;
constexpr int kPrivThreads = 256;
constexpr int kPrivWarps = kPrivThreads / 32;
constexpr int64_t kPrivMinChunk = 4096;       // least entries a block
constexpr int64_t kWarpCopyBytes = 48 * 1024;

// the int that v folds in as under min / store: a NaN as -inf / +inf
template <int OP>
__device__ __forceinline__ int32_t fold_ord(float v) {
  if (isnan(v)) return f2ord(__int_as_float(OP == kMin ? 0xff800000
                                                       : 0x7f800000));
  return f2ord(v);
}

template <int OP>
__device__ __forceinline__ int32_t fold_identity() {
  return OP == kAdd ? 0 : f2ord(__int_as_float(OP == kMin ? 0x7f800000
                                                          : 0xff800000));
}

template <int OP>
__device__ __forceinline__ void fold(int32_t* out, float v) {
  if (OP == kAdd) atomicAdd(reinterpret_cast<float*>(out), v);
  else if (OP == kMin) atomicMin(out, fold_ord<OP>(v));
  else atomicMax(out, fold_ord<OP>(v));
}

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
  fold<OP>(y + (int64_t)s * n_local + q, val[g]);
}

template <int OP>
__device__ __forceinline__ void fold_local(int32_t* copy, int32_t q, float v,
                                           int n_local) {
  if ((uint32_t)q < (uint32_t)n_local) fold<OP>(copy + q, v);
}

template <int OP>
__global__ void __launch_bounds__(kPrivThreads)
reduce_private_kernel(const int32_t* __restrict__ slot,
                      const float* __restrict__ val, int64_t m, int n_local,
                      int64_t chunk, int copies, int32_t* __restrict__ y) {
  extern __shared__ int32_t acc[];                  // [copies, n_local]
  const int32_t ident = fold_identity<OP>();
  for (int i = threadIdx.x; i < copies * n_local; i += blockDim.x)
    acc[i] = ident;
  __syncthreads();
  int32_t* copy = acc + (copies > 1 ? (threadIdx.x >> 5) : 0) * n_local;
  const int s = blockIdx.y;
  const int64_t lo = blockIdx.x * chunk;
  const int64_t hi = lo + chunk < m ? lo + chunk : m;
  if (lo < hi) {
    // [a, e) of the flat stream: scalar up to a multiple of 4, 16-byte
    // loads, scalar tail
    const int64_t a = (int64_t)s * m + lo, e = (int64_t)s * m + hi;
    const int64_t a4 = ((a + 3) & ~int64_t(3)) < e ? (a + 3) & ~int64_t(3) : e;
    const int64_t e4 = (e & ~int64_t(3)) > a4 ? e & ~int64_t(3) : a4;
    for (int64_t i = a + threadIdx.x; i < a4; i += blockDim.x)
      fold_local<OP>(copy, slot[i], val[i], n_local);
    const int4* s4 = reinterpret_cast<const int4*>(slot);
    const float4* v4 = reinterpret_cast<const float4*>(val);
    const int64_t n4 = e4 / 4;
    int64_t i = a4 / 4 + threadIdx.x;
    for (; i + 3 * blockDim.x < n4; i += 4 * blockDim.x) {
      int4 q[4];
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        q[u] = __ldg(s4 + i + u * blockDim.x);
        v[u] = __ldg(v4 + i + u * blockDim.x);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        fold_local<OP>(copy, q[u].x, v[u].x, n_local);
        fold_local<OP>(copy, q[u].y, v[u].y, n_local);
        fold_local<OP>(copy, q[u].z, v[u].z, n_local);
        fold_local<OP>(copy, q[u].w, v[u].w, n_local);
      }
    }
    for (; i < n4; i += blockDim.x) {
      const int4 q = __ldg(s4 + i);
      const float4 v = __ldg(v4 + i);
      fold_local<OP>(copy, q.x, v.x, n_local);
      fold_local<OP>(copy, q.y, v.y, n_local);
      fold_local<OP>(copy, q.z, v.z, n_local);
      fold_local<OP>(copy, q.w, v.w, n_local);
    }
    for (int64_t j = e4 + threadIdx.x; j < e; j += blockDim.x)
      fold_local<OP>(copy, slot[j], val[j], n_local);
  }
  __syncthreads();
  int32_t* out = y + (int64_t)s * n_local;
  for (int q = threadIdx.x; q < n_local; q += blockDim.x) {
    int32_t r = acc[q];
    for (int c = 1; c < copies; ++c) {
      const int32_t o = acc[c * n_local + q];
      if (OP == kAdd) r = __float_as_int(__int_as_float(r) + __int_as_float(o));
      else if (OP == kMin) r = o < r ? o : r;
      else r = o > r ? o : r;
    }
    if (OP == kAdd) {
      if (__int_as_float(r) != 0.0f)       // +-0 leaves y as it is
        atomicAdd(reinterpret_cast<float*>(out + q), __int_as_float(r));
    } else if (r != ident) {
      if (OP == kMin) atomicMin(out + q, r);
      else atomicMax(out + q, r);
    }
  }
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

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- host: the two designs of each entry point ------------------------------

int launch_ranked(const float* x, const int32_t* dest, const uint8_t* valid,
                  const int32_t* aux, const int32_t* rank, int64_t n_shards,
                  int64_t n, int32_t d_cols, int32_t k, int32_t nb,
                  int64_t cap, float* xb, int32_t* ints, int32_t* task_slot,
                  int32_t* n_drop, const sm90::LaunchPlan& plan,
                  cudaStream_t stream) {
  const dim3 grid(blocks_for(n, kThreads), (unsigned)n_shards);
  if (!sm90::plan_is(plan, kThreads, grid, kThreads, 1, 0))
    return (int)cudaErrorInvalidValue;
  if (n > 0 && rank == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t slots = n_shards * (int64_t)nb * cap;
  if (slots * d_cols > 0)
    fill_kernel<<<fill_blocks(slots * d_cols), kThreads, 0, stream>>>(
        reinterpret_cast<int32_t*>(xb), slots * d_cols, 0);
  if (slots * k > 0)
    fill_kernel<<<fill_blocks(slots * k), kThreads, 0, stream>>>(
        ints, slots * k, -1);
  fill_kernel<<<1, kThreads, 0, stream>>>(n_drop, n_shards, 0);
  if (n > 0)
    scatter_kernel<<<grid, kThreads, 0, stream>>>(
        x, dest, valid, aux, rank, n, d_cols, k, nb, cap, (int)n_shards, xb,
        ints, task_slot, n_drop);
  return (int)cudaGetLastError();
}

int launch_staged(const float* x, const int32_t* dest, const uint8_t* valid,
                  const int32_t* aux, int64_t n_shards, int64_t n,
                  int32_t d_cols, int32_t k, int32_t nb, int64_t cap,
                  float* xb, int32_t* ints, int32_t* task_slot,
                  int32_t* n_drop, int32_t* scratch,
                  const sm90::LaunchPlan& plan, cudaStream_t stream) {
  const int64_t tiles = (n + kStageTile - 1) / kStageTile;
  const int64_t smem = staged_smem(nb, d_cols, k);
  const dim3 grid((unsigned)tiles, (unsigned)n_shards);
  if (!sm90::plan_is(plan, kStageTile, grid, kStageThreads, 1, (size_t)smem))
    return (int)cudaErrorInvalidValue;
  if (smem > kSmemLimit || (int64_t)nb * cap >= (int64_t(1) << 31) ||
      scratch == nullptr || !aligned16(xb) || (k > 0 && !aligned16(ints)))
    return (int)cudaErrorInvalidValue;
  int32_t* counts = scratch;                             // [S, tiles, nb]
  int32_t* lo = scratch + n_shards * tiles * nb;         // [S, nb]
  const int key_bits = 32 - __builtin_clz((unsigned)nb);
  if (tiles > 0)
    staged_count_kernel<<<grid, kStageThreads, nb * sizeof(int32_t),
                          stream>>>(dest, valid, n, nb, tiles, counts);
  staged_scan_kernel<<<(unsigned)n_shards, kScanThreads, 0, stream>>>(
      counts, tiles, nb, cap, lo, n_drop);
  const int64_t buckets = n_shards * nb;
  int64_t parts = (kTargetBlocks + buckets - 1) / buckets;
  const int64_t want = (cap + kFillSlots - 1) / kFillSlots;
  parts = parts > want ? parts : want;
  const int64_t most = (cap + kFillMinSlots - 1) / kFillMinSlots;
  parts = parts < most ? parts : most;
  if (d_cols + k > 0)
    staged_fill_kernel<<<(unsigned)(buckets * parts), kThreads, 0, stream>>>(
        lo, nb, cap, d_cols, k, (int)n_shards, parts, xb, ints);
  if (tiles > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          staged_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    staged_place_kernel<<<grid, kStageThreads, (size_t)smem, stream>>>(
        x, dest, valid, aux, n, d_cols, k, nb, key_bits, cap, (int)n_shards,
        tiles, counts, xb, ints, task_slot);
  }
  return (int)cudaGetLastError();
}

template <int OP>
void launch_private_op(const int32_t* slot, const float* val, dim3 grid,
                       int64_t m, int n_local, int64_t chunk, int copies,
                       size_t smem, int32_t* y, cudaStream_t stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(reduce_private_kernel<OP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  reduce_private_kernel<OP><<<grid, kPrivThreads, smem, stream>>>(
      slot, val, m, n_local, chunk, copies, y);
}

}  // namespace

extern "C" {

// dest, valid, pos: [n_shards, n], n <= 2^31 - 8192; status: 16-byte
// aligned scratch of 2 + 2 * n_tiles int32 (counter, pad, a 64-bit status
// word a tile), n_tiles = n_shards * ceil((n + 3) / 4096), and at nb > 1
// the int32 prefixes [n_tiles, nb] and, from the next 16-byte boundary
// (rank_aggs_offset), the uint16 aggregates [n_tiles, nb rounded up to a
// multiple of 8]; the counter and the words are zeroed here, on the
// stream, before the launch. plan: the wrapper's launch plan, its path 0
// = lookback; launched only as planned.
int dcra_bucket_rank(const int32_t* dest, const uint8_t* valid,
                     int64_t n_shards, int64_t n, int32_t nb,
                     int32_t* status, int32_t* pos,
                     const sm90::LaunchPlan* plan, cudaStream_t stream) {
  if (plan == nullptr || plan->path != 0 || nb < 1 || nb > kMaxBuckets ||
      n_shards < 0 || n < 0 || n > kRankMaxTasks)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = rank_tiles(n);
  const int64_t n_tiles = n_shards * tiles;
  const int64_t smem = rank_smem(nb);
  if (n_tiles >= (int64_t(1) << 31) ||
      !sm90::plan_is(*plan, kRankTile, dim3((unsigned)n_tiles), kRankThreads,
                     1, (size_t)smem))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  if (status == nullptr || reinterpret_cast<uintptr_t>(status) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      status, 0, rank_status_ints(n_tiles) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t dp = reinterpret_cast<uintptr_t>(dest);
  const int shift = (int)((dp >> 2) & 3);
  const bool vec = (dp & 3) == 0 &&
                   (int)(reinterpret_cast<uintptr_t>(valid) & 3) == shift;
  const int key_bits = 32 - __builtin_clz((unsigned)nb);
  if (nb == 1) {
    rank_lookback_kernel<true><<<(unsigned)n_tiles, kRankThreads,
                                 (size_t)smem, stream>>>(
        dest, valid, (int)n, nb, key_bits, (int)tiles, (int)n_shards, vec,
        shift, status, pos);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(rank_lookback_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    rank_lookback_kernel<false><<<(unsigned)n_tiles, kRankThreads,
                                  (size_t)smem, stream>>>(
        dest, valid, (int)n, nb, key_bits, (int)tiles, (int)n_shards, vec,
        shift, status, pos);
  }
  return (int)cudaGetLastError();
}

// x: [n_shards, n, d_cols] f32; dest, valid: [n_shards, n]; aux: [k,
// n_shards, n] i32; xb: [n_shards, nb*cap, d_cols]; ints: [k, n_shards,
// nb*cap]; task_slot: [n_shards, n]; n_drop: [n_shards]. plan: the
// wrapper's launch plan, its path 0 = ranked (rank: dcra_bucket_rank's
// output on the same dest / valid), 1 = staged (scratch: [n_shards *
// tiles * nb + n_shards * nb] i32, tiles = ceil(n / 2048)); launched only
// as planned.
int dcra_bucket_scatter(const float* x, const int32_t* dest,
                        const uint8_t* valid, const int32_t* aux,
                        const int32_t* rank, int64_t n_shards, int64_t n,
                        int32_t d_cols, int32_t k, int32_t nb, int64_t cap,
                        float* xb, int32_t* ints, int32_t* task_slot,
                        int32_t* n_drop, int32_t* scratch,
                        const sm90::LaunchPlan* plan, cudaStream_t stream) {
  if (n_shards <= 0) return (int)cudaGetLastError();
  if (plan == nullptr || nb < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  if (plan->path == 1)
    return launch_staged(x, dest, valid, aux, n_shards, n, d_cols, k, nb, cap,
                         xb, ints, task_slot, n_drop, scratch, *plan, stream);
  if (plan->path == 0)
    return launch_ranked(x, dest, valid, aux, rank, n_shards, n, d_cols, k,
                         nb, cap, xb, ints, task_slot, n_drop, *plan, stream);
  return (int)cudaErrorInvalidValue;
}

// slot, val: [n_shards, m]; y: [n_shards, n_local] f32. op: 0 add,
// 1 min, 2 store. plan: the wrapper's launch plan, its path 0 = atomic,
// 1 = private; launched only as planned.
int dcra_reduce_received(const int32_t* slot, const float* val,
                         int64_t n_shards, int64_t m, int64_t n_local,
                         int32_t op, float* y, const sm90::LaunchPlan* plan,
                         cudaStream_t stream) {
  int32_t* yi = reinterpret_cast<int32_t*>(y);
  const int64_t count = n_shards * n_local;
  if (count <= 0) return (int)cudaGetLastError();
  if (plan == nullptr || op < kAdd || op > kStore)
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  int64_t chunk = 0;
  int copies = 0;
  size_t smem = 0;
  if (plan->path == 1) {                                 // private
    int64_t chunks = (m + kPrivMinChunk - 1) / kPrivMinChunk;
    const int64_t most = (kTargetBlocks + n_shards - 1) / n_shards;
    chunks = chunks < most ? chunks : most;
    chunks = chunks > 1 ? chunks : 1;
    const int64_t each = (m + chunks - 1) / chunks;
    chunk = each > 1 ? (each + 3) / 4 * 4 : 4;
    copies = kPrivWarps * n_local * 4 <= kWarpCopyBytes ? kPrivWarps : 1;
    smem = (size_t)copies * n_local * 4;
    grid = dim3((unsigned)chunks, (unsigned)n_shards);
    if (!sm90::plan_is(*plan, (int)chunk, grid, kPrivThreads, 1, smem) ||
        (int64_t)smem > kSmemLimit || !aligned16(slot) || !aligned16(val))
      return (int)cudaErrorInvalidValue;
  } else if (plan->path == 0) {                          // atomic
    grid = dim3(blocks_for(m, kThreads), (unsigned)n_shards);
    if (!sm90::plan_is(*plan, kThreads, grid, kThreads, 1, 0))
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const float inf = __builtin_huge_valf();
  const int32_t init = op == kAdd ? 0 : host_f2ord(op == kMin ? inf : -inf);
  reduce_init_kernel<<<fill_blocks(count), kThreads, 0, stream>>>(yi, count,
                                                                  init);
  if (plan->path == 1) {
    const int nl = (int)n_local;
    if (op == kAdd)
      launch_private_op<kAdd>(slot, val, grid, m, nl, chunk, copies, smem, yi,
                              stream);
    else if (op == kMin)
      launch_private_op<kMin>(slot, val, grid, m, nl, chunk, copies, smem, yi,
                              stream);
    else
      launch_private_op<kStore>(slot, val, grid, m, nl, chunk, copies, smem,
                                yi, stream);
  } else if (m > 0) {
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
  if (op == kMin)
    reduce_finish_kernel<kMin><<<blocks_for(count, kThreads), kThreads, 0,
                                 stream>>>(yi, count);
  if (op == kStore)
    reduce_finish_kernel<kStore><<<blocks_for(count, kThreads), kThreads, 0,
                                   stream>>>(yi, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
