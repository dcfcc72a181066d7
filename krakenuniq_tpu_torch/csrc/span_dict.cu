// The per-span taxon dictionary: the sorted distinct dense ids a span can
// emit, and each lane's id remapped to its rank in it (a u16 local id).
//
// Replaces: the local_dict block of classify_step_core,
// krakenuniq_tpu/classify/device_step.py:286-370 (without its mesh merge),
// which the JAX package left to XLA: a sort of every lane of the span's id
// plane plus its calls, a cumsum of the first-occurrence flags, cap
// searchsorted probes for the dictionary and a scatter / gather remap.
// Over the ids x of ids[0, n) and calls[0, b) (all in [0, T)), with n_u
// distinct values u_0 < u_1 < ...:
//   lut[j]   = u_j for j < min(n_u, cap), 2^30 for the other j < cap
//   lut[cap] = n_u
//   local[i] = j if ids[i] == u_j and j < cap, else 0 (calls likewise)
// so a span past the dictionary's capacity keeps its first cap ids in the
// lut and the true n_u in its last element, and the ids it drops remap to 0
// (the JAX scatter's mode="drop").
//
// Bound on the H100: bytes. Each id of the plane and the calls is read once
// and each local id written once; the flag table (4 B per id of the dense
// space, 9.6 MB at 2.4M ids) is cleared, marked, scanned and read back,
// and stays in the 50 MB L2 while the remap reads it at random.
//
// Design, with no sort: (1) clear a flag per id of the dense space; (2) set
// the flag of every id the span holds (all writers store 1, so the race is
// benign); (3-5) an exclusive scan of the flags, reduce-then-scan over
// tiles of kTile ids (tile counts, one block scanning them, each tile
// scanning itself from its offset), rewrites each flagged id's flag as its
// rank and writes lut[rank] = id for ranks below cap and the pads past n_u;
// (6) one thread a lane remaps through the rank table. Ids outside [0, T)
// are skipped and remap to 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr int kLutPad = 1 << 30;  // above any dense id: keeps the lut sorted
constexpr unsigned kFull = 0xffffffffu;

// Exclusive sum over the block of one int per thread; *total gets the sum.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int inc = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const int out = (warp == 0 ? 0 : warp_tot[warp - 1]) + inc - x;
  *total = warp_tot[n_warps - 1];
  __syncthreads();
  return out;
}

// (1) flags of the dense id space to 0
__global__ void __launch_bounds__(kThreads) span_dict_clear_kernel(int* __restrict__ rank, int t) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < t; i += stride) rank[i] = 0;
}

// (2) the flag of every id of the plane and the calls
__global__ void __launch_bounds__(kThreads)
span_dict_mark_kernel(const int32_t* __restrict__ ids, long long n, const int32_t* __restrict__ calls, int b,
                      int* __restrict__ rank, int t) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n + b) return;
  const int x = i < n ? ids[i] : calls[i - n];
  // read first, through L1: zipf ids send most lanes to a few flags, whose
  // line a store from every lane would hold in the L2 (a stale 0 only
  // repeats a store)
  if ((unsigned)x < (unsigned)t && __ldca(rank + x) == 0) rank[x] = 1;
}

// (3) the flags set in each tile
__global__ void __launch_bounds__(kThreads)
span_dict_reduce_kernel(const int* __restrict__ rank, int t, int* __restrict__ tile_cnt) {
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; j++) c += (base + j < t) ? rank[base + j] : 0;
  int total;
  block_exclusive_sum(c, &total);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = total;
}

// (4) one block: each tile's first rank; n_u into lut[cap]
__global__ void __launch_bounds__(kScanThreads)
span_dict_scan_kernel(const int* __restrict__ tile_cnt, int* __restrict__ tile_off, int n_tiles,
                      int* __restrict__ lut, int cap) {
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(n_tiles, (int)threadIdx.x * per), hi = min(n_tiles, lo + per);
  int acc = 0;
  for (int i = lo; i < hi; i++) acc += tile_cnt[i];
  int total;
  int run = block_exclusive_sum(acc, &total);
  for (int i = lo; i < hi; i++) {
    const int c = tile_cnt[i];
    tile_off[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) lut[cap] = total;
}

// (5) each flagged id's rank, over its flag; lut[rank] = id below cap; the
// lut's pads from n_u to cap
__global__ void __launch_bounds__(kThreads)
span_dict_rank_kernel(int* __restrict__ rank, int t, const int* __restrict__ tile_off, int* __restrict__ lut,
                      int cap) {
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  int f[kItems];
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    f[j] = (base + j < t) ? rank[base + j] : 0;
    c += f[j];
  }
  int total;
  int r = tile_off[blockIdx.x] + block_exclusive_sum(c, &total);
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    if (f[j]) {
      rank[base + j] = r;
      if (r < cap) lut[r] = (int)(base + j);
      r++;
    }
  }
  const int n_u = lut[cap];
  const int stride = gridDim.x * kThreads;
  for (int j = n_u + blockIdx.x * kThreads + threadIdx.x; j < cap; j += stride) lut[j] = kLutPad;
}

// (6) each lane's local id (and each call's)
__global__ void __launch_bounds__(kThreads)
span_dict_remap_kernel(const int32_t* __restrict__ ids, long long n, const int32_t* __restrict__ calls, int b,
                       const int* __restrict__ rank, int t, int cap, int32_t* __restrict__ local,
                       int32_t* __restrict__ local_call) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n + b || (i >= n && !local_call)) return;
  const int x = i < n ? ids[i] : calls[i - n];
  int r = (unsigned)x < (unsigned)t ? __ldg(rank + x) : cap;
  r = r < cap ? r : 0;
  if (i < n)
    local[i] = r;
  else
    local_call[i - n] = r;
}

}  // namespace

// int32 words of scratch kuniq_span_dict needs for a dense space of t ids.
extern "C" int kuniq_span_dict_scratch(int t) {
  const int tiles = (t + kTile - 1) / kTile;
  return t + 2 * tiles;
}

// ids int32 [n], calls int32 [b] (ids in [0, t)); lut int32 [cap + 1];
// local int32 [n]; local_call int32 [b] or null (no call remap); scratch of
// kuniq_span_dict_scratch(t) int32 words.
extern "C" int kuniq_span_dict(const void* ids, long long n, const void* calls, int b, int t, int cap, void* lut,
                               void* local, void* local_call, void* scratch, void* stream) {
  if (n < 0 || b < 0 || t <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* rank = (int*)scratch;
  const int tiles = (t + kTile - 1) / kTile;
  int* tile_cnt = rank + t;
  int* tile_off = tile_cnt + tiles;
  const long long lanes = n + b;
  span_dict_clear_kernel<<<(t + kThreads - 1) / kThreads, kThreads, 0, st>>>(rank, t);
  if (lanes > 0)
    span_dict_mark_kernel<<<(unsigned)((lanes + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const int32_t*)ids, n, (const int32_t*)calls, b, rank, t);
  span_dict_reduce_kernel<<<tiles, kThreads, 0, st>>>(rank, t, tile_cnt);
  span_dict_scan_kernel<<<1, kScanThreads, 0, st>>>(tile_cnt, tile_off, tiles, (int*)lut, cap);
  span_dict_rank_kernel<<<tiles, kThreads, 0, st>>>(rank, t, tile_off, (int*)lut, cap);
  if (lanes > 0)
    span_dict_remap_kernel<<<(unsigned)((lanes + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const int32_t*)ids, n, (const int32_t*)calls, b, rank, t, cap, (int32_t*)local, (int32_t*)local_call);
  return (int)cudaGetLastError();
}
