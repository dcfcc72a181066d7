// Candidate designs of csrc/taxon_counts.cu that the kept kernel was chosen
// over, built beside it for tools/kernel_variants.py to time on the card.
// They count exactly what the kept kernel counts, over the same segments,
// load loop (count_segment) and grid (device_counters.py counts_plan):
//  * grouping a warp's equal ids before its atomics, in shared or in global
//    memory: kNone (one atomic per counted lane: the kept shared form, and
//    the global form before grouping), kBallot (the lanes on the id of the
//    warp's first counted lane add once, by their leader, with the popcount
//    of a ballot; the rest add one each) and kMatch (__match_any_sync groups
//    every id; the kept global form);
//  * a cluster flush: the shared form with clusters of kCluster blocks of
//    one segment; after counting, block r of a cluster sums slice r of the
//    cluster's kCluster histograms over distributed shared memory and adds
//    it to the accumulator, so each bin takes one global atomic per cluster
//    instead of one per block.

#include <cooperative_groups.h>

#include "taxon_counts.cu"

namespace {

namespace cg = cooperative_groups;

enum Group { kNone = 0, kBallot = 1, kMatch = 2 };
constexpr int kCluster = 8;

template <int G, typename T>
__device__ __forceinline__ void add_grouped(T* bins, int id, bool ok, int lane) {
  if (G == kNone) {
    if (ok) atomicAdd(bins + id, (T)1);
    return;
  }
  const unsigned act = __ballot_sync(kFull, ok);
  if (G == kBallot) {
    if (!act) return;
    const int leader = __ffs(act) - 1;
    const int lid = __shfl_sync(kFull, id, leader);
    const unsigned same = __ballot_sync(kFull, ok && id == lid);
    if (lane == leader) {
      atomicAdd(bins + lid, (T)__popc(same));
    } else if (ok && id != lid) {
      atomicAdd(bins + id, (T)1);
    }
  } else if (ok) {
    const unsigned peers = __match_any_sync(act, id);
    if (lane == __ffs(peers) - 1) atomicAdd(bins + id, (T)__popc(peers));
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
counts_smem_group_kernel(Segment a, Segment b, int blocks_a, int t) {
  extern __shared__ unsigned hist[];
  const bool in_b = (int)blockIdx.x >= blocks_a;
  const Segment s = in_b ? b : a;
  const long long blk = in_b ? blockIdx.x - blocks_a : blockIdx.x;
  const long long nblk = in_b ? gridDim.x - blocks_a : blocks_a;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < t; j += kThreads) hist[j] = 0;
  __syncthreads();
  count_segment(s, t, blk, nblk, [&](int id, bool ok) { add_grouped<G>(hist, id, ok, lane); });
  __syncthreads();
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const unsigned c = hist[j];
    if (c) atomicAdd(s.acc + j, (unsigned long long)c);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
counts_global_group_kernel(Segment a, Segment b, int blocks_a, int t) {
  const bool in_b = (int)blockIdx.x >= blocks_a;
  const Segment s = in_b ? b : a;
  const long long blk = in_b ? blockIdx.x - blocks_a : blockIdx.x;
  const long long nblk = in_b ? gridDim.x - blocks_a : blocks_a;
  const int lane = threadIdx.x & 31;
  count_segment(s, t, blk, nblk, [&](int id, bool ok) { add_grouped<G>(s.acc, id, ok, lane); });
}

// blocks_a is a multiple of kCluster, so no cluster spans both segments
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
counts_cluster_kernel(Segment a, Segment b, int blocks_a, int t) {
  extern __shared__ unsigned hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const bool in_b = (int)blockIdx.x >= blocks_a;
  const Segment s = in_b ? b : a;
  const long long blk = in_b ? blockIdx.x - blocks_a : blockIdx.x;
  const long long nblk = in_b ? gridDim.x - blocks_a : blocks_a;
  for (int j = threadIdx.x; j < t; j += kThreads) hist[j] = 0;
  __syncthreads();
  count_segment(s, t, blk, nblk, [&](int id, bool ok) {
    if (ok) atomicAdd(&hist[id], 1u);
  });
  cluster.sync();  // every histogram of the cluster is complete
  const int r = (int)cluster.block_rank();
  const int lo = (int)((long long)t * r / kCluster), hi = (int)((long long)t * (r + 1) / kCluster);
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    unsigned c = 0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) c += cluster.map_shared_rank(hist, q)[j];
    if (c) atomicAdd(s.acc + j, (unsigned long long)c);
  }
  cluster.sync();  // no block leaves while another still reads its histogram
}

template <int G>
int launch_smem(const Segment& a, const Segment& b, int blocks_a, int blocks_b, int t, cudaStream_t st) {
  const size_t smem = (size_t)t * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(counts_smem_group_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  counts_smem_group_kernel<G><<<blocks_a + blocks_b, kThreads, smem, st>>>(a, b, blocks_a, t);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: with shared != 0, 0-2 the shared form grouped kNone (the kept
// kernel's form) / kBallot / kMatch, 3 the cluster flush (blocks_a and
// blocks_b multiples of kCluster); with shared == 0, 0-2 the global form
// grouped kNone / kBallot / kMatch (the kept kernel's form). Otherwise the
// arguments of kuniq_taxon_counts.
extern "C" int kuniq_taxon_counts_variant(int variant, const void* ids_a, const void* mask_a, void* acc_a,
                                          long long n_a, const void* ids_b, const void* mask_b, void* acc_b,
                                          long long n_b, int t, int shared, int blocks_a, int blocks_b,
                                          void* stream) {
  if (t <= 0 || blocks_a < 0 || blocks_b < 0 || variant < 0 || variant > (shared ? 3 : 2))
    return (int)cudaErrorInvalidValue;
  const int grid = blocks_a + blocks_b;
  if (grid == 0) return (int)cudaGetLastError();
  const Segment a{(const int32_t*)ids_a, (const uint8_t*)mask_a, (unsigned long long*)acc_a, n_a};
  const Segment b{(const int32_t*)ids_b, (const uint8_t*)mask_b, (unsigned long long*)acc_b, n_b};
  const cudaStream_t st = (cudaStream_t)stream;
  if (!shared) {
    if (variant == kNone) counts_global_group_kernel<kNone><<<grid, kThreads, 0, st>>>(a, b, blocks_a, t);
    if (variant == kBallot) counts_global_group_kernel<kBallot><<<grid, kThreads, 0, st>>>(a, b, blocks_a, t);
    if (variant == kMatch) counts_global_group_kernel<kMatch><<<grid, kThreads, 0, st>>>(a, b, blocks_a, t);
    return (int)cudaGetLastError();
  }
  if (variant == 3) {
    if (blocks_a % kCluster || blocks_b % kCluster) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)t * sizeof(unsigned);
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(counts_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    counts_cluster_kernel<<<grid, kThreads, smem, st>>>(a, b, blocks_a, t);
    return (int)cudaGetLastError();
  }
  if (variant == kNone) return launch_smem<kNone>(a, b, blocks_a, blocks_b, t, st);
  if (variant == kBallot) return launch_smem<kBallot>(a, b, blocks_a, blocks_b, t, st);
  return launch_smem<kMatch>(a, b, blocks_a, blocks_b, t, st);
}
