// Per-taxon counts: acc[id] += #{i : mask[i] && ids[i] == id}, for one or
// two segments (ids, mask, acc, n) in one launch.
//
// Replaces: tools/counts_mxu_exp.py, counts_mxu / _mxu_kernel, which counted
// int32 labels on the TPU as one-hot [1, L] x [L, 128] f32 products on the
// matrix unit (the TPU has no fast scatter), and with it the two counts of
// krakenuniq_tpu/classify/device_counters.py update_core that the kernel was
// meant for: the read counts (a bincount of the calls, :76-78) and the k-mer
// counts (an i32 sort plus t+1 boundary probes, or a bincount, :79-91). One
// launch takes both: segment a the reads, segment b the k-mers.
//
// Bound on the H100: bytes. Each lane reads a 4-byte id and a 1-byte mask,
// and each accumulator bin the lanes touch is read and written once (8 + 8
// bytes); a handful of integer operations per lane are far below the memory
// rate. What keeps a kernel from that bound is its fixed cost at a work
// unit's size (~3 us: the launch, one histogram per block, one load latency,
// the flush) and, in the L2, atomics on one address: real ids are
// zipf-skewed (about 38% of a unit's counted lanes carry one id).
//
// Design:
//  * Vector loads: a thread reads 4 ids (16 bytes) and their 4 mask bytes
//    (one 4-byte word) at a time, two such groups before it counts either;
//    a scalar head and tail cover a segment whose ids start off a 16-byte
//    boundary or whose length is not a multiple of 4 (and the whole segment
//    when the mask is not aligned with the ids). Ids outside [0, T) are
//    skipped, so no write leaves `acc`.
//  * The shared-memory form (T up to 58,112: the whole 227 KB a block may
//    opt into on sm_90) keeps a private int32 histogram per block over a
//    grid-stride loop and adds its non-zero bins into the int64 accumulator
//    at the end. Shared-memory atomics take a warp's equal ids without a
//    penalty worth removing: grouping them first (a ballot on one id, or
//    __match_any_sync) measured slower, as did flushing through a cluster
//    of 8 blocks over distributed shared memory, which cuts the flush's
//    global atomics eightfold but adds a cluster barrier and remote reads
//    (the candidates are in tools/variants/taxon_counts_variants.cu, timed
//    by tools/kernel_variants.py).
//  * The global form (a dense taxonomy id space, millions of ids) adds
//    straight into the accumulator with 64-bit atomics, after warp
//    aggregation: __match_any_sync groups the lanes of a warp that carry the
//    same id and the lowest of them adds the group's size. Counts are sums
//    of ones, so any grouping of equal ids gives the same total. Under zipf
//    ids this takes the hot id's L2 atomics from one per lane to one per
//    warp and group.
//  * The two segments share one grid: blocks [0, blocks_a) count segment a,
//    the rest segment b, each with its own histogram. The grid and the form
//    are chosen by the caller (device_counters.py counts_plan): one wave of
//    blocks at most, ~8 T lanes per block at least.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kGroups = 2;  // 4-lane groups a thread loads before counting them
constexpr unsigned kFull = 0xffffffffu;

struct Segment {
  const int32_t* ids;
  const uint8_t* mask;
  unsigned long long* acc;
  long long n;
};

// This block's share (block blk of nblk) of segment s: add(id, ok) for each
// lane. Every lane of a warp runs the same number of rounds, so `add` may
// use the warp functions.
template <typename Add>
__device__ __forceinline__ void count_segment(const Segment& s, int t, long long blk, long long nblk, Add add) {
  const int lane = threadIdx.x & 31;
  const long long warps = nblk * (kThreads / 32);
  const long long wid = blk * (kThreads / 32) + (threadIdx.x >> 5);
  // lanes before the first 16-byte-aligned id; the vector body needs the
  // mask 4-byte aligned at the same lane, else the whole segment is scalar
  long long head = (long long)(((16u - ((uintptr_t)s.ids & 15u)) & 15u) >> 2);
  if (head > s.n || ((uintptr_t)(s.mask + head) & 3u)) head = s.n;
  const long long groups = (s.n - head) >> 2;
  const int4* ids4 = reinterpret_cast<const int4*>(s.ids + head);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(s.mask + head);
  const unsigned ut = (unsigned)t;
  for (long long g0 = wid * 32 * kGroups; g0 < groups; g0 += warps * 32 * kGroups) {
    int4 v[kGroups];
    unsigned m[kGroups];
#pragma unroll
    for (int r = 0; r < kGroups; ++r) {
      const long long g = g0 + r * 32 + lane;
      v[r] = make_int4(0, 0, 0, 0);
      m[r] = 0;
      if (g < groups) {
        v[r] = __ldg(ids4 + g);
        m[r] = __ldg(mask4 + g);
      }
    }
#pragma unroll
    for (int r = 0; r < kGroups; ++r) {
      add(v[r].x, (m[r] & 0xffu) && (unsigned)v[r].x < ut);
      add(v[r].y, (m[r] & 0xff00u) && (unsigned)v[r].y < ut);
      add(v[r].z, (m[r] & 0xff0000u) && (unsigned)v[r].z < ut);
      add(v[r].w, (m[r] & 0xff000000u) && (unsigned)v[r].w < ut);
    }
  }
  // the scalar lanes: the head, then the tail after the last full group
  const long long tail0 = head + 4 * groups;
  const long long n_scalar = head + (s.n - tail0);
  for (long long j0 = wid * 32; j0 < n_scalar; j0 += warps * 32) {
    const long long j = j0 + lane;
    int id = 0;
    bool ok = false;
    if (j < n_scalar) {
      const long long i = j < head ? j : tail0 + (j - head);
      id = s.ids[i];
      ok = s.mask[i] && (unsigned)id < ut;
    }
    add(id, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
counts_smem_kernel(Segment a, Segment b, int blocks_a, int t) {
  extern __shared__ unsigned hist[];  // [t]
  const bool in_b = (int)blockIdx.x >= blocks_a;
  const Segment s = in_b ? b : a;
  const long long blk = in_b ? blockIdx.x - blocks_a : blockIdx.x;
  const long long nblk = in_b ? gridDim.x - blocks_a : blocks_a;
  for (int j = threadIdx.x; j < t; j += kThreads) hist[j] = 0;
  __syncthreads();
  count_segment(s, t, blk, nblk, [&](int id, bool ok) {
    if (ok) atomicAdd(&hist[id], 1u);
  });
  __syncthreads();
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const unsigned c = hist[j];
    if (c) atomicAdd(s.acc + j, (unsigned long long)c);
  }
}

__global__ void __launch_bounds__(kThreads)
counts_global_kernel(Segment a, Segment b, int blocks_a, int t) {
  const bool in_b = (int)blockIdx.x >= blocks_a;
  const Segment s = in_b ? b : a;
  const long long blk = in_b ? blockIdx.x - blocks_a : blockIdx.x;
  const long long nblk = in_b ? gridDim.x - blocks_a : blocks_a;
  const int lane = threadIdx.x & 31;
  count_segment(s, t, blk, nblk, [&](int id, bool ok) {
    const unsigned act = __ballot_sync(kFull, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(act, id);
      if (lane == __ffs(peers) - 1) atomicAdd(s.acc + id, (unsigned long long)__popc(peers));
    }
  });
}

}  // namespace

// shared != 0: the shared-memory form (t * 4 bytes of histogram per block);
// 0: the global form. blocks_a + blocks_b blocks of kThreads threads.
extern "C" int kuniq_taxon_counts(const void* ids_a, const void* mask_a, void* acc_a, long long n_a,
                                  const void* ids_b, const void* mask_b, void* acc_b, long long n_b,
                                  int t, int shared, int blocks_a, int blocks_b, void* stream) {
  if (t <= 0 || blocks_a < 0 || blocks_b < 0) return (int)cudaErrorInvalidValue;
  const int grid = blocks_a + blocks_b;
  if (grid == 0) return (int)cudaGetLastError();
  const Segment a{(const int32_t*)ids_a, (const uint8_t*)mask_a, (unsigned long long*)acc_a, n_a};
  const Segment b{(const int32_t*)ids_b, (const uint8_t*)mask_b, (unsigned long long*)acc_b, n_b};
  const cudaStream_t st = (cudaStream_t)stream;
  if (!shared) {
    counts_global_kernel<<<grid, kThreads, 0, st>>>(a, b, blocks_a, t);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)t * sizeof(unsigned);
  if (smem > 48 * 1024) {  // the opt-in is per device: set it on every such launch
    const cudaError_t e =
        cudaFuncSetAttribute(counts_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  counts_smem_kernel<<<grid, kThreads, smem, st>>>(a, b, blocks_a, t);
  return (int)cudaGetLastError();
}
