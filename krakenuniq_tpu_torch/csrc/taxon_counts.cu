// Per-taxon counts: acc[id] += #{i : mask[i] && ids[i] == id}.
//
// Replaces: tools/counts_mxu_exp.py, counts_mxu / _mxu_kernel, which counted
// int32 labels on the TPU as one-hot [1, L] x [L, 128] f32 products on the
// matrix unit (the TPU has no fast scatter), and with it the two counts of
// krakenuniq_tpu/classify/device_counters.py update_core that the kernel was
// meant for: the read counts (a bincount of the calls, :76-78) and the k-mer
// counts (an i32 sort plus t+1 boundary probes, or a bincount, :79-91).
//
// Bound on the H100: bytes. Each lane reads a 4-byte id and a 1-byte mask,
// and the accumulator is read and written once per id (8 + 8 bytes); a
// handful of integer operations per lane are far below the memory rate.
//
// Design: on Hopper, shared-memory atomics are the native histogram. When
// the id space fits shared memory (T <= kSmemBins; the main path's T is the
// value pool, ~500 ids) each block keeps a private int32 histogram in shared
// memory over a grid-stride loop and then flushes each non-zero bin into the
// int64 accumulator with one 64-bit atomicAdd. Otherwise (a dense taxonomy
// id space, millions of ids) each counted lane adds directly into the
// accumulator with a global 64-bit atomicAdd. Ids outside [0, T) are skipped
// so that no write leaves the accumulator. In the shared-memory form the
// grid is sized so that a block sees ~8 T lanes (at least one block per SM):
// the flush then costs at most 1/8 of an atomic per lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBins = 12288;  // 48 KB of int32 bins: no opt-in needed
constexpr long long kSms = 132;
constexpr long long kMaxBlocks = kSms * 8;

__global__ void __launch_bounds__(kThreads)
counts_smem_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ mask,
                   unsigned long long* __restrict__ acc, long long n, int t) {
  extern __shared__ int hist[];  // [t]
  for (int j = threadIdx.x; j < t; j += kThreads) hist[j] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int id = ids[i];
    if (mask[i] && (unsigned)id < (unsigned)t) atomicAdd(&hist[id], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const int c = hist[j];
    if (c) atomicAdd(acc + j, (unsigned long long)c);
  }
}

__global__ void __launch_bounds__(kThreads)
counts_global_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ mask,
                     unsigned long long* __restrict__ acc, long long n, int t) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int id = ids[i];
    if (mask[i] && (unsigned)id < (unsigned)t) atomicAdd(acc + id, 1ull);
  }
}

}  // namespace

extern "C" int kuniq_taxon_counts(const void* ids, const void* mask, void* acc, long long n,
                                  int t, void* stream) {
  if (n <= 0 || t <= 0) return (int)cudaGetLastError();
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  if (t <= kSmemBins) {
    const long long per_t = n / (8LL * t);
    const long long want = per_t > kSms ? per_t : kSms;
    if (grid > want) grid = want;
    counts_smem_kernel<<<(unsigned)grid, kThreads, (size_t)t * sizeof(int), (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const uint8_t*)mask, (unsigned long long*)acc, n, t);
  } else {
    counts_global_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const uint8_t*)mask, (unsigned long long*)acc, n, t);
  }
  return (int)cudaGetLastError();
}
