// Binary-search k-mer lookup over the sorted database planes.
//
// Replaces: krakenuniq_tpu/lookup/xla_lookup.py, lookup_kmers, which the
// JAX package left to XLA as a fori_loop of n_iter gather passes over the
// whole lane plane. Semantics of the reference's kmer_query
// (krakendb.cpp:250-321): a lane's minimizer bin b (relative to bin_start)
// selects keys [offsets[b], offsets[b + 1]), sorted; a lower-bound search
// of n_iter steps finds the lane's canonical k-mer; on a match the lane
// takes vals and vals_dense at that position, else 0. A lane that is not
// valid, or whose bin lies outside [0, n_bins), reads nothing and gives 0.
// Planes: keys int64 [N] (canonical k-mers, below 2^62, so the signed
// compare is the unsigned one), vals uint32 [N] (the stored taxids),
// vals_dense int32 [N], offsets int64 [n_bins + 1].
//
// Bound on the H100: random 32-byte sectors. A searched lane makes 2 +
// n_iter dependent reads: the offsets pair, one key per step, then the key
// at the result and its two values (which share nothing with the lane's
// neighbours: bins are scattered over an 888 MB key plane at full size).
// Design: one thread per lane; the loop stops once the range is empty,
// which changes no result (an empty range stays empty for the remaining
// steps) and saves the last steps of small bins. A simple kernel first: a
// later design can keep several lanes' searches in flight per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bsearch_lookup_kernel(const long long* __restrict__ keys, const uint32_t* __restrict__ vals,
                      const int32_t* __restrict__ vals_dense, const long long* __restrict__ offsets,
                      const long long* __restrict__ query, const long long* __restrict__ bins,
                      const uint8_t* __restrict__ valid, uint32_t* __restrict__ taxon,
                      int32_t* __restrict__ taxon_dense, long long n, long long n_keys,
                      long long n_bins, int n_iter, long long bin_start) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t t = 0;
  int32_t td = 0;
  const long long b = bins[i] - bin_start;
  if (valid[i] && b >= 0 && b < n_bins && n_keys > 0) {
    const long long q = query[i];
    long long lo = __ldg(offsets + b), hi = __ldg(offsets + b + 1);
    const long long hi0 = hi;
    for (int it = 0; it < n_iter && lo < hi; ++it) {
      const long long mid = (lo + hi) >> 1;
      const long long km = __ldg(keys + min(max(mid, 0ll), n_keys - 1));
      if (km < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long pos = min(max(lo, 0ll), n_keys - 1);
    if (lo < hi0 && __ldg(keys + pos) == q) {
      t = __ldg(vals + pos);
      td = __ldg(vals_dense + pos);
    }
  }
  taxon[i] = t;
  taxon_dense[i] = td;
}

}  // namespace

// keys, vals, vals_dense, offsets: the planes above; query, bins: int64
// [n]; valid: bool [n]; taxon (uint32 bits) and taxon_dense: int32 [n].
extern "C" int kuniq_bsearch_lookup(const void* keys, const void* vals, const void* vals_dense,
                                    const void* offsets, const void* query, const void* bins,
                                    const void* valid, void* taxon, void* taxon_dense, long long n,
                                    long long n_keys, long long n_bins, int n_iter,
                                    long long bin_start, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n_iter < 0 || n_bins < 0) return (int)cudaErrorInvalidValue;
  const long long grid = (n + kThreads - 1) / kThreads;
  bsearch_lookup_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const uint32_t*)vals, (const int32_t*)vals_dense,
      (const long long*)offsets, (const long long*)query, (const long long*)bins,
      (const uint8_t*)valid, (uint32_t*)taxon, (int32_t*)taxon_dense, n, n_keys, n_bins, n_iter,
      bin_start);
  return (int)cudaGetLastError();
}
