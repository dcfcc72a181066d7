// Binary-search k-mer lookup over the sorted database planes.
//
// Replaces: krakenuniq_tpu/lookup/xla_lookup.py, lookup_kmers, which the
// JAX package left to XLA as a fori_loop of n_iter gather passes over the
// whole lane plane, and (the words entry) the bsearch branch of
// krakenuniq_tpu/classify/device_step.py:classify_step (minimizers, the
// canonical k-mers and lookup_kmers once a database). Semantics of the
// reference's kmer_query (krakendb.cpp:250-321): a lane's minimizer bin b
// (relative to bin_start) selects keys [offsets[b], offsets[b + 1]), sorted;
// a lower-bound search of n_iter steps finds the lane's canonical k-mer; on
// a match the lane takes vals and vals_dense at that position, else 0. A
// lane that is not searched, or whose bin lies outside [0, n_bins), reads
// nothing and gives 0. Planes: keys int64 [N] (canonical k-mers, below
// 2^62, so the signed compare is the unsigned one), vals uint32 [N] (the
// stored taxids), vals_dense int32 [N], offsets int64 [n_bins + 1].
//
// Bound on the H100: random 32-byte sectors. A searched lane makes 2 +
// n_iter dependent reads: the offsets pair, one key per step, then the key
// at the result and its two values (which share nothing with the lane's
// neighbours: bins are scattered over an 888 MB key plane at full size).
// Design: one thread per lane; the loop stops once the range is empty,
// which changes no result (an empty range stays empty for the remaining
// steps) and saves the last steps of small bins. Staging a run of lanes'
// shared bin in shared memory was tried and was slower (PERF.md, PR 13): a
// searched lane's bin holds ~35 keys on real reads, and the lanes of a run,
// each with its own k-mer, touch most of the bin's sectors between them in
// their own searches anyway.
//
// The words entry (kuniq_bsearch_words, bsearch_words_kernel) takes the span
// route's packed feed: a block owns a tile of lanes (kmer_window.cuh, half
// kmer_front's tile, so that more blocks an SM keep searches in flight),
// reads its lanes' lengths and, after the first database, their taxon words
// (a lane still 0 is still unclassified: a hit keyed on the stored taxid),
// stages its rows' code and flag words once, takes the minimizer bins of
// the lanes it searches with window_mins, forms each lane's canonical k-mer
// from the staged codes, and searches as above. No canonical k-mer or bin
// plane touches device memory. Databases are searched in hierarchy order,
// each call writing only the lanes still 0 (the first call every lane), so
// the first database's hit wins, as in the step's merge.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileShrink = 2;  // the words entry stages kmer_front's tile / this
constexpr int kWordsBlocks = 8;  // blocks an SM the words entry's registers must allow
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Planes {
  const long long* keys;
  const uint32_t* vals;
  const int32_t* vals_dense;
  const long long* offsets;
  long long n_keys, n_bins;
  int n_iter;
};

// The lookup of query q in relative bin b (in [0, n_bins), n_keys > 0):
// n_iter masked lower-bound steps, clamped reads. t, td: the values, 0
// where not found.
__device__ __forceinline__ void search_lane(const Planes& p, long long q, long long b, uint32_t* t,
                                            int32_t* td) {
  long long lo = __ldg(p.offsets + b), hi = __ldg(p.offsets + b + 1);
  const long long hi0 = hi;
  for (int it = 0; it < p.n_iter && lo < hi; ++it) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(p.keys + min(max(mid, 0ll), p.n_keys - 1)) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long pos = min(max(lo, 0ll), p.n_keys - 1);
  const bool found = lo < hi0 && __ldg(p.keys + pos) == q;
  *t = found ? __ldg(p.vals + pos) : 0u;
  *td = found ? __ldg(p.vals_dense + pos) : 0;
}

__global__ void __launch_bounds__(kThreads)
bsearch_lookup_kernel(Planes p, const long long* __restrict__ query, const long long* __restrict__ bins,
                      const uint8_t* __restrict__ valid, uint32_t* __restrict__ taxon,
                      int32_t* __restrict__ taxon_dense, long long n, long long bin_start) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t t = 0;
  int32_t td = 0;
  const long long b = bins[i] - bin_start;
  if (valid[i] && b >= 0 && b < p.n_bins && p.n_keys > 0) search_lane(p, query[i], b, &t, &td);
  taxon[i] = t;
  taxon_dense[i] = td;
}

template <typename V>
__global__ void __launch_bounds__(kThreads, kWordsBlocks)
bsearch_words_kernel(const uint32_t* __restrict__ codes, const uint32_t* __restrict__ ambig,
                     const int* __restrict__ lengths, Planes p, long long bin_start,
                     uint32_t* __restrict__ taxon, int32_t* __restrict__ taxon_dense, int B, int k, int nt,
                     bool first, kmer_window::Tiles g) {
  extern __shared__ uint64_t smem[];
  const kmer_window::Tile t = kmer_window::tile_of(g, B);
  const int n_lanes = t.rows * t.nl;
  const unsigned m_nl = kmer_window::magic(t.nl);
  uint32_t* s_need = reinterpret_cast<uint32_t*>(smem + g.nc64 + g.na64 + 2 * g.nv64);
  uint8_t* s_seg = reinterpret_cast<uint8_t*>(smem + g.nc64 + g.na64 + 2 * g.nv64 + g.nm64);
  // a bit per lane: in its read and, after the first database, still 0
  const int n_pad = (n_lanes + 31) / 32 * 32;
  bool any = false;
  for (int idx = threadIdx.x; idx < n_pad; idx += kThreads) {  // whole warps
    bool need = false;
    if (idx < n_lanes) {
      const int rr = kmer_window::fdiv(idx, t.nl, m_nl);
      const int l = t.lane0 + idx - rr * t.nl;
      const long long r = t.r0 + rr;
      need = lengths[r] - (k - 1) - l > 0 && (first || taxon[r * g.W + l] == 0u);
    }
    const unsigned m = __ballot_sync(kFull, need);
    if ((threadIdx.x & 31) == 0) s_need[idx >> 5] = m;
    any |= need;
  }
  if (!__syncthreads_or(any)) {
    for (int idx = threadIdx.x; first && idx < n_lanes; idx += kThreads) {  // no lane in its read: all 0
      const int rr = kmer_window::fdiv(idx, t.nl, m_nl);
      const long long at = (t.r0 + rr) * g.W + t.lane0 + idx - rr * t.nl;
      taxon[at] = 0u;
      taxon_dense[at] = 0;
    }
    return;
  }

  // stage the rows, and the minimizer bins of the values the marked lanes read
  const kmer_window::Win win = kmer_window::win_of(t, k, nt);
  kmer_window::segment_needs(s_need, t, win, s_seg);
  const int n = kmer_window::tile_span(t, g.LB, k);
  const long long first_base = t.r0 * g.LB + t.lane0;
  const int offc = kmer_window::stage_words(codes, first_base, n, 16, reinterpret_cast<uint32_t*>(smem),
                                            g.nc64);
  const uint64_t* a64 = smem + g.nc64;
  const int offa = kmer_window::stage_words(ambig, first_base, n, 32,
                                            reinterpret_cast<uint32_t*>(smem + g.nc64), g.na64);
  __syncthreads();
  V* S = reinterpret_cast<V*>(smem + g.nc64 + g.na64);
  V* P = reinterpret_cast<V*>(smem + g.nc64 + g.na64 + g.nv64);
  kmer_window::window_mins<V>(smem, offc, t, g.LB, nt, win, s_seg, S, P);

  const uint64_t maskk = (1ull << k) - 1;
  for (int idx = threadIdx.x; idx < n_lanes; idx += kThreads) {
    const int rr = kmer_window::fdiv(idx, t.nl, m_nl);
    const int l = idx - rr * t.nl;
    bool rem = false;
    uint32_t tv = 0;
    int32_t tdv = 0;
    if ((s_need[idx >> 5] >> (threadIdx.x & 31)) & 1u) {
      // free of ambiguous bases: a lane the step searches, still unclassified
      rem = (kmer_window::window64(a64, rr * g.LB + l + offa) & maskk) == 0;
      const long long b = rem ? (long long)kmer_window::window_bin(S, P, win, rr, l) - bin_start : -1;
      if (b >= 0 && b < p.n_bins && p.n_keys > 0) {
        const long long q =
            (long long)kmer_window::canonical(kmer_window::window64(smem, 2 * (rr * g.LB + l + offc)), k);
        search_lane(p, q, b, &tv, &tdv);
      }
    }
    if (rem || first) {
      const long long at = (t.r0 + rr) * g.W + t.lane0 + l;
      taxon[at] = tv;
      taxon_dense[at] = tdv;
    }
  }
}

Planes planes_of(const void* keys, const void* vals, const void* vals_dense, const void* offsets,
                 long long n_keys, long long n_bins, int n_iter) {
  return Planes{(const long long*)keys, (const uint32_t*)vals, (const int32_t*)vals_dense,
                (const long long*)offsets, n_keys, n_bins, n_iter};
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
      planes_of(keys, vals, vals_dense, offsets, n_keys, n_bins, n_iter), (const long long*)query,
      (const long long*)bins, (const uint8_t*)valid, (uint32_t*)taxon, (int32_t*)taxon_dense, n, bin_start);
  return (int)cudaGetLastError();
}

// codes: int32 [B, LB/16] and ambig: int32 [B, LB/32] words of
// encode_unit_packed (LB a multiple of 32); lengths: int32 [B]; the sorted
// planes of one database and its bin_start; taxon (uint32 bits) and
// taxon_dense: int32 [B, W], W <= LB - k + 1. A lane is searched iff it is
// in its read, free of ambiguous bases and (unless `first`) still 0 in
// taxon; such a lane takes the database's values (0 on a miss), every other
// lane keeps its words (with `first`: every other lane gets 0).
extern "C" int kuniq_bsearch_words(const void* codes, const void* ambig, const void* lengths,
                                   const void* keys, const void* vals, const void* vals_dense,
                                   const void* offsets, void* taxon, void* taxon_dense, int B, int LB, int W,
                                   int k, int nt, long long n_keys, long long n_bins, int n_iter,
                                   long long bin_start, int first, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  if (nt < 1 || nt > k || k > 31 || LB % 32 != 0 || W > LB - k + 1 || n_iter < 0 || n_bins < 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = nt > 16;
  const kmer_window::Tiles g = kmer_window::plan_tiles(
      B, LB, W, k, k - nt + 1, (wide ? kmer_window::kTileBasesU64 : kmer_window::kTileBasesU32) / kTileShrink,
      wide ? 8 : 4, true, true);
  const size_t smem = kmer_window::smem_bytes(g);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const auto kernel = wide ? bsearch_words_kernel<uint64_t> : bsearch_words_kernel<uint32_t>;
  kernel<<<(unsigned)g.grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)codes, (const uint32_t*)ambig, (const int*)lengths,
      planes_of(keys, vals, vals_dense, offsets, n_keys, n_bins, n_iter), bin_start, (uint32_t*)taxon,
      (int32_t*)taxon_dense, B, k, nt, first != 0, g);
  return (int)cudaGetLastError();
}
