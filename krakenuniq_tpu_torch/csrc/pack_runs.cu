// RLE rows of the span step: per read, the run-length encoding of its
// per-k-mer code packed into one row of u32 words, so that the host fetches
// one small row per read instead of the [B, W] planes.
//
// Replaces: _pack_runs, krakenuniq_tpu/classify/device_step.py:408-490,
// which the JAX package left to XLA (a cumsum of the change flags and masked
// reductions over R run slots). Per read b and k-mer lane l < n_kmers[b]:
//   code(l) = -1 if kmer_ambig[b, l], else ids[b, l] (as u32)
// a run is a maximal stretch of equal codes; run j's fields are its length
// (< 2^15), its ambiguity (constant within a run) and the largest id of its
// lanes (every lane of an unambiguous run has the same id). Row layouts:
//   compact (layout 0): R words id<<16 | amb<<15 | len, then
//                       call<<16 | n_runs
//   dense   (layout 1): R such words, then call, then hits<<16 | n_runs
//   wide    (layout 2): R ids (through `map` when given), R/2 words of two
//                       16-bit len | amb<<15 (even run low), then call,
//                       n_kmers, hits<<16 | n_runs
// Slots past the read's runs are zero (id 0, mapped in the wide layout).
// n_runs counts every run, also those past R: the host re-fetches such
// rows from the planes.
//
// Bound on the H100: bytes (an id and a flag per lane in, a row of R + 1
// to R + R/2 + 3 words per read out); the work per lane is a compare and a
// ballot, far below the integer rate.
//
// Design: one warp per read. It walks the read's valid lanes in steps of
// 32 (coalesced 128-byte id and 32-byte flag loads); each lane compares its
// code with the lane before (a shuffle; lane 0 takes the previous step's
// last), a ballot gives the step's run starts and a prefix popcount each
// lane's run index. The lane that starts run j <= R writes the run's start
// (and, run j < R, its ambiguity and id) to the warp's slots in shared
// memory; an ambiguous lane folds its id into its run's slot with a shared
// atomicMax. Run j's length is then start[j + 1] - start[j] (n_kmers for
// the last run), and lanes j < R write the row. No block-wide barrier: a
// warp's slots are its own.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // reads per block

struct Run {
  uint32_t id, amb, len;
};

__device__ __forceinline__ Run slot(const int* start, const uint32_t* idmax, const int* ambf,
                                    int j, int n_runs, int nk) {
  if (j >= n_runs) return {0u, 0u, 0u};
  const int e = j + 1 < n_runs ? start[j + 1] : nk;
  return {idmax[j], (uint32_t)ambf[j], (uint32_t)(e - start[j])};
}

__global__ void __launch_bounds__(kWarps * 32)
pack_runs_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ amb,
                 const int32_t* __restrict__ n_kmers, const int32_t* __restrict__ call,
                 const int32_t* __restrict__ hits, const int32_t* __restrict__ map, int n_map,
                 uint32_t* __restrict__ out, int B, int W, int R, int layout, int cols) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  int* start = smem + warp * (3 * R + 1);  // R + 1 run starts
  uint32_t* idmax = reinterpret_cast<uint32_t*>(start + R + 1);  // R ids
  int* ambf = start + 2 * R + 1;                                 // R flags
  for (int j = lane; j < R; j += 32) {
    idmax[j] = 0u;
    ambf[j] = 0;
  }
  __syncwarp();

  const int nk = min(max(n_kmers[b], 0), W);
  const int32_t* idr = ids + b * W;
  const uint8_t* ar = amb + b * W;
  int count = 0;  // runs started before this step
  int prev_a = 0;
  uint32_t prev_id = 0u;
  for (int base = 0; base < nk; base += 32) {
    const int p = base + lane;
    const bool v = p < nk;
    const int a = v ? (ar[p] != 0) : 0;
    const uint32_t id = v ? (uint32_t)idr[p] : 0u;
    int pa = __shfl_up_sync(0xffffffffu, a, 1);
    uint32_t pid = __shfl_up_sync(0xffffffffu, id, 1);
    if (lane == 0) {
      pa = prev_a;
      pid = prev_id;
    }
    const bool change = v && (p == 0 || a != pa || (!a && id != pid));
    const unsigned starts = __ballot_sync(0xffffffffu, change);
    const int rid = count + __popc(starts & (0xffffffffu >> (31 - lane))) - 1;
    if (change && rid <= R) start[rid] = p;
    if (change && rid < R) {
      ambf[rid] = a;
      if (!a) idmax[rid] = id;
    }
    if (v && a && rid < R) atomicMax(&idmax[rid], id);
    count += __popc(starts);
    prev_a = __shfl_sync(0xffffffffu, a, 31);
    prev_id = __shfl_sync(0xffffffffu, id, 31);
  }
  __syncwarp();

  const int n_runs = count;
  uint32_t* row = out + b * cols;
  if (layout != 2) {
    for (int j = lane; j < R; j += 32) {
      const Run r = slot(start, idmax, ambf, j, n_runs, nk);
      row[j] = (r.id << 16) | (r.amb << 15) | r.len;
    }
    if (lane == 0) {
      if (layout == 0) {
        row[R] = ((uint32_t)call[b] << 16) | (uint32_t)n_runs;
      } else {
        row[R] = (uint32_t)call[b];
        row[R + 1] = ((uint32_t)hits[b] << 16) | (uint32_t)n_runs;
      }
    }
    return;
  }
  for (int j = lane; j < R; j += 32) {
    const uint32_t id = slot(start, idmax, ambf, j, n_runs, nk).id;
    row[j] = map == nullptr ? id : ((long long)id < n_map ? (uint32_t)map[id] : 0u);
  }
  for (int j = lane; j < R / 2; j += 32) {
    const Run r0 = slot(start, idmax, ambf, 2 * j, n_runs, nk);
    const Run r1 = slot(start, idmax, ambf, 2 * j + 1, n_runs, nk);
    row[R + j] = (r0.len | (r0.amb << 15)) | ((r1.len | (r1.amb << 15)) << 16);
  }
  if (lane == 0) {
    row[R + R / 2] = (uint32_t)call[b];
    row[R + R / 2 + 1] = (uint32_t)n_kmers[b];
    row[R + R / 2 + 2] = ((uint32_t)hits[b] << 16) | (uint32_t)n_runs;
  }
}

}  // namespace

// ids: int32 [B, W]; amb: bool [B, W]; n_kmers, call, hits: int32 [B];
// map: int32 [n_map] or NULL; out: int32 [B, cols] with cols = R + 1
// (layout 0), R + 2 (1) or R + R/2 + 3 (2). R even and > 0, W < 2^15.
extern "C" int kuniq_pack_runs(const void* ids, const void* amb, const void* n_kmers,
                               const void* call, const void* hits, const void* map, int n_map,
                               void* out, int B, int W, int R, int layout, int cols,
                               void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (R <= 0 || R % 2 != 0 || W <= 0 || W >= (1 << 15) || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)kWarps * (3 * R + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + kWarps - 1) / kWarps;
  pack_runs_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const uint8_t*)amb, (const int32_t*)n_kmers, (const int32_t*)call,
      (const int32_t*)hits, (const int32_t*)map, n_map, (uint32_t*)out, B, W, R, layout, cols);
  return (int)cudaGetLastError();
}
