// Interval-stabbing scores of the read-level tree resolution.
//
// Replaces: krakenuniq_tpu/taxonomy/resolve.py, _scores_pallas and its
// kernel _make_score_kernel (the only Pallas kernel on the classify path).
// For each lane i of a read row:
//   score_i = #{ j : tin_j <= tin_i < tout_j }
// i.e. the number of hits on candidate i's root path. The caller
// sentinel-masks non-hit lanes (tin = 2^30, tout = -1) exactly as the TPU
// kernel's wrapper does, so those j lanes never count; scores at non-hit
// lanes i are garbage the caller masks out. Euler times are < 2^28.
//
// Bound on the H100: compare operations. Each (i, j) pair of a row costs a
// shared-memory read and two compares, O(W^2) per row against O(W) bytes of
// input and output, so memory traffic is far below the compare work.
//
// Design: a block owns R whole rows (R*W <= 1024 query lanes, 256 threads
// with 4 lanes each, held in registers) and stages those rows' (tin, tout)
// pairs in shared memory as int2, in j-tiles of at most 1024 lanes (8 KB),
// so any W runs without a fallback. Every thread walks the same j range of
// its own row, so the trip count is uniform; a warp's 32 lanes mostly share
// one row and their shared-memory reads broadcast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;     // query lanes per thread
constexpr int kTile = 1024;   // j lanes per shared-memory tile

__global__ void __launch_bounds__(kThreads)
scores_kernel(const int32_t* __restrict__ tins, const int32_t* __restrict__ touts,
              int32_t* __restrict__ out, int B, int W, int R, int TW) {
  extern __shared__ int2 s_io[];  // [R][TW] (tin, tout)
  const long long r0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, (long long)B - r0);
  const int items = rows * W;
  const int32_t* tin_b = tins + r0 * W;
  const int32_t* tout_b = touts + r0 * W;
  int32_t* out_b = out + r0 * W;

  for (int base = 0; base < items; base += kThreads * kItems) {
    int32_t q[kItems], acc[kItems];
    int srow[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int it = base + k * kThreads + (int)threadIdx.x;
      const bool ok = it < items;
      srow[k] = ok ? (it / W) * TW : 0;
      q[k] = ok ? tin_b[it] : 0;
      acc[k] = 0;
    }
    for (int j0 = 0; j0 < W; j0 += TW) {
      const int tw = min(TW, W - j0);
      __syncthreads();  // the previous tile is fully consumed
      for (int e = threadIdx.x; e < rows * tw; e += kThreads) {
        const int rr = e / tw;
        const int jj = e - rr * tw;
        s_io[rr * TW + jj] = make_int2(tin_b[rr * W + j0 + jj], tout_b[rr * W + j0 + jj]);
      }
      __syncthreads();
      for (int j = 0; j < tw; ++j) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int2 io = s_io[srow[k] + j];
          acc[k] += (io.x <= q[k]) & (io.y > q[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int it = base + k * kThreads + (int)threadIdx.x;
      if (it < items) out_b[it] = acc[k];
    }
  }
}

}  // namespace

extern "C" int kuniq_scores(const void* tins, const void* touts, void* out, int B, int W,
                            void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  const int R = W >= kThreads * kItems ? 1 : (kThreads * kItems) / W;
  const int TW = min(W, kTile);
  const size_t smem = sizeof(int2) * (size_t)R * TW;  // <= 8 KB
  const int grid = (B + R - 1) / R;
  scores_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tins, (const int32_t*)touts, (int32_t*)out, B, W, R, TW);
  return (int)cudaGetLastError();
}
