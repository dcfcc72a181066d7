// Interval-stabbing scores of the read-level tree resolution.
//
// Replaces: krakenuniq_tpu/taxonomy/resolve.py, _scores_pallas and its
// kernel _make_score_kernel (the only Pallas kernel on the classify path).
// For each lane i of a read row:
//   score_i = #{ hit j : tin_j <= tin_i < tout_j }   at a hit lane i,
//   score_i = 0                                      at a non-hit lane i,
// i.e. the number of hits on candidate i's root path. Euler times are
// < 2^28.
//
// Bound on the H100: the function moves 13 B per lane (tin, tout and the
// score, 4 B each, and the hit byte), which sets its floor (see
// chip_smoke.scores_bound). The all-pairs form of the TPU kernel did O(W^2)
// compares per row and ran at the integer issue rate.
//
// Design: one warp owns one row (or one 64-lane tile of a longer row). It
// compacts the row's hit lanes with __ballot_sync / __popc prefix sums into
// shared memory (tin, tout), so the work scales with the hit count H, not
// W, and answers only the H hit queries; non-hit lanes are written 0.
//  - Count form (rows with W <= 256): Euler intervals have tout > tin, so
//      score_i = #{hit j : tin_j <= q} - #{hit j : tout_j <= q},  q = tin_i
//    (the identity of resolve.py's _scores_sort). The warp sorts the H tins
//    and the H touts in registers (a bitonic network over P = 32E slots,
//    E <= 8 per lane, padded with INT_MAX: the padding sits past every
//    query, and being in both arrays it cancels anyway), then each query
//    takes two binary searches: O(W log H) per row instead of O(W^2).
//    Precondition tin_j <= tout_j at every hit lane; a row that breaks it
//    (checked with one vote) takes the pair form, so the kernel is exact on
//    any input (chip_smoke.py checks such rows).
//  - Pair form (W > 256, or the rows above): every compacted
//    query against every compacted hit; a longer row's 64-lane query tiles
//    go to separate warps, each walking the row's 256-lane hit tiles, so any
//    W runs. Each hit's (tin, tout) is a broadcast shared-memory read.
// The lane stride of tins/touts is a parameter, so the [B, W, 2] gather of
// resolve_reads is read in place.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;      // warps per block, one row (or long-row tile) each
constexpr int kCap = 256;      // lanes of a short row = the largest count-form sort
constexpr int kLongTile = 64;  // query lanes per warp in a row wider than kCap
constexpr unsigned kFull = 0xffffffffu;

struct WarpTile {
  int q[kCap];    // compacted queries (the hit lanes' tins)
  int acc[kCap];  // their scores
  int t[kCap];    // compacted hit tins (sorted in the count form)
  int o[kCap];    // compacted hit touts (sorted in the count form)
};

// Compacts the hit lanes of [c0, c0 + n) of one row in lane order: the k-th
// hit's tin and tout go to t[k], o[k] (and tin to q[k] when q is given).
// Returns the hit count.
__device__ int compact(const int32_t* tin, const int32_t* tout, const uint8_t* hit, int ls,
                       int c0, int n, int* q, int* t, int* o, int lane) {
  int base = 0;
  for (int c = 0; c < n; c += 32) {
    const int i = c0 + c + lane;
    const bool h = c + lane < n && hit[i];
    const unsigned bal = __ballot_sync(kFull, h);
    if (h) {
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      const int a = tin[(long long)i * ls], b = tout[(long long)i * ls];
      if (q != nullptr) q[pos] = a;
      t[pos] = a;
      o[pos] = b;
    }
    base += __popc(bal);
  }
  return base;
}

// Ascending sort of two arrays of 32E values held by one warp, element
// e = lane * E + r in register r: a bitonic network in its all-ascending
// form (each phase k opens with the flip e <-> e ^ (k - 1), then half-
// cleaners e <-> e ^ j), so the lower index of every pair keeps the minimum
// and pairs inside a lane need no direction select.
template <int E>
__device__ __forceinline__ void warp_sort2(int (&a)[E], int (&b)[E], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
    if (k <= E) {  // flip inside the lane: r <-> r ^ (k - 1)
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if ((r & (k >> 1)) == 0) {
          const int r2 = r ^ (k - 1);
          const int a0 = a[r], b0 = b[r];
          a[r] = min(a0, a[r2]);
          a[r2] = max(a0, a[r2]);
          b[r] = min(b0, b[r2]);
          b[r2] = max(b0, b[r2]);
        }
      }
    } else {  // flip across lanes: (lane, r) <-> (lane ^ (k/E - 1), E - 1 - r)
      const bool lower = (lane & (k / E >> 1)) == 0;
      int pa[E], pb[E];
#pragma unroll
      for (int r = 0; r < E; ++r) {
        pa[r] = __shfl_xor_sync(kFull, a[E - 1 - r], k / E - 1);
        pb[r] = __shfl_xor_sync(kFull, b[E - 1 - r], k / E - 1);
      }
#pragma unroll
      for (int r = 0; r < E; ++r) {
        a[r] = lower ? min(a[r], pa[r]) : max(a[r], pa[r]);
        b[r] = lower ? min(b[r], pb[r]) : max(b[r], pb[r]);
      }
    }
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1) {
      if (j >= E) {  // half-cleaner across lanes: lane ^ (j / E), same register
        const bool lower = (lane & (j / E)) == 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int pa = __shfl_xor_sync(kFull, a[r], j / E);
          const int pb = __shfl_xor_sync(kFull, b[r], j / E);
          a[r] = lower ? min(a[r], pa) : max(a[r], pa);
          b[r] = lower ? min(b[r], pb) : max(b[r], pb);
        }
      } else {  // half-cleaner inside the lane: r <-> r | j
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & j) == 0) {
            const int a0 = a[r], b0 = b[r];
            a[r] = min(a0, a[r | j]);
            a[r | j] = max(a0, a[r | j]);
            b[r] = min(b0, b[r | j]);
            b[r | j] = max(b0, b[r | j]);
          }
        }
      }
    }
  }
}

// #{ x in s[0, P) : x <= q } for an ascending s.
template <int P>
__device__ __forceinline__ int count_le(const int* s, int q) {
  const int* p = s;
#pragma unroll
  for (int step = P / 2; step > 0; step >>= 1) p += p[step - 1] <= q ? step : 0;
  return (int)(p - s) + (*p <= q);
}

template <int E>
__device__ void count_form(WarpTile& tl, int h, int lane) {
  constexpr int P = 32 * E;
  int a[E], b[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {  // slots past the h hits are padding
    const int e = lane * E + r;
    a[r] = e < h ? tl.t[e] : INT_MAX;
    b[r] = e < h ? tl.o[e] : INT_MAX;
  }
  warp_sort2<E>(a, b, lane);
  __syncwarp();  // every lane has read its slots
#pragma unroll
  for (int r = 0; r < E; ++r) {
    tl.t[lane * E + r] = a[r];
    tl.o[lane * E + r] = b[r];
  }
  __syncwarp();
  // min(E, 4) queries per lane per pass: their 2 min(E, 4) searches are
  // independent chains of dependent loads, which hides their latency
  constexpr int M = E < 4 ? E : 4;
  for (int c0 = 0; c0 < h; c0 += 32 * M) {
    int res[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = tl.q[min(c0 + 32 * m + lane, h - 1)];
      res[m] = count_le<P>(tl.t, q) - count_le<P>(tl.o, q);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (c0 + 32 * m + lane < h) tl.acc[c0 + 32 * m + lane] = res[m];
  }
}

// acc[c] += #{ j < nj : t[j] <= q[c] < o[j] } for the nq compacted queries,
// M = ceil(nq / 32) per lane.
template <int M>
__device__ void pair_pass(WarpTile& tl, int nq, int nj, int lane) {
  int q[M], acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = lane + 32 * m;
    q[m] = c < nq ? tl.q[c] : 0;
    acc[m] = c < nq ? tl.acc[c] : 0;
  }
  for (int j = 0; j < nj; ++j) {
    const int t = tl.t[j], o = tl.o[j];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] += (t <= q[m]) & (q[m] < o);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = lane + 32 * m;
    if (c < nq) tl.acc[c] = acc[m];
  }
}

__device__ void pair_dispatch(WarpTile& tl, int nq, int nj, int lane) {
  switch ((nq + 31) / 32) {
    case 1: pair_pass<1>(tl, nq, nj, lane); break;
    case 2: pair_pass<2>(tl, nq, nj, lane); break;
    case 3: pair_pass<3>(tl, nq, nj, lane); break;
    case 4: pair_pass<4>(tl, nq, nj, lane); break;
    case 5: pair_pass<5>(tl, nq, nj, lane); break;
    case 6: pair_pass<6>(tl, nq, nj, lane); break;
    case 7: pair_pass<7>(tl, nq, nj, lane); break;
    default: pair_pass<8>(tl, nq, nj, lane); break;
  }
}

// A row of W <= kCap lanes: every load of the row is issued at once, the
// chunk ballots stay in registers for the scatter back to lane order.
__device__ void short_row(WarpTile& tl, const int32_t* tin, const int32_t* tout,
                          const uint8_t* hr, int32_t* orow, int W, int ls, int lane) {
  constexpr int kChunks = kCap / 32;
  const unsigned below = (1u << lane) - 1u;
  const int n_chunks = (W + 31) / 32;
  unsigned bal[kChunks];
  int tv[kChunks], ov[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = 32 * c + lane;
    const bool in = c < n_chunks && i < W;
    const bool h = in && hr[i];
    // not gated on the hit byte: the three loads go out together
    tv[c] = in ? tin[(long long)i * ls] : 0;
    ov[c] = in ? tout[(long long)i * ls] : 0;
    bal[c] = c < n_chunks ? __ballot_sync(kFull, h) : 0u;
  }
  bool bad = false;
  int nq = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= n_chunks) break;
    if ((bal[c] >> lane) & 1u) {
      const int pos = nq + __popc(bal[c] & below);
      tl.q[pos] = tv[c];
      tl.t[pos] = tv[c];
      tl.o[pos] = ov[c];
      bad |= ov[c] < tv[c];
    }
    nq += __popc(bal[c]);
  }
  const bool count = !__any_sync(kFull, bad);
  __syncwarp();
  if (nq > 0 && count) {
    if (nq <= 32) count_form<1>(tl, nq, lane);
    else if (nq <= 64) count_form<2>(tl, nq, lane);
    else if (nq <= 128) count_form<4>(tl, nq, lane);
    else count_form<8>(tl, nq, lane);
  } else if (nq > 0) {
    for (int c = lane; c < nq; c += 32) tl.acc[c] = 0;
    pair_dispatch(tl, nq, nq, lane);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0, base = 0; c < kChunks; ++c) {  // non-hit lanes get 0
    if (c >= n_chunks) break;
    const int i = 32 * c + lane;
    if (i < W) orow[i] = (bal[c] >> lane) & 1u ? tl.acc[base + __popc(bal[c] & below)] : 0;
    base += __popc(bal[c]);
  }
}

// One query tile [i0, i0 + kLongTile) of a row of W > kCap lanes: the pair
// form against every 256-lane hit tile of the row.
__device__ void long_tile(WarpTile& tl, const int32_t* tin, const int32_t* tout,
                          const uint8_t* hr, int32_t* orow, int W, int ls, int i0, int lane) {
  const int ni = min(kLongTile, W - i0);
  const int nq = compact(tin, tout, hr, ls, i0, ni, tl.q, tl.t, tl.o, lane);
  for (int c = lane; c < nq; c += 32) tl.acc[c] = 0;
  for (int j0 = 0; nq > 0 && j0 < W; j0 += kCap) {
    __syncwarp();  // the previous hit tile is consumed
    const int nj = compact(tin, tout, hr, ls, j0, min(kCap, W - j0), nullptr, tl.t, tl.o, lane);
    __syncwarp();
    pair_dispatch(tl, nq, nj, lane);
  }
  __syncwarp();
  for (int c = 0, base = 0; c < ni; c += 32) {  // non-hit lanes get 0
    const int i = i0 + c + lane;
    const bool in = c + lane < ni;
    const bool h = in && hr[i];
    const unsigned bal = __ballot_sync(kFull, h);
    if (in) orow[i] = h ? tl.acc[base + __popc(bal & ((1u << lane) - 1u))] : 0;
    base += __popc(bal);
  }
}

// One warp per (row, query tile): a row of W <= 256 lanes is one tile, a
// longer one spreads its 64-lane query tiles over ceil(W / 64) warps.
__global__ void __launch_bounds__(kWarps * 32)
scores_kernel(const int32_t* __restrict__ tins, const int32_t* __restrict__ touts,
              const uint8_t* __restrict__ hit, int32_t* __restrict__ out, int B, int W,
              long long rs, int ls) {
  __shared__ WarpTile tiles[kWarps];
  const int lane = threadIdx.x & 31;
  const int n_tiles = W <= kCap ? 1 : (W + kLongTile - 1) / kLongTile;
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= (long long)B * n_tiles) return;  // whole warps leave; only __syncwarp is used
  const long long row = unit / n_tiles;
  WarpTile& tl = tiles[threadIdx.x >> 5];
  if (n_tiles == 1)
    short_row(tl, tins + row * rs, touts + row * rs, hit + row * W, out + row * W, W, ls, lane);
  else
    long_tile(tl, tins + row * rs, touts + row * rs, hit + row * W, out + row * W, W, ls,
              (int)(unit - row * n_tiles) * kLongTile, lane);
}

}  // namespace

// tins/touts: int32 rows at row stride rs and lane stride ls (elements);
// hit: bool [B, W]; out: int32 [B, W].
extern "C" int kuniq_scores(const void* tins, const void* touts, const void* hit, void* out,
                            int B, int W, long long rs, int ls, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  const long long units = (long long)B * (W <= kCap ? 1 : (W + kLongTile - 1) / kLongTile);
  const int grid = (int)((units + kWarps - 1) / kWarps);
  scores_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tins, (const int32_t*)touts, (const uint8_t*)hit, (int32_t*)out, B, W, rs,
      ls);
  return (int)cudaGetLastError();
}
