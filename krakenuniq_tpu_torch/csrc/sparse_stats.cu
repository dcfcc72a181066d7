// Sparse-regime statistics of one counter update, after the key sort: the
// buffer of distinct (unit, taxon, encoding) pairs of the groups that stayed
// sparse, then one event per (unit, taxon) group that went dense.
//
// Replaces: everything after the first sort of sparse_stats_core,
// krakenuniq_tpu/classify/sparse_exact.py:79-156, which the JAX package left
// to XLA: the pair and group flags, two segmented scans, the reversed scan
// that broadcasts each group's decision, and the second sort that compacts
// the emitted keys. Input: the sorted keys `sk` (uint64 keys
// unit<<57 | taxon<<32 | enc, pads all ones, each xor'd with the sign bit:
// the form torch.sort leaves them in when it sorts them as unsigned) and
// their stable sort permutation `ps` (each sorted lane's stream position).
// With key k_i at sorted lane i and its group g_i = k_i >> 32:
//   pair start  pb_i = valid_i && k_i != k_{i-1}    (pair end pe: k_{i+1})
//   group start gb_i = valid_i && g_i != g_{i-1}    (group end ge: g_{i+1})
//   d(g)  = #pair starts in g           (distinct encodings)
//   e(g)  = max over pair ends in g of ps_i << 1 | pb_i
// The pair holding the group's last stream position wins e(g); its low bit
// says whether that last insert was a first occurrence. The group stays
// sparse iff d < th or (d == th and e & 1), th = m/4 (the reference HLL's
// one-at-a-time conversion, hyperloglogplus.cpp:496-498). The buffer holds
// the pair keys of the stayed-sparse groups in key order, then the event
// keys 1<<63 | g of the other groups in key order, then pads (~0); it is
// truncated at buf_len, and n_pairs / n_events count all emitted keys.
// Because the keys ascend, pair keys have bit 63 clear (unit < 64) and event
// keys ascend with g, this order is the JAX package's second sort of the
// emitted keys: a stable two-way compaction replaces it.
//
// Bound on the H100: bytes. The sorted keys (8 B) and permutation (8 B) are
// read once per lane, and the buffer (8 B a slot) is written once; a few
// compares and adds per lane are far below the integer rate.
//
// Design: reduce-then-scan over tiles of kTile sorted lanes, in six
// launches: (1) each block reduces its tile to its group-start count and
// the segmented (d, e) carry across the tile; (2) one block scans the tile
// aggregates; (3) each block scans its tile again from its carry, and every
// group's end lane writes the group's decision at the group's ordinal (the
// scan of group starts): no group is walked by one warp, however many tiles
// it spans (zipf reads put ~10^5 lanes in one group, and so does the miss
// group 0 of every unit); (4) each block counts its emitted pairs and events
// (every lane reads its group's decision, so no reverse scan is needed);
// (5) one block scans those counts into the tiles' output offsets and the
// totals; (6) each block writes its keys at their offsets and the pads past
// the totals. A thread takes kItems consecutive lanes. The segmented scan
// state is three int32: ps < n < 2^29 keeps ps << 1 | 1 under 2^30.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr unsigned long long kPad = ~0ull;
constexpr unsigned long long kSign = 1ull << 63;
constexpr unsigned kFull = 0xffffffffu;

// A tile's or a prefix's scan state: `flag` whether a group starts in it,
// `d` and `e` the pair-start count and the largest pair-end value since the
// last group start, `g` the group starts in it.
struct Agg {
  int flag, d, e, g;
};

__device__ __forceinline__ Agg agg_op(Agg a, Agg b) {
  if (b.flag) return Agg{1, b.d, b.e, a.g + b.g};
  return Agg{a.flag, a.d + b.d, max(a.e, b.e), a.g + b.g};
}

struct AggOp {
  __device__ Agg operator()(Agg a, Agg b) const { return agg_op(a, b); }
};

struct SumOp {
  __device__ int2 operator()(int2 a, int2 b) const { return make_int2(a.x + b.x, a.y + b.y); }
};

__device__ __forceinline__ Agg shfl_up(Agg x, int off) {
  return Agg{__shfl_up_sync(kFull, x.flag, off), __shfl_up_sync(kFull, x.d, off),
             __shfl_up_sync(kFull, x.e, off), __shfl_up_sync(kFull, x.g, off)};
}

__device__ __forceinline__ int2 shfl_up(int2 x, int off) {
  return make_int2(__shfl_up_sync(kFull, x.x, off), __shfl_up_sync(kFull, x.y, off));
}

// Exclusive scan of one value per thread over the block (blockDim.x a
// multiple of 32); *total gets the block's total. Every thread must call it.
template <typename T, typename Op>
__device__ T block_exclusive(T x, T ident, Op op, T* total) {
  __shared__ T warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  T inc = x;
  for (int off = 1; off < 32; off <<= 1) {
    const T y = shfl_up(inc, off);
    if (lane >= off) inc = op(y, inc);
  }
  T before = shfl_up(inc, 1);
  if (lane == 0) before = ident;
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < n_warps ? warp_tot[lane] : ident;
    for (int off = 1; off < 32; off <<= 1) {
      const T y = shfl_up(w, off);
      if (lane >= off) w = op(y, w);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const T out = op(warp == 0 ? ident : warp_tot[warp - 1], before);
  *total = warp_tot[n_warps - 1];
  __syncthreads();  // the next call reuses warp_tot
  return out;
}

// One sorted lane's flags. `v` is ps << 1 | pb at a pair end, else -1.
struct Lane {
  unsigned long long key;
  bool pb, gb, ge;
  int v;
};

__device__ __forceinline__ unsigned long long key_at(const long long* sk, long long i, long long n) {
  return (i < 0 || i >= n) ? kPad : ((unsigned long long)sk[i] ^ kSign);
}

// The kItems lanes of this thread, from kItems + 2 key loads; ps may be null
// when the caller needs no `v`.
__device__ __forceinline__ void load_lanes(const long long* __restrict__ sk, const long long* __restrict__ ps,
                                           long long n, long long base, Lane (&l)[kItems]) {
  unsigned long long k[kItems + 2];
#pragma unroll
  for (int j = 0; j < kItems + 2; j++) k[j] = key_at(sk, base + j - 1, n);
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    const unsigned long long kp = k[j], kc = k[j + 1], kn = k[j + 2];
    const bool valid = kc != kPad;  // also false past n
    const bool pe = valid && kc != kn;
    l[j].key = kc;
    l[j].pb = valid && kc != kp;
    l[j].gb = valid && (kc >> 32) != (kp >> 32);
    l[j].ge = valid && (kc >> 32) != (kn >> 32);
    l[j].v = (pe && ps) ? (int)((ps[base + j] << 1) | (l[j].pb ? 1 : 0)) : -1;
  }
}

__device__ __forceinline__ Agg lane_agg(const Lane& l) {
  return Agg{l.gb, l.pb, l.v, l.gb};
}

__host__ __device__ __forceinline__ Agg agg_ident() { return Agg{0, 0, -1, 0}; }

// (1) each tile's aggregate
__global__ void __launch_bounds__(kThreads)
sparse_stats_reduce_kernel(const long long* __restrict__ sk, const long long* __restrict__ ps, long long n,
                           Agg* __restrict__ tile_agg) {
  Lane l[kItems];
  load_lanes(sk, ps, n, (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems, l);
  Agg acc = agg_ident();
#pragma unroll
  for (int j = 0; j < kItems; j++) acc = agg_op(acc, lane_agg(l[j]));
  Agg total;
  block_exclusive(acc, agg_ident(), AggOp(), &total);
  if (threadIdx.x == 0) tile_agg[blockIdx.x] = total;
}

// (2), (5) one block: out[t] = the exclusive scan of in[0..t); the total to
// *total when given (the tile counts: n_pairs and n_events)
template <typename T, typename Op>
__global__ void __launch_bounds__(kScanThreads)
sparse_stats_scan_kernel(const T* __restrict__ in, T* __restrict__ out, int n_tiles, T ident, Op op,
                         int* __restrict__ n_pairs, int* __restrict__ n_events) {
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(n_tiles, (int)threadIdx.x * per), hi = min(n_tiles, lo + per);
  T acc = ident;
  for (int t = lo; t < hi; t++) acc = op(acc, in[t]);
  T total;
  T run = block_exclusive(acc, ident, op, &total);
  for (int t = lo; t < hi; t++) {
    const T x = in[t];
    out[t] = run;
    run = op(run, x);
  }
  if constexpr (std::is_same_v<T, int2>) {
    if (threadIdx.x == 0 && n_pairs) {
      *n_pairs = total.x;
      *n_events = total.y;
    }
  }
}

// (3) each group's decision, written by its end lane at its ordinal
__global__ void __launch_bounds__(kThreads)
sparse_stats_decide_kernel(const long long* __restrict__ sk, const long long* __restrict__ ps, long long n,
                           int th, const Agg* __restrict__ tile_prefix, uint8_t* __restrict__ stays) {
  Lane l[kItems];
  load_lanes(sk, ps, n, (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems, l);
  Agg acc = agg_ident();
#pragma unroll
  for (int j = 0; j < kItems; j++) acc = agg_op(acc, lane_agg(l[j]));
  Agg total;
  Agg run = agg_op(tile_prefix[blockIdx.x], block_exclusive(acc, agg_ident(), AggOp(), &total));
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    run = agg_op(run, lane_agg(l[j]));
    if (l[j].ge) stays[run.g - 1] = run.d < th || (run.d == th && (run.e & 1));
  }
}

// This thread's lanes' emit flags (bit j: lane j emits), pairs and events,
// from the group decisions; the tile's group ordinal base comes from the
// tile's prefix.
__device__ __forceinline__ int2 emit_flags(const Lane (&l)[kItems], int g_base, const uint8_t* __restrict__ stays,
                                           unsigned* pair_bits, unsigned* event_bits) {
  int gs = 0;
#pragma unroll
  for (int j = 0; j < kItems; j++) gs += l[j].gb;
  int2 tile_gs;
  int g = g_base + block_exclusive(make_int2(gs, 0), make_int2(0, 0), SumOp(), &tile_gs).x;
  unsigned pb = 0, eb = 0;
  int2 cnt = make_int2(0, 0);
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    g += l[j].gb;
    if (l[j].pb || l[j].ge) {
      const bool s = stays[g - 1];
      if (l[j].pb && s) {
        pb |= 1u << j;
        cnt.x++;
      }
      if (l[j].ge && !s) {
        eb |= 1u << j;
        cnt.y++;
      }
    }
  }
  *pair_bits = pb;
  *event_bits = eb;
  return cnt;
}

// (4) each tile's emitted pairs and events
__global__ void __launch_bounds__(kThreads)
sparse_stats_count_kernel(const long long* __restrict__ sk, long long n, const Agg* __restrict__ tile_prefix,
                          const uint8_t* __restrict__ stays, int2* __restrict__ tile_cnt) {
  Lane l[kItems];
  load_lanes(sk, nullptr, n, (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems, l);
  unsigned pb, eb;
  const int2 cnt = emit_flags(l, tile_prefix[blockIdx.x].g, stays, &pb, &eb);
  int2 total;
  block_exclusive(cnt, make_int2(0, 0), SumOp(), &total);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = total;
}

// (6) the keys at their offsets; the pads past the totals
__global__ void __launch_bounds__(kThreads)
sparse_stats_write_kernel(const long long* __restrict__ sk, long long n, const Agg* __restrict__ tile_prefix,
                          const uint8_t* __restrict__ stays, const int2* __restrict__ tile_off,
                          const int* __restrict__ n_pairs, const int* __restrict__ n_events,
                          long long* __restrict__ buf, long long buf_len) {
  Lane l[kItems];
  load_lanes(sk, nullptr, n, (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems, l);
  unsigned pb, eb;
  const int2 cnt = emit_flags(l, tile_prefix[blockIdx.x].g, stays, &pb, &eb);
  int2 total;
  const int2 excl = block_exclusive(cnt, make_int2(0, 0), SumOp(), &total);
  const long long np = *n_pairs, ne = *n_events;
  long long pi = (long long)tile_off[blockIdx.x].x + excl.x;
  long long ei = np + tile_off[blockIdx.x].y + excl.y;
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    if (pb >> j & 1) {
      if (pi < buf_len) buf[pi] = (long long)l[j].key;
      pi++;
    }
    if (eb >> j & 1) {
      if (ei < buf_len) buf[ei] = (long long)(kSign | (l[j].key >> 32));
      ei++;
    }
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = np + ne + (long long)blockIdx.x * kThreads + threadIdx.x; i < buf_len; i += stride)
    buf[i] = (long long)kPad;
}

struct Scratch {
  Agg *agg, *prefix;
  int2 *cnt, *off;
  uint8_t* stays;
};

// Scratch bytes for n lanes: per tile two Agg and two int2, per lane a
// decision byte (groups <= lanes).
long long scratch_bytes(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  return tiles * (2 * (long long)sizeof(Agg) + 2 * (long long)sizeof(int2)) + n;
}

Scratch layout(void* base, long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  Scratch s;
  s.agg = (Agg*)base;
  s.prefix = s.agg + tiles;
  s.cnt = (int2*)(s.prefix + tiles);
  s.off = s.cnt + tiles;
  s.stays = (uint8_t*)(s.off + tiles);
  return s;
}

}  // namespace

// int64 words of scratch kuniq_sparse_stats needs for n lanes.
extern "C" int kuniq_sparse_stats_scratch(long long n) { return (int)((scratch_bytes(n) + 7) / 8); }

// sk, ps: int64 [n] sorted sign-flipped keys and their permutation; th = m/4;
// buf int64 [buf_len]; n_pairs, n_events int32 [1]; scratch of
// kuniq_sparse_stats_scratch(n) int64 words. 1 <= n < 2^29.
extern "C" int kuniq_sparse_stats(const void* sk, const void* ps, long long n, int th, void* buf, long long buf_len,
                                  void* n_pairs, void* n_events, void* scratch, void* stream) {
  if (n <= 0 || n >= (1LL << 29)) return (int)cudaErrorInvalidValue;
  const Scratch s = layout(scratch, n);
  const int tiles = (int)((n + kTile - 1) / kTile);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* k = (const long long*)sk;
  const long long* pp = (const long long*)ps;
  int* np = (int*)n_pairs;
  int* ne = (int*)n_events;
  sparse_stats_reduce_kernel<<<tiles, kThreads, 0, st>>>(k, pp, n, s.agg);
  sparse_stats_scan_kernel<Agg, AggOp><<<1, kScanThreads, 0, st>>>(s.agg, s.prefix, tiles, agg_ident(), AggOp(),
                                                                   nullptr, nullptr);
  sparse_stats_decide_kernel<<<tiles, kThreads, 0, st>>>(k, pp, n, th, s.prefix, s.stays);
  sparse_stats_count_kernel<<<tiles, kThreads, 0, st>>>(k, n, s.prefix, s.stays, s.cnt);
  sparse_stats_scan_kernel<int2, SumOp><<<1, kScanThreads, 0, st>>>(s.cnt, s.off, tiles, make_int2(0, 0), SumOp(),
                                                                     np, ne);
  sparse_stats_write_kernel<<<tiles, kThreads, 0, st>>>(k, n, s.prefix, s.stays, s.off, np, ne, (long long*)buf,
                                                        buf_len);
  return (int)cudaGetLastError();
}
