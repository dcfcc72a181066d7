// Sparse-regime statistics of one counter update: the sort keys of the
// counted lanes (sparse_keys, before the sort) and, after the sort, the
// buffer of distinct (unit, taxon, encoding) pairs of the groups that stayed
// sparse, then one event per (unit, taxon) group that went dense.
//
// Replaces: sparse_stats_core, krakenuniq_tpu/classify/sparse_exact.py:
// 79-156, which the JAX package left to XLA: the key build, the pair and
// group flags, two segmented scans, the reversed scan that broadcasts each
// group's decision, and the second sort that compacts the emitted keys. The
// first sort stays torch.sort (the JAX package's jax.lax.sort, outside any
// Pallas kernel).
//
// sparse_keys writes, per lane i of [B, W], the key
//   k_i = unit<<57 | taxon<<32 | enc   (counted lanes; all ones elsewhere)
// xor'd with the sign bit, the form in which torch.sort orders it as
// unsigned. After the stable sort, with key k_i at sorted lane i, its stream
// position ps_i and its group g_i = k_i >> 32:
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
// Bound on the H100: bytes. The key build reads 9 B a lane (taxon, encoding,
// flag) and writes the 8 B key; after the sort the stats read each sorted
// key once and the stream position only at pair ends, and write the buffer
// once. A few compares and adds per lane are far below the integer rate.
//
// Design. The key build is one launch of four lanes a thread (16-byte loads
// where the planes allow) that also clears the stats' look-back state, so
// no memset precedes them. The stats run in two launches over tiles of
// kTile sorted lanes, a tile a block, in the order of an atomic counter:
//  (A) decide: each tile reduces its lanes to the segmented (group start,
//      d, e) state of its tail (from its last group start on, or all of it
//      when no group starts in it) and publishes it; then it walks back
//      over its predecessors' published states to the nearest tile in
//      which a group starts, which gives the state carried into its head.
//      Where groups start in every tile, a tile needs only its
//      predecessor's own state, never a prefix, so no tile waits for
//      another's walk: a segmented reduction rather than a chained scan (a
//      tile in which no group starts publishes its resolved end state as
//      well, so that long groups and runs of pads fall back to a decoupled
//      look-back). Each group's end lane writes the group's decision at
//      the group's start lane and adds its emitted pairs (d when it stays)
//      and events (1 when not) to the two totals; the tile keeps the group
//      start carried into it for (B).
//  (B) emit: each lane reads the decision at its group's start; a
//      decoupled look-back over the tiles' (pairs, events) counts (each
//      tile's count and then its inclusive prefix published as one 64-bit
//      word each, a valid bit beside the two counts, so that no fence
//      orders a value before its flag) gives the tile's output offsets; the
//      keys go to their slots, the pads past the totals, and the totals to
//      n_pairs and n_events.
// No group is walked by one warp's lanes, however many tiles it spans (zipf
// reads put ~10^5 lanes in one group, and so does the miss group 0 of every
// unit): only (A)'s walk back crosses its tiles, 32 a step. A tile's keys
// are staged in shared memory by coalesced loads, all issued before any is
// used (with one padding word every 16, so that each thread's 16
// consecutive lanes read without bank conflicts); the stream positions are
// read only at pair ends, by coalesced predicated loads. The segmented scan
// state is four int32: ps < n < 2^29 keeps ps << 1 | 1 under 2^30. On the
// card the bytes do not bind the two passes: each tile's serial path after
// its loads (block scans, the walk back or look-back, the walk over its
// lanes) does, with few blocks an SM (PERF.md, Findings).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kStage = kTile + 2 + (kTile + 2) / 16 + 1;  // the tile, its two halo keys, the padding
constexpr int kKeyThreads = 256;
constexpr unsigned long long kPad = ~0ull;
constexpr unsigned long long kSign = 1ull << 63;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSpinMaxNs = 256;

// A run of sorted lanes' scan state: `flag` whether a group starts in it,
// `d` and `e` the pair-start count and the largest pair-end value since the
// last group start (or since the run's start), `s` the sorted lane of that
// group start (-1: none in the run).
struct __align__(16) Agg {
  int flag, d, e, s;
};

__device__ __forceinline__ Agg agg_op(Agg a, Agg b) {
  if (b.flag) return b;
  return Agg{a.flag, a.d + b.d, max(a.e, b.e), a.s};
}

struct AggOp {
  __device__ Agg operator()(Agg a, Agg b) const { return agg_op(a, b); }
};

struct SumOp {
  __device__ int2 operator()(int2 a, int2 b) const { return make_int2(a.x + b.x, a.y + b.y); }
};

struct MaxOp {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

__device__ __forceinline__ Agg agg_ident() { return Agg{0, 0, -1, -1}; }

__device__ __forceinline__ Agg shfl_up(Agg x, int off) {
  return Agg{__shfl_up_sync(kFull, x.flag, off), __shfl_up_sync(kFull, x.d, off),
             __shfl_up_sync(kFull, x.e, off), __shfl_up_sync(kFull, x.s, off)};
}
__device__ __forceinline__ Agg shfl_down(Agg x, int off) {
  return Agg{__shfl_down_sync(kFull, x.flag, off), __shfl_down_sync(kFull, x.d, off),
             __shfl_down_sync(kFull, x.e, off), __shfl_down_sync(kFull, x.s, off)};
}
__device__ __forceinline__ int2 shfl_up(int2 x, int off) {
  return make_int2(__shfl_up_sync(kFull, x.x, off), __shfl_up_sync(kFull, x.y, off));
}
__device__ __forceinline__ int shfl_up(int x, int off) { return __shfl_up_sync(kFull, x, off); }
// published values: written and read around the L1 (other blocks write them)
__device__ __forceinline__ void st_cg(Agg* p, Agg v) { __stcg((int4*)p, make_int4(v.flag, v.d, v.e, v.s)); }
__device__ __forceinline__ Agg ld_cg(const Agg* p) {
  const int4 x = __ldcg((const int4*)p);
  return Agg{x.x, x.y, x.z, x.w};
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

// A tile's status word: stored with release semantics after its value, and
// polled with acquire semantics (with a growing pause, so that the waiting
// threads leave the L2 to the tiles' loads) before the value is read.
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int wait_status(const int* status, int j) {
  int st;
  for (unsigned ns = 32; (st = ld_acquire(status + j)) == 0; ns = min(2 * ns, kSpinMaxNs)) __nanosleep(ns);
  return st;
}

// (A)'s walk back, by warp 0 for the tile of ordinal d: publishes the
// tile's own state `total` (status 2 when a group starts in it: the state
// at its end is then complete; else 1), then combines its predecessors'
// states, 32 at a time, the farther first, back to the nearest complete
// one: the state carried into the tile. A tile in which no group starts
// then publishes its complete end state too (status 3), so that a group
// spanning many tiles, or a run of pads, is walked as a decoupled
// look-back; elsewhere the walk stops at the tile before, and no tile
// waits for another's walk. Returns the carry to every thread; every
// thread must call it.
__device__ Agg carry_into(int d, Agg total, int* status, Agg* aggs, Agg* ends) {
  __shared__ Agg carry_sh;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) {
      st_cg(aggs + d, total);
      st_release(status + d, total.flag ? 2 : 1);
    }
    Agg run = agg_ident();
    for (int i = d - 1; d > 0; i -= 32) {
      const int j = i - lane;  // lane 0 the nearest
      const int st = j >= 0 ? wait_status(status, j) : 2;  // before ordinal 0: nothing (identity)
      const unsigned complete = __ballot_sync(kFull, st >= 2);
      const int stop = complete ? __ffs(complete) - 1 : 31;
      Agg x = j >= 0 && lane <= stop ? ld_cg((st == 3 ? ends : aggs) + j) : agg_ident();
      for (int off = 1; off < 32; off <<= 1) {  // lane 0 gets x_stop op ... op x_0
        const Agg y = shfl_down(x, off);
        if (lane + off < 32) x = agg_op(y, x);
      }
      run = agg_op(Agg{__shfl_sync(kFull, x.flag, 0), __shfl_sync(kFull, x.d, 0), __shfl_sync(kFull, x.e, 0),
                       __shfl_sync(kFull, x.s, 0)},
                   run);
      if (complete) break;
    }
    if (lane == 0) {
      carry_sh = run;
      if (!total.flag && d > 0) {
        st_cg(ends + d, agg_op(run, total));
        st_release(status + d, 3);
      }
    }
  }
  __syncthreads();
  return carry_sh;
}

// (B)'s output offsets: the (pairs, events) counts of the tiles before
// ordinal d, by decoupled look-back (warp 0; each tile's aggregate, then
// its inclusive prefix, published as one 64-bit word each: a valid bit,
// 31 bits of pairs, 31 of events, so that a poll is one load of each and
// no fence orders a value before its flag). Returns them to every thread;
// every thread must call it.
__device__ __forceinline__ unsigned long long pack2(int2 v) {
  return 1ull << 63 | (unsigned long long)(unsigned)v.x << 31 | (unsigned)v.y;
}
__device__ __forceinline__ int2 unpack2(unsigned long long w) {
  return make_int2((int)(w >> 31 & 0x7fffffffu), (int)(w & 0x7fffffffu));
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ int2 offsets_before(int d, int2 total, unsigned long long* aggs, unsigned long long* incls) {
  __shared__ int2 before_sh;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) st_relaxed((d == 0 ? incls : aggs) + d, pack2(total));
    int2 run = make_int2(0, 0);
    for (int i = d - 1; d > 0; i -= 32) {
      const int j = i - lane;
      unsigned long long w = 1ull << 63;  // before ordinal 0: an empty inclusive prefix
      bool inclusive = true;
      if (j >= 0) {
        for (unsigned ns = 32;; ns = min(2 * ns, kSpinMaxNs)) {
          const unsigned long long wi = ld_relaxed(incls + j), wa = ld_relaxed(aggs + j);
          if ((wi | wa) >> 63) {
            inclusive = wi >> 63;
            w = inclusive ? wi : wa;
            break;
          }
          __nanosleep(ns);
        }
      }
      const unsigned found = __ballot_sync(kFull, inclusive);
      const int stop = found ? __ffs(found) - 1 : 31;
      const int2 x = lane <= stop ? unpack2(w) : make_int2(0, 0);
      run.x += __reduce_add_sync(kFull, x.x);
      run.y += __reduce_add_sync(kFull, x.y);
      if (found) break;
    }
    if (lane == 0) {
      before_sh = run;
      if (d > 0) st_relaxed(incls + d, pack2(make_int2(run.x + total.x, run.y + total.y)));
    }
  }
  __syncthreads();
  return before_sh;
}

// The sorted keys of a tile, unflipped, in shared memory: position p holds
// sorted lane t0 - 1 + p (p = 0 and kTile + 1 are the halo; lanes outside
// [0, n) are pads) at sh[p + p / 16]. Each thread issues its kItems
// coalesced loads (at a clamped index, without a branch) before it uses any.
__device__ __forceinline__ void stage_keys(const long long* __restrict__ sk, long long n, long long t0,
                                           unsigned long long* sh) {
  long long k[kItems];
#pragma unroll
  for (int r = 0; r < kItems; r++) {
    const long long i = t0 + r * kThreads + threadIdx.x;
    k[r] = __ldg(sk + (i < n ? i : n - 1));
  }
  if (threadIdx.x < 2) {
    const int p = threadIdx.x ? kTile + 1 : 0;
    const long long i = t0 - 1 + p;
    sh[p + (p >> 4)] = i >= 0 && i < n ? (unsigned long long)__ldg(sk + i) ^ kSign : kPad;
  }
#pragma unroll
  for (int r = 0; r < kItems; r++) {
    const int p = 1 + r * kThreads + threadIdx.x;
    sh[p + (p >> 4)] = t0 + p - 1 < n ? (unsigned long long)k[r] ^ kSign : kPad;
  }
  __syncthreads();
}

// *p when c (a predicated load, evict-first), else 0
__device__ __forceinline__ long long ld_cs_if(const long long* p, bool c) {
  long long v = 0;
  asm volatile("{\n  .reg .pred q;\n  setp.ne.u32 q, %2, 0;\n  @q ld.global.cs.s64 %0, [%1];\n}"
               : "+l"(v) : "l"(p), "r"((unsigned)c));
  return v;
}

__device__ __forceinline__ unsigned long long sh_key(const unsigned long long* sh, int p) { return sh[p + (p >> 4)]; }

// This thread's kItems lanes' flags as bit masks (bit j: lane j).
struct Flags {
  unsigned pb, gb, pe, ge;
};

__device__ __forceinline__ Flags lane_flags(const unsigned long long* sh) {
  const int p0 = threadIdx.x * kItems;
  Flags f{0, 0, 0, 0};
  unsigned long long kp = sh_key(sh, p0), kc = sh_key(sh, p0 + 1);
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    const unsigned long long kn = sh_key(sh, p0 + j + 2);
    const bool valid = kc != kPad;  // also false past n
    f.pb |= (unsigned)(valid && kc != kp) << j;
    f.gb |= (unsigned)(valid && (kc >> 32) != (kp >> 32)) << j;
    f.pe |= (unsigned)(valid && kc != kn) << j;
    f.ge |= (unsigned)(valid && (kc >> 32) != (kn >> 32)) << j;
    kp = kc;
    kc = kn;
  }
  return f;
}

// Scratch, from its base: what the key build clears (the two passes' tile
// counters, the two totals, (B)'s published words, (A)'s status words),
// then (A)'s published states (each tile's own, and the complete end state
// of a tile in which no group starts), each tile's carried group start,
// and a decision byte per sorted lane, at the lane where its group starts.
struct Scratch {
  int *counter_a, *counter_b, *totals;
  unsigned long long *agg_b, *incl_b;
  int* status_a;
  Agg *agg_a, *end_a;
  int* head_start;
  uint8_t* stays;
};

__host__ __device__ __forceinline__ long long n_tiles(long long n) { return (n + kTile - 1) / kTile; }

// int32 words the key build clears
__host__ __device__ __forceinline__ long long clear_words(long long n) { return 4 + 5 * n_tiles(n); }

// byte offset of (A)'s aggregates: past the cleared words, on 16 bytes
__host__ __device__ __forceinline__ long long values_offset(long long n) { return (clear_words(n) * 4 + 15) / 16 * 16; }

__host__ __device__ __forceinline__ long long stays_offset(long long n) {
  return values_offset(n) + n_tiles(n) * (2 * sizeof(Agg) + sizeof(int));
}

__host__ __device__ __forceinline__ Scratch layout(void* base, long long n) {
  const long long tiles = n_tiles(n);
  char* b = (char*)base;
  Scratch s;
  s.counter_a = (int*)b;
  s.counter_b = s.counter_a + 1;
  s.totals = s.counter_a + 2;
  s.agg_b = (unsigned long long*)(b + 16);
  s.incl_b = s.agg_b + tiles;
  s.status_a = (int*)(s.incl_b + tiles);
  s.agg_a = (Agg*)(b + values_offset(n));
  s.end_a = s.agg_a + tiles;
  s.head_start = (int*)(s.end_a + tiles);
  s.stays = (uint8_t*)(b + stays_offset(n));
  return s;
}

long long scratch_bytes(long long n) { return stays_offset(n) + n; }

// The key of one lane: unit<<57 | taxon<<32 | enc (pads all ones), sign-flipped.
__device__ __forceinline__ long long lane_key(long long unit, int taxon, int enc, bool counted) {
  const unsigned long long k = ((unsigned long long)unit << 57) | ((unsigned long long)(long long)taxon << 32) |
                               (unsigned long long)(unsigned)enc;
  return (long long)((counted ? k : kPad) ^ kSign);
}

template <int kUnitBytes>
__device__ __forceinline__ long long unit_of(const void* unit, long long row) {
  if (kUnitBytes == 1) return ((const uint8_t*)unit)[row];
  if (kUnitBytes == 4) return ((const int32_t*)unit)[row];
  return ((const long long*)unit)[row];
}

// the sort keys, four lanes a thread; the look-back state cleared
template <int kUnitBytes>
__global__ void __launch_bounds__(kKeyThreads)
sparse_keys_kernel(const int32_t* __restrict__ taxa, const int32_t* __restrict__ enc,
                   const uint8_t* __restrict__ lanes, const void* __restrict__ unit, int w, long long n, bool vec,
                   long long* __restrict__ keys, int* __restrict__ clear, long long n_clear) {
  const long long tid = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
  for (long long i = tid; i < n_clear; i += (long long)gridDim.x * kKeyThreads) clear[i] = 0;
  const long long i0 = tid * 4;
  if (i0 >= n) return;
  long long row = i0 / w;
  int col = (int)(i0 - row * w);
  long long u = unit_of<kUnitBytes>(unit, row);
  if (vec && i0 + 4 <= n) {
    const int4 t = __ldcs((const int4*)(taxa + i0));
    const int4 e = __ldcs((const int4*)(enc + i0));
    const unsigned l = __ldcs((const unsigned*)(lanes + i0));
    const int tv[4] = {t.x, t.y, t.z, t.w}, ev[4] = {e.x, e.y, e.z, e.w};
    long long k[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      while (col >= w) {  // W < 4 may cross more than one row
        col -= w;
        u = unit_of<kUnitBytes>(unit, ++row);
      }
      k[j] = lane_key(u, tv[j], ev[j], (l >> (8 * j)) & 0xff);
      col++;
    }
    ((longlong2*)(keys + i0))[0] = make_longlong2(k[0], k[1]);
    ((longlong2*)(keys + i0))[1] = make_longlong2(k[2], k[3]);
    return;
  }
  for (long long i = i0; i < n && i < i0 + 4; i++) {
    while (col >= w) {
      col -= w;
      u = unit_of<kUnitBytes>(unit, ++row);
    }
    keys[i] = lane_key(u, taxa[i], enc[i], lanes[i] != 0);
    col++;
  }
}

// Lane j's scan state: its group start (at sorted lane t0 + its lane), its
// pair start, and at a pair end its stream position (from shared memory,
// as int32 at p + p / 16) << 1 | its pair start.
__device__ __forceinline__ Agg lane_agg(const Flags& f, const int* pos_sh, int j, int t0) {
  const int gb = f.gb >> j & 1, pb = f.pb >> j & 1, lane = threadIdx.x * kItems + j;
  return Agg{gb, pb, (f.pe >> j & 1) ? (pos_sh[lane + lane / 16] << 1) | pb : -1, gb ? t0 + lane : -1};
}

// (A) on one tile, its keys in `sh`: each group's decision, written by its
// end lane at its start lane; the two totals; the group start carried into
// the tile
__device__ __forceinline__ void decide_tile(int tile, unsigned long long* sh, const long long* __restrict__ ps,
                                            int th, Scratch s) {
  __shared__ unsigned pe_sh[kThreads];
  const int t0 = tile * kTile;
  const Flags f = lane_flags(sh);
  // the stream positions of the pair ends, by coalesced loads of the lanes
  // that need one (lane r * kThreads + t: bit t % 16 of thread r * 16 + t /
  // 16's mask), through the keys' shared memory as int32 at p + p / 16
  pe_sh[threadIdx.x] = f.pe;
  __syncthreads();
  int* pos_sh = (int*)sh;
  int pos[kItems];
#pragma unroll
  for (int r = 0; r < kItems; r++) {
    const int lane = r * kThreads + threadIdx.x;
    pos[r] = (int)ld_cs_if(ps + t0 + lane, pe_sh[lane / kItems] >> (lane % kItems) & 1);
  }
#pragma unroll
  for (int r = 0; r < kItems; r++) {
    const int lane = r * kThreads + threadIdx.x;
    pos_sh[lane + lane / 16] = pos[r];
  }
  __syncthreads();
  Agg acc = agg_ident();
#pragma unroll
  for (int j = 0; j < kItems; j++) acc = agg_op(acc, lane_agg(f, pos_sh, j, t0));
  Agg total;
  const Agg excl = block_exclusive(acc, agg_ident(), AggOp(), &total);
  const Agg carry = carry_into(tile, total, s.status_a, s.agg_a, s.end_a);
  if (threadIdx.x == 0) s.head_start[tile] = carry.s;
  Agg run = agg_op(carry, excl);
  int2 emitted = make_int2(0, 0);
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    run = agg_op(run, lane_agg(f, pos_sh, j, t0));
    if (f.ge >> j & 1) {
      const bool stays = run.d < th || (run.d == th && (run.e & 1));
      s.stays[run.s] = stays;
      if (stays)
        emitted.x += run.d;
      else
        emitted.y++;
    }
  }
  int2 tile_emitted;
  block_exclusive(emitted, make_int2(0, 0), SumOp(), &tile_emitted);
  if (threadIdx.x == 0 && (tile_emitted.x || tile_emitted.y)) {
    atomicAdd(s.totals, tile_emitted.x);
    atomicAdd(s.totals + 1, tile_emitted.y);
  }
}

// (B) on one tile, its keys in `sh`: the keys at their offsets (np: the
// pairs' total, which the events follow)
__device__ __forceinline__ void emit_tile(int tile, const unsigned long long* sh, Scratch s, long long np,
                                          long long* __restrict__ buf, long long buf_len) {
  const int t0 = tile * kTile;
  const Flags f = lane_flags(sh);
  // each lane's group start: the last one before it in the tile, or the
  // one carried into the tile
  const int last = f.gb ? t0 + threadIdx.x * kItems + 31 - __clz(f.gb) : -1;
  int max_all;
  int gs = max(s.head_start[tile], block_exclusive(last, -1, MaxOp(), &max_all));
  unsigned pair_bits = 0, event_bits = 0;
  int2 cnt = make_int2(0, 0);
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    if (f.gb >> j & 1) gs = t0 + threadIdx.x * kItems + j;
    const bool pb = f.pb >> j & 1, ge = f.ge >> j & 1;
    if (pb || ge) {
      const bool stays = s.stays[gs];
      if (pb && stays) {
        pair_bits |= 1u << j;
        cnt.x++;
      }
      if (ge && !stays) {
        event_bits |= 1u << j;
        cnt.y++;
      }
    }
  }
  int2 total;
  const int2 excl = block_exclusive(cnt, make_int2(0, 0), SumOp(), &total);
  const int2 before = offsets_before(tile, total, s.agg_b, s.incl_b);
  long long pi = before.x + excl.x, ei = np + before.y + excl.y;
  const int p0 = threadIdx.x * kItems + 1;
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    if (pair_bits >> j & 1) {
      if (pi < buf_len) buf[pi] = (long long)sh_key(sh, p0 + j);
      pi++;
    }
    if (event_bits >> j & 1) {
      if (ei < buf_len) buf[ei] = (long long)(kSign | (sh_key(sh, p0 + j) >> 32));
      ei++;
    }
  }
}

// the pads past the totals and the totals, over the grid
__device__ __forceinline__ void emit_tail(Scratch s, long long* __restrict__ buf, long long buf_len,
                                          int* __restrict__ n_pairs, int* __restrict__ n_events) {
  const long long np = s.totals[0], ne = s.totals[1], stride = (long long)gridDim.x * kThreads;
  for (long long i = np + ne + (long long)blockIdx.x * kThreads + threadIdx.x; i < buf_len; i += stride)
    buf[i] = (long long)kPad;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *n_pairs = (int)np;
    *n_events = (int)ne;
  }
}

// The next tile of a pass, from its counter, and its keys staged.
__device__ __forceinline__ int next_tile(const long long* __restrict__ sk, long long n, int* counter,
                                         unsigned long long* sh) {
  __shared__ int tile_sh;
  if (threadIdx.x == 0) tile_sh = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = tile_sh;
  stage_keys(sk, n, (long long)tile * kTile, sh);
  return tile;
}

// (A), a tile a block
__global__ void __launch_bounds__(kThreads)
sparse_stats_decide_kernel(const long long* __restrict__ sk, const long long* __restrict__ ps, long long n, int th,
                           Scratch s) {
  __shared__ unsigned long long sh[kStage];
  decide_tile(next_tile(sk, n, s.counter_a, sh), sh, ps, th, s);
}

// (B), a tile a block, and the tail
__global__ void __launch_bounds__(kThreads)
sparse_stats_emit_kernel(const long long* __restrict__ sk, long long n, Scratch s, long long* __restrict__ buf,
                         long long buf_len, int* __restrict__ n_pairs, int* __restrict__ n_events) {
  __shared__ unsigned long long sh[kStage];
  emit_tile(next_tile(sk, n, s.counter_b, sh), sh, s, s.totals[0], buf, buf_len);
  emit_tail(s, buf, buf_len, n_pairs, n_events);
}

}  // namespace

// int64 words of scratch kuniq_sparse_keys and kuniq_sparse_stats need for n lanes.
extern "C" int kuniq_sparse_stats_scratch(long long n) { return (int)((scratch_bytes(n) + 7) / 8); }

// taxa, enc int32 [b, w]; lanes bool [b, w]; unit [b] of unit_bytes (1:
// uint8, 4: int32, 8: int64); keys int64 [b * w] out; scratch of
// kuniq_sparse_stats_scratch(b * w) int64 words, its look-back state
// cleared for kuniq_sparse_stats (null: none). 1 <= b * w < 2^29.
extern "C" int kuniq_sparse_keys(const void* taxa, const void* enc, const void* lanes, const void* unit,
                                 int unit_bytes, int b, int w, void* keys, void* scratch, void* stream) {
  const long long n = (long long)b * w;
  if (b <= 0 || w <= 0 || n >= (1LL << 29)) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)taxa | (uintptr_t)enc | (uintptr_t)keys) % 16 == 0 && (uintptr_t)lanes % 4 == 0;
  const unsigned blocks = (unsigned)((n + 4LL * kKeyThreads - 1) / (4LL * kKeyThreads));
  cudaStream_t st = (cudaStream_t)stream;
  const long long nc = scratch ? clear_words(n) : 0;
  const int32_t* t = (const int32_t*)taxa;
  const int32_t* e = (const int32_t*)enc;
  const uint8_t* l = (const uint8_t*)lanes;
  long long* k = (long long*)keys;
  int* c = (int*)scratch;
  if (unit_bytes == 1)
    sparse_keys_kernel<1><<<blocks, kKeyThreads, 0, st>>>(t, e, l, unit, w, n, vec, k, c, nc);
  else if (unit_bytes == 4)
    sparse_keys_kernel<4><<<blocks, kKeyThreads, 0, st>>>(t, e, l, unit, w, n, vec, k, c, nc);
  else if (unit_bytes == 8)
    sparse_keys_kernel<8><<<blocks, kKeyThreads, 0, st>>>(t, e, l, unit, w, n, vec, k, c, nc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// sk, ps: int64 [n] sorted sign-flipped keys and their permutation; th = m/4;
// buf int64 [buf_len]; n_pairs, n_events int32 [1]; the scratch that
// kuniq_sparse_keys cleared for these n lanes. 1 <= n < 2^29.
extern "C" int kuniq_sparse_stats(const void* sk, const void* ps, long long n, int th, void* buf, long long buf_len,
                                  void* n_pairs, void* n_events, void* scratch, void* stream) {
  if (n <= 0 || n >= (1LL << 29)) return (int)cudaErrorInvalidValue;
  const Scratch s = layout(scratch, n);
  const int tiles = (int)n_tiles(n);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* k = (const long long*)sk;
  sparse_stats_decide_kernel<<<tiles, kThreads, 0, st>>>(k, (const long long*)ps, n, th, s);
  sparse_stats_emit_kernel<<<tiles, kThreads, 0, st>>>(k, n, s, (long long*)buf, buf_len, (int*)n_pairs,
                                                       (int*)n_events);
  return (int)cudaGetLastError();
}
