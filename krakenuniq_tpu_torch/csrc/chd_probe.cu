// CHD (compressed hash-and-displace) hash-table probe.
//
// Replaces: krakenuniq_tpu/lookup/hash_lookup.py, _probe_chd under the
// `valid` mask of hash_lookup_kmers, which the JAX package left to XLA as
// two row gathers. The table layout is db/hash_table.py's:
//   disp: uint32 [2^lg]       bucket g holds (d1 << 16) | d0
//   rows: uint32 [2^lr][4]    two 8-byte slots (r << lr | value) as (hi, lo)
// A query hash h splits into p = top lr bits and r = the low 64-lr bits;
//   g = top lg bits of r*GOLDEN, q = top lr bits of r*C2,
//   row = (p + d0 + d1*q) mod 2^lr,
// and a slot matches iff it stores r. The match pins all 64 bits of h, so
// the lookup is exact; an all-zero empty slot matches only r == 0 and then
// yields value 0, which reads as a miss. Output: the value, 0 on a miss or
// where `valid` is false.
//
// Bound on the H100: random 32-byte sectors. Each valid query makes two
// dependent reads at random addresses: 4 bytes of the displacement plane,
// then one 16-byte row. At full size (lr = 26, lg = 24) the row plane is
// 1.07 GB and the displacement plane 64 MB, itself larger than the 50 MB L2,
// so device memory serves one row sector per query plus the displacement
// sectors the L2 misses. The floor is the one-level random-row rate
// (chip_smoke.py's floor_ms: the row_gather kernel on the same row plane).
//
// Design: a thread takes Q = 4 consecutive queries. Their hashes come in
// as two 16-byte vectors and their flags as one 4-byte word; the thread
// issues all Q displacement loads, then all Q row loads, so 2Q loads of a
// thread are in flight at once, and writes the Q values as one 16-byte
// store. When the row plane is larger than the card's L2, the rows go
// through ld.global.cs (__ldcs: evict-first in L1 and L2): such a row is
// seldom read again, and marking it first to go leaves the L2 to the
// displacement plane, which is. A row plane that fits the L2 is re-read,
// and its rows keep the default priority (__ldg). The displacement words
// go through the read-only path (__ldg) with the default priority: on the
// card, an L2 evict_last policy on them (createpolicy, fractions 0.5-1.0),
// ld.global.cg and L1::no_allocate all measured slower, and
// L1::no_allocate on the rows lost the L1 reuse of repeated k-mers
// (PERF.md). A ragged end, or operands not aligned for the vector
// accesses, take the same path with scalar loads and stores. Invalid lanes
// skip both reads.
//
// The out-of-core entry, kuniq_chd_probe_acc (chd_probe_acc_kernel), folds
// one chunk table's hits into a span's accumulated word plane in place, from
// the span's packed feed. Replaces: krakenuniq_tpu/classify/device_step.py,
// _probe_chunk_core (the k-mer front, the search mask, the probe and the
// merge where(acc != 0, acc, word)), which the JAX package left to XLA and
// ran over every lane for every chunk. Chunks are cut along minimizer-bin
// ranges (db/chunked.py), so a k-mer is a key of no chunk but the one whose
// range [bin_lo, bin_hi) holds its bin (classify.cpp:447); the probe is
// exact, so a lane outside the range misses this chunk for certain, and
// hierarchical databases are probed in order (classify.cpp:927-936), so
// keeping the first nonzero word equals probing every lane and selecting.
// Bound on the H100: the acc word of each lane in a read (4 B), a random
// 32-byte sector of each plane per probed lane, and the bin work per base.
// Design: a block owns a tile of lanes (kmer_window.cuh). It first reads
// the acc words of its lanes (kNeed a thread in flight), keeps a bit per
// lane in its read and still 0, and stops when none is: once the first
// chunks have set a span's lanes, most blocks read only their acc words.
// Else it stages its rows' code and flag words and takes the bins of those
// lanes with kmer_window.cuh's window_mins (the kmer_bins kernel's code,
// skipping the blocks of values no such lane reads). A lane free of
// ambiguous bases whose bin lies in the range keeps its bit, and the kept
// lanes go into one list in shared memory, so that every thread of a probe
// round has work: a thread takes four listed lanes, forms their canonical
// k-mers and murmur hashes in registers, issues their displacement loads,
// then their row loads, with chd_probe's addressing and cache policy, and
// writes a lane's word back only where it hit. No hash plane, flag plane
// or search mask touches device memory.

// The fused-layout entry, kuniq_fused_probe (fused_probe_kernel), probes
// the two-choice table that the build falls back to when CHD placement
// fails. Replaces: krakenuniq_tpu/lookup/hash_lookup.py, _probe_fused
// under the `valid` mask of hash_lookup_kmers, which the JAX package left
// to XLA as two row gathers. The plane is u32 [2^lb][4] rows of (tag0,
// val0, tag1, val1); a query h has the buckets b1 = h >> (64-lb) and
// b2 = (h*GOLDEN) >> (64-lb), and a slot of bucket bc matches iff its tag
// is bits [lb, lb+32) of hc (h, or h*GOLDEN for b2) and the high bits of
// its value word are the choice bit and the low 32-lb bits of hc: all 64
// bits of hc, so the lookup is exact. The value is the word's low lb-1
// bits; an empty all-zero slot yields 0. Bound: random 32-byte sectors,
// one 16-byte row per valid query, and a second where the first holds no
// value for it. Design: the build is a two-choice cuckoo (db/hash_table.py,
// _host_place) that starts every key in its first bucket and moves it to
// its second only when evicted, so at the tables' loads most keys sit in
// b1. A thread takes kQF = 8 queries (hashes as four 16-byte vectors, flags
// as one 8-byte word, values out as two 16-byte stores), loads all their b1
// rows, compares, and then loads the b2 row only of the valid queries whose
// row-1 value is 0 (reusing row 1's registers where b2 == b1). Row 2 is
// never skipped on a tag match alone: an all-zero empty slot of b1 matches a
// query whose tag and high bits are zero, and yields 0. A nonzero row-1
// value matched all 64 bits of h, and GOLDEN is odd, so the same key cannot
// also match in b2 (the build stores each key once): max(v1, v2) = v1. Rows
// use chd_probe's cache policy.

// The raw two-level entries, kuniq_rows_probe (rows_probe_kernel) and
// kuniq_rows_probe_acc (chd_probe_acc_kernel over a RawTable), probe the
// tables of UID databases, whose raw 32-bit values leave no spare bits:
//   ptags:   u32 [2^lb][2]        a tag per slot, bits [lb, lb+32) of hc
//   confirm: u32 [2^(lb+1)][2]    per slot (low 32 bits of h, value)
// Replaces: krakenuniq_tpu/lookup/hash_lookup.py, _probe_rows under the
// `valid` mask of hash_lookup_kmers (and, out of core, inside
// _probe_chunk_core), which the JAX package left to XLA as three gathers.
// A query h has the buckets b1 = h >> (64-lb) and b2 = (h*GOLDEN) >> (64-lb)
// and the tags p1, p2 of h and h*GOLDEN. The probe takes the FIRST screened
// slot, in the order (b1, 0), (b1, 1), (b2, 0), (b2, 1), b2 only where
// b2 != b1, and confirms only that slot: the value where its confirm word
// holds h's low 32 bits, else 0. That is _probe_rows bit for bit, also for
// a query whose tag is 0, which screens on an empty slot (ptag 0, confirm
// (0, 0)) and then misses even when a later slot holds it. Bucket and slot
// indices are 32-bit: at lb <= 30, 2*b + 1 < 2^31.
// Bound on the H100: random 32-byte sectors. A valid query needs its b1 tag
// row, b2's only where b1 does not screen, and one confirm row where a tag
// screens. At the phase-4 table's size (lb = 27) ptags is 1.07 GB and
// confirm 2.15 GB, both past the 50 MB L2. Design: the build is a two-choice
// cuckoo that starts every key in b1 (db/hash_table.py, _host_place), so
// most valid queries screen at b1. A thread takes kQ queries (hashes as
// 16-byte vectors, flags as 4-byte words, values out as 16-byte stores).
// Round 1 loads each valid query's b1 tag row. Round 2 loads, side by side,
// the confirm row of each query a b1 slot screened and the b2 tag row of
// each that none did (where b2 != b1); round 3 the confirm row of the
// queries a b2 slot screened. So a query reads only the sectors the
// function needs: two where b1 screens, at most three where it does not.
// The slot is a 32-bit index with an explicit none, and no second tag row
// is kept beside the first, so the round fits the register budget that
// __launch_bounds__ takes from the table type (kQ and kMinBlocks are the
// table's). A confirm plane larger than the L2 goes through ld.global.cs
// (evict-first), leaving the L2 to the tag rows. The designs measured
// against it (b1's confirm pair loaded beside its tag row, so that a query
// screened at b1 is answered after one round; other kQ and minimum blocks)
// are in tools/variants/rows_probe_variants.cu, and the first design's
// round, both tag rows at once, is RawTableBoth below (PERF.md). The out-of-core pass is
// chd_probe_acc_kernel with the RawTable in place of the ChdTable: the
// front, the bins, the routing, the lane list and the merge are the same
// code, and only the probe round differs; it keeps the CHD pass's
// __launch_bounds__(kThreads) (the raw round measured no faster under a
// budget, and the CHD instance stays the same code). A pass whose blocks
// fill the card at most once (a work unit's [4096, W]) is bound by the
// longest chain of dependent loads in a block, not by sectors: it takes
// RawTableBoth, both tag rows in one round and the confirm row in a second.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 4;  // queries per thread
constexpr int kQF = 8;  // queries per thread (fused_probe)
constexpr int kNeed = 4;  // acc words a thread reads at once (chd_probe_acc)
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kC2 = 0xC2B2AE3D27D4EB4Full;

// A probe round over kQ queries (h, and v: valid) gives each valid query's
// stored value, 0 on a miss; kStream marks the plane read last as
// evict-first. A table type names its round's kQ (and a raw table the least
// blocks an SM must hold in rows_probe_kernel, kMinBlocks: the register
// budget of its __launch_bounds__; 1 sets none beyond kThreads'). The CHD
// table: a displacement word, then a 16-byte row.
struct ChdTable {
  static constexpr int kQ = 4;
  const uint32_t* disp;
  const uint4* rows;
  int lr, lg;

  template <bool kStream>
  __device__ __forceinline__ void probe(const uint64_t (&h)[kQ], const bool (&v)[kQ],
                                        uint32_t (&word)[kQ]) const {
    const uint64_t r_mask = (1ull << (64 - lr)) - 1;
    const uint32_t v_mask = (1u << lr) - 1;
    uint32_t d[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const uint32_t gi = (uint32_t)(((h[j] & r_mask) * kGolden) >> (64 - lg));
      d[j] = v[j] ? __ldg(disp + gi) : 0u;
    }
    uint4 rw[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const uint32_t p = (uint32_t)(h[j] >> (64 - lr));
      const uint32_t q = (uint32_t)(((h[j] & r_mask) * kC2) >> (64 - lr));
      const uint32_t row = (p + (d[j] & 0xFFFFu) + (d[j] >> 16) * q) & v_mask;
      const uint4* a = rows + row;
      rw[j] = !v[j] ? make_uint4(0u, 0u, 0u, 0u) : kStream ? __ldcs(a) : __ldg(a);
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const uint64_t r = h[j] & r_mask;
      const uint32_t e_hi = (uint32_t)(r >> (32 - lr));
      const uint32_t e_lo = (uint32_t)((r & ((1ull << (32 - lr)) - 1)) << lr);
      const uint32_t v0 = (rw[j].x == e_hi && (rw[j].y & ~v_mask) == e_lo) ? (rw[j].y & v_mask) : 0u;
      const uint32_t v1 = (rw[j].z == e_hi && (rw[j].w & ~v_mask) == e_lo) ? (rw[j].w & v_mask) : 0u;
      word[j] = v0 > v1 ? v0 : v1;
    }
  }
};

// The raw two-level table (the note above): each valid query's b1 tag row;
// then the confirm row of the first screened b1 slot, or, where none
// screened and b2 != b1, the b2 tag row; then the confirm row of the first
// screened b2 slot.
template <int Q, int MinBlocks>
struct RawTable {
  static constexpr int kQ = Q;
  static constexpr int kMinBlocks = MinBlocks;
  static constexpr uint32_t kNone = 0xFFFFFFFFu;  // no slot screened (2*b + 1 < 2^31)
  const uint2* ptags;
  const uint2* confirm;
  int lb;

  template <bool kStream>
  __device__ __forceinline__ uint2 confirm_row(uint32_t slot) const {
    return kStream ? __ldcs(confirm + slot) : __ldg(confirm + slot);
  }

  template <bool kStream>
  __device__ __forceinline__ void probe(const uint64_t (&h)[kQ], const bool (&v)[kQ],
                                        uint32_t (&word)[kQ]) const {
    uint2 t[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) t[j] = v[j] ? __ldg(ptags + (uint32_t)(h[j] >> (64 - lb))) : make_uint2(0u, 0u);
    uint32_t slot[kQ];
    unsigned second = 0u;  // bit j: query j goes on to b2
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const uint32_t b1 = (uint32_t)(h[j] >> (64 - lb)), p1 = (uint32_t)((h[j] << lb) >> 32);
      slot[j] = !v[j] ? kNone : t[j].x == p1 ? 2 * b1 : t[j].y == p1 ? 2 * b1 + 1 : kNone;
      if (v[j] && slot[j] == kNone && b1 != (uint32_t)((h[j] * kGolden) >> (64 - lb))) second |= 1u << j;
    }
    uint2 c[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      c[j] = make_uint2(0u, 0u);
      if (slot[j] != kNone) c[j] = confirm_row<kStream>(slot[j]);
      else if ((second >> j) & 1u) t[j] = __ldg(ptags + (uint32_t)((h[j] * kGolden) >> (64 - lb)));
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      word[j] = slot[j] != kNone && c[j].x == (uint32_t)h[j] ? c[j].y : 0u;
      if ((second >> j) & 1u) {
        const uint64_t hg = h[j] * kGolden;
        const uint32_t b2 = (uint32_t)(hg >> (64 - lb)), p2 = (uint32_t)((hg << lb) >> 32);
        slot[j] = t[j].x == p2 ? 2 * b2 : t[j].y == p2 ? 2 * b2 + 1 : kNone;
      }
    }
    if (second == 0u) return;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (!((second >> j) & 1u) || slot[j] == kNone) continue;
      c[j] = confirm_row<kStream>(slot[j]);
      word[j] = c[j].x == (uint32_t)h[j] ? c[j].y : 0u;
    }
  }
};

// The raw two-level table read in two dependent rounds: both buckets' tag
// rows of each valid query (b2's where b2 != b1), then the confirm row of
// its first screened slot. More sectors than RawTable's rounds (b2's tag row
// also where b1 screens), one dependent round less where b1 does not screen.
template <int Q, int MinBlocks>
struct RawTableBoth {
  static constexpr int kQ = Q;
  static constexpr int kMinBlocks = MinBlocks;
  static constexpr uint32_t kNone = 0xFFFFFFFFu;
  const uint2* ptags;
  const uint2* confirm;
  int lb;

  template <bool kStream>
  __device__ __forceinline__ void probe(const uint64_t (&h)[kQ], const bool (&v)[kQ],
                                        uint32_t (&word)[kQ]) const {
    uint2 t1[kQ], t2[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const uint32_t b1 = (uint32_t)(h[j] >> (64 - lb)), b2 = (uint32_t)((h[j] * kGolden) >> (64 - lb));
      t1[j] = v[j] ? __ldg(ptags + b1) : make_uint2(0u, 0u);
      t2[j] = v[j] && b2 != b1 ? __ldg(ptags + b2) : make_uint2(0u, 0u);
    }
    uint32_t slot[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const uint64_t hg = h[j] * kGolden;
      const uint32_t b1 = (uint32_t)(h[j] >> (64 - lb)), b2 = (uint32_t)(hg >> (64 - lb));
      const uint32_t p1 = (uint32_t)((h[j] << lb) >> 32), p2 = (uint32_t)((hg << lb) >> 32);
      slot[j] = !v[j] ? kNone
                : t1[j].x == p1 ? 2 * b1
                : t1[j].y == p1 ? 2 * b1 + 1
                : b2 == b1 ? kNone
                : t2[j].x == p2 ? 2 * b2
                : t2[j].y == p2 ? 2 * b2 + 1
                : kNone;
    }
    uint2 c[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      c[j] = slot[j] == kNone ? make_uint2(0u, 0u) : kStream ? __ldcs(confirm + slot[j]) : __ldg(confirm + slot[j]);
#pragma unroll
    for (int j = 0; j < kQ; ++j) word[j] = slot[j] != kNone && c[j].x == (uint32_t)h[j] ? c[j].y : 0u;
  }
};

// rows_probe's table: kQ = 4 and six blocks an SM (40 registers, no
// spills; eight spill). rows_probe_acc's: the
// CHD pass's kQ (the pass keeps its launch bounds); a pass whose blocks fill
// the card at most once is bound by its longest chain of dependent loads,
// and takes RawTableBoth's two rounds (PERF.md)
using RawProbeTable = RawTable<4, 6>;
using RawAccTable = RawTable<4, 1>;
using RawAccWaveTable = RawTableBoth<4, 1>;

template <bool kStreamRows>
__global__ void __launch_bounds__(kThreads)
chd_probe_kernel(const uint32_t* __restrict__ disp, const uint4* __restrict__ rows,
                 const uint64_t* __restrict__ hashes, const uint8_t* __restrict__ valid,
                 uint32_t* __restrict__ out, long long n, int lr, int lg) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kQ;
  if (i0 >= n) return;
  const bool vec = i0 + kQ <= n && !(((uintptr_t)hashes | (uintptr_t)out) & 15) &&
                   !((uintptr_t)valid & 3);
  uint64_t h[kQ];
  bool v[kQ];
  if (vec) {
    const ulonglong2 h01 = reinterpret_cast<const ulonglong2*>(hashes + i0)[0];
    const ulonglong2 h23 = reinterpret_cast<const ulonglong2*>(hashes + i0)[1];
    const uint32_t flags = *reinterpret_cast<const uint32_t*>(valid + i0);
    h[0] = h01.x;
    h[1] = h01.y;
    h[2] = h23.x;
    h[3] = h23.y;
#pragma unroll
    for (int j = 0; j < kQ; ++j) v[j] = (flags >> (8 * j)) & 0xFFu;
  } else {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      v[j] = i0 + j < n && valid[i0 + j];
      h[j] = v[j] ? hashes[i0 + j] : 0;
    }
  }
  const uint64_t r_mask = (1ull << (64 - lr)) - 1;
  uint32_t d[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const uint32_t g = (uint32_t)(((h[j] & r_mask) * kGolden) >> (64 - lg));
    d[j] = v[j] ? __ldg(disp + g) : 0u;
  }
  const uint32_t v_mask = (1u << lr) - 1;
  uint4 rw[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const uint32_t p = (uint32_t)(h[j] >> (64 - lr));
    const uint32_t q = (uint32_t)(((h[j] & r_mask) * kC2) >> (64 - lr));
    const uint32_t row = (p + (d[j] & 0xFFFFu) + (d[j] >> 16) * q) & v_mask;
    const uint4* at = rows + row;
    rw[j] = !v[j] ? make_uint4(0u, 0u, 0u, 0u) : kStreamRows ? __ldcs(at) : __ldg(at);
  }
  uint32_t res[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const uint64_t r = h[j] & r_mask;
    const uint32_t e_hi = (uint32_t)(r >> (32 - lr));
    const uint32_t e_lo = (uint32_t)((r & ((1ull << (32 - lr)) - 1)) << lr);
    const uint32_t v0 = (rw[j].x == e_hi && (rw[j].y & ~v_mask) == e_lo) ? (rw[j].y & v_mask) : 0u;
    const uint32_t v1 = (rw[j].z == e_hi && (rw[j].w & ~v_mask) == e_lo) ? (rw[j].w & v_mask) : 0u;
    res[j] = v[j] ? (v0 > v1 ? v0 : v1) : 0u;
  }
  if (vec) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      if (i0 + j < n) out[i0 + j] = res[j];
  }
}

template <typename V, typename Table, bool kStreamRows>
__global__ void __launch_bounds__(kThreads)
chd_probe_acc_kernel(const uint32_t* __restrict__ codes, const uint32_t* __restrict__ ambig,
                     const int* __restrict__ lengths, const Table tab, uint32_t* __restrict__ acc,
                     int B, int k, int nt, uint64_t bin_lo, uint64_t bin_hi, kmer_window::Tiles g) {
  extern __shared__ uint64_t smem[];
  const kmer_window::Tile t = kmer_window::tile_of(g, B);
  const int n_lanes = t.rows * t.nl;
  const unsigned m_nl = kmer_window::magic(t.nl);
  uint32_t* s_need = reinterpret_cast<uint32_t*>(smem + g.nc64 + g.na64 + 2 * g.nv64);
  uint8_t* s_seg = reinterpret_cast<uint8_t*>(smem + g.nc64 + g.na64 + 2 * g.nv64 + g.nm64);
  // a bit per lane: in its read and still 0 (a warp's 32 lanes make a
  // word). A thread reads kNeed acc words before it tests the first, so
  // that their loads are in flight together: once the first chunks have
  // set most lanes, most blocks do nothing else.
  const int n_pad = (n_lanes + 31) / 32 * 32;
  bool any = false;
  for (int base = 0; base < n_pad; base += kNeed * kThreads) {
    uint32_t a[kNeed];
    int rest[kNeed];  // the lane's k-mers left in its read
#pragma unroll
    for (int j = 0; j < kNeed; ++j) {
      const int idx = base + j * kThreads + threadIdx.x;
      a[j] = 1u;
      rest[j] = 0;
      if (idx < n_lanes) {
        const int rr = kmer_window::fdiv(idx, t.nl, m_nl);
        const int l = t.lane0 + idx - rr * t.nl;
        const long long r = t.r0 + rr;
        a[j] = acc[r * g.W + l];
        rest[j] = lengths[r] - (k - 1) - l;
      }
    }
#pragma unroll
    for (int j = 0; j < kNeed; ++j) {
      const int idx = base + j * kThreads + threadIdx.x;
      if (idx < n_pad) {  // the same for a whole warp
        const bool need = rest[j] > 0 && a[j] == 0u;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, need);
        if ((threadIdx.x & 31) == 0) s_need[idx >> 5] = m;
        any |= need;
      }
    }
  }
  if (!__syncthreads_or(any)) return;

  // stage the rows, and mark the blocks of values the unset lanes read
  const kmer_window::Win win = kmer_window::win_of(t, k, nt);
  kmer_window::segment_needs(s_need, t, win, s_seg);
  const int n = kmer_window::tile_span(t, g.LB, k);
  const long long first = t.r0 * g.LB + t.lane0;
  const int offc = kmer_window::stage_words(codes, first, n, 16, reinterpret_cast<uint32_t*>(smem),
                                            g.nc64);
  const uint64_t* a64 = smem + g.nc64;
  const int offa = kmer_window::stage_words(ambig, first, n, 32,
                                            reinterpret_cast<uint32_t*>(smem + g.nc64), g.na64);
  __syncthreads();
  V* S = reinterpret_cast<V*>(smem + g.nc64 + g.na64);
  V* P = reinterpret_cast<V*>(smem + g.nc64 + g.na64 + g.nv64);
  kmer_window::window_mins<V>(smem, offc, t, g.LB, nt, win, s_seg, S, P);

  // route: a lane still 0, free of ambiguous bases and whose bin lies in
  // the range keeps its bit (each warp rewrites the words it reads)
  const uint64_t maskk = (1ull << k) - 1;
  for (int wi = threadIdx.x >> 5; wi < n_pad >> 5; wi += kThreads >> 5) {
    const int idx = (wi << 5) | (threadIdx.x & 31);
    bool probe = false;
    if ((s_need[wi] >> (threadIdx.x & 31)) & 1u) {
      const int rr = kmer_window::fdiv(idx, t.nl, m_nl);
      const int l = idx - rr * t.nl;
      const uint64_t bin = kmer_window::window_bin(S, P, win, rr, l);
      probe = bin >= bin_lo && bin < bin_hi &&
              (kmer_window::window64(a64, rr * g.LB + l + offa) & maskk) == 0;
    }
    const unsigned m = __ballot_sync(0xFFFFFFFFu, probe);
    if ((threadIdx.x & 31) == 0) s_need[wi] = m;
  }
  // the routed lanes as one list (in the values' space, free now), so that
  // every thread of a round has a query
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  int* s_list = reinterpret_cast<int*>(S);
  for (int wi = threadIdx.x >> 5; wi < n_pad >> 5; wi += kThreads >> 5) {
    const unsigned m = s_need[wi];
    int at0 = 0;
    if ((threadIdx.x & 31) == 0 && m != 0u) at0 = atomicAdd(&s_count, __popc(m));
    at0 = __shfl_sync(0xFFFFFFFFu, at0, 0);
    const unsigned lane = threadIdx.x & 31;
    if ((m >> lane) & 1u) s_list[at0 + __popc(m & ((1u << lane) - 1u))] = (wi << 5) | (int)lane;
  }
  __syncthreads();
  const int n_probe = s_count;

  constexpr int Q = Table::kQ;
  for (int base = 0; base < n_probe; base += Q * kThreads) {
    uint64_t h[Q];
    bool v[Q];
    long long at[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      v[j] = i < n_probe;
      h[j] = 0;
      at[j] = 0;
      if (v[j]) {
        const int idx = s_list[i];
        const int rr = kmer_window::fdiv(idx, t.nl, m_nl);
        const int l = idx - rr * t.nl;
        const uint64_t r = kmer_window::window64(smem, 2 * (rr * g.LB + l + offc));
        h[j] = kmer_window::murmur3_finalizer(kmer_window::canonical(r, k));
        at[j] = (t.r0 + rr) * g.W + t.lane0 + l;
      }
    }
    bool any_v = false;
#pragma unroll
    for (int j = 0; j < Q; ++j) any_v = any_v || v[j];
    if (!any_v) continue;
    uint32_t word[Q];
    tab.template probe<kStreamRows>(h, v, word);
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (v[j] && word[j] != 0u) acc[at[j]] = word[j];
  }
}

template <typename Table, bool kStreamConfirm>
__global__ void __launch_bounds__(kThreads, Table::kMinBlocks)
rows_probe_kernel(const Table tab, const uint64_t* __restrict__ hashes, const uint8_t* __restrict__ valid,
                  uint32_t* __restrict__ out, long long n) {
  constexpr int Q = Table::kQ;
  static_assert(Q % 4 == 0, "flags load as 4-byte words, values store as 16-byte vectors");
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * Q;
  if (i0 >= n) return;
  const bool vec = i0 + Q <= n && !(((uintptr_t)hashes | (uintptr_t)out) & 15) &&
                   !((uintptr_t)valid & 3);
  uint64_t h[Q];
  bool v[Q];
  if (vec) {
#pragma unroll
    for (int j = 0; j < Q; j += 2) {
      const ulonglong2 hh = reinterpret_cast<const ulonglong2*>(hashes + i0)[j / 2];
      h[j] = hh.x;
      h[j + 1] = hh.y;
    }
#pragma unroll
    for (int j = 0; j < Q; j += 4) {
      const uint32_t flags = reinterpret_cast<const uint32_t*>(valid + i0)[j / 4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) v[j + jj] = (flags >> (8 * jj)) & 0xFFu;
    }
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      v[j] = i0 + j < n && valid[i0 + j];
      h[j] = v[j] ? hashes[i0 + j] : 0;
    }
  }
  uint32_t res[Q];
  tab.template probe<kStreamConfirm>(h, v, res);
  if (vec) {
#pragma unroll
    for (int j = 0; j < Q; j += 4)
      reinterpret_cast<uint4*>(out + i0)[j / 4] = make_uint4(res[j], res[j + 1], res[j + 2], res[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (i0 + j < n) out[i0 + j] = res[j];
  }
}

template <bool kStreamRows>
__global__ void __launch_bounds__(kThreads)
fused_probe_kernel(const uint4* __restrict__ fused, const uint64_t* __restrict__ hashes,
                   const uint8_t* __restrict__ valid, uint32_t* __restrict__ out, long long n,
                   int lb) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kQF;
  if (i0 >= n) return;
  const bool vec = i0 + kQF <= n && !(((uintptr_t)hashes | (uintptr_t)out) & 15) &&
                   !((uintptr_t)valid & 7);
  uint64_t h[kQF];
  bool v[kQF];
  if (vec) {
#pragma unroll
    for (int j = 0; j < kQF; j += 2) {
      const ulonglong2 hh = reinterpret_cast<const ulonglong2*>(hashes + i0)[j / 2];
      h[j] = hh.x;
      h[j + 1] = hh.y;
    }
    const uint2 flags = *reinterpret_cast<const uint2*>(valid + i0);
#pragma unroll
    for (int j = 0; j < kQF; ++j) v[j] = ((j < 4 ? flags.x : flags.y) >> (8 * (j & 3))) & 0xFFu;
  } else {
#pragma unroll
    for (int j = 0; j < kQF; ++j) {
      v[j] = i0 + j < n && valid[i0 + j];
      h[j] = v[j] ? hashes[i0 + j] : 0;
    }
  }
  const int v_bits = lb - 1;
  const uint32_t tax_mask = (1u << v_bits) - 1, hi_mask = ~tax_mask;
  const uint64_t spare_mask = (1ull << (32 - lb)) - 1;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // round 1: every query's first-choice row
  uint4 rw[kQF];
#pragma unroll
  for (int j = 0; j < kQF; ++j) {
    const uint4* a1 = fused + (h[j] >> (64 - lb));
    rw[j] = !v[j] ? zero : kStreamRows ? __ldcs(a1) : __ldg(a1);
  }
  uint32_t res[kQF];
#pragma unroll
  for (int j = 0; j < kQF; ++j) {
    const uint32_t t1 = (uint32_t)((h[j] << lb) >> 32);
    const uint32_t hi1 = (uint32_t)(h[j] & spare_mask) << v_bits;
    uint32_t best = 0u;
    if (rw[j].x == t1 && (rw[j].y & hi_mask) == hi1) best = max(best, rw[j].y & tax_mask);
    if (rw[j].z == t1 && (rw[j].w & hi_mask) == hi1) best = max(best, rw[j].w & tax_mask);
    res[j] = v[j] ? best : 0u;
  }
  // round 2: the second-choice row of the valid queries row 1 left at 0
#pragma unroll
  for (int j = 0; j < kQF; ++j) {
    const uint32_t b1 = (uint32_t)(h[j] >> (64 - lb));
    const uint32_t b2 = (uint32_t)((h[j] * kGolden) >> (64 - lb));
    if (v[j] && res[j] == 0u && b2 != b1) rw[j] = kStreamRows ? __ldcs(fused + b2) : __ldg(fused + b2);
  }
#pragma unroll
  for (int j = 0; j < kQF; ++j) {
    if (!v[j] || res[j] != 0u) continue;
    const uint64_t hg = h[j] * kGolden;
    const uint32_t t2 = (uint32_t)((hg << lb) >> 32);
    const uint32_t hi2 = ((uint32_t)(hg & spare_mask) << v_bits) | 0x80000000u;
    uint32_t best = 0u;
    if (rw[j].x == t2 && (rw[j].y & hi_mask) == hi2) best = max(best, rw[j].y & tax_mask);
    if (rw[j].z == t2 && (rw[j].w & hi_mask) == hi2) best = max(best, rw[j].w & tax_mask);
    res[j] = best;
  }
  if (vec) {
    reinterpret_cast<uint4*>(out + i0)[0] = make_uint4(res[0], res[1], res[2], res[3]);
    reinterpret_cast<uint4*>(out + i0)[1] = make_uint4(res[4], res[5], res[6], res[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kQF; ++j)
      if (i0 + j < n) out[i0 + j] = res[j];
  }
}

// the row plane streams past the L2 (evict-first) when it is larger than it
int stream_rows(int lr, bool* out) {
  int dev = 0, l2_bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, dev);
  *out = (long long)sizeof(uint4) << lr > l2_bytes;
  return (int)err;
}

// the out-of-core pass's launch plan over a chunk table whose plane read
// last is 16 B << width (lr, or a raw table's lb): the tiles, their shared
// memory, and whether that plane streams past the L2; err != 0 where the
// arguments or the card refuse
struct AccPlan {
  kmer_window::Tiles g;
  size_t smem;
  bool wide, streamed;
  int err;
};

AccPlan acc_plan(int B, int LB, int W, int k, int nt, int width) {
  AccPlan p{};
  if (nt < 1 || nt > k || k > 31 || LB % 32 != 0 || W > LB - k + 1) {
    p.err = (int)cudaErrorInvalidValue;
    return p;
  }
  p.err = stream_rows(width, &p.streamed);
  if (p.err != 0) return p;
  p.wide = nt > 16;
  p.g = kmer_window::plan_tiles(
      B, LB, W, k, k - nt + 1, p.wide ? kmer_window::kTileBasesU64 : kmer_window::kTileBasesU32,
      p.wide ? 8 : 4, true, true);
  p.smem = kmer_window::smem_bytes(p.g);
  if (p.smem > 48 * 1024) p.err = (int)cudaErrorInvalidValue;
  return p;
}

template <typename Table>
auto acc_kernel(const AccPlan& p) {
  return p.wide ? (p.streamed ? chd_probe_acc_kernel<uint64_t, Table, true>
                              : chd_probe_acc_kernel<uint64_t, Table, false>)
                : (p.streamed ? chd_probe_acc_kernel<uint32_t, Table, true>
                              : chd_probe_acc_kernel<uint32_t, Table, false>);
}

// codes: int32 [B, LB/16] and ambig: int32 [B, LB/32] words of
// encode_unit_packed (LB a multiple of 32); lengths: int32 [B]; disp, rows:
// the chunk's CHD planes; acc: int32 [B, W], W <= LB - k + 1, updated in
// place; a lane is probed iff it is in its read, free of ambiguous bases,
// still 0 in acc and its minimizer bin (nt-mers, 1 <= nt <= k <= 31) lies in
// [bin_lo, bin_hi).
// the out-of-core pass over one chunk table (`width` as acc_plan's)
template <typename Table>
int probe_acc(const void* codes, const void* ambig, const void* lengths, const Table& tab,
              void* acc, int B, int LB, int W, int k, int nt, unsigned long long bin_lo,
              unsigned long long bin_hi, int width, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  const AccPlan p = acc_plan(B, LB, W, k, nt, width);
  if (p.err != 0) return p.err;
  acc_kernel<Table>(p)<<<(unsigned)p.g.grid, kThreads, p.smem, (cudaStream_t)stream>>>(
      (const uint32_t*)codes, (const uint32_t*)ambig, (const int*)lengths, tab, (uint32_t*)acc, B, k,
      nt, bin_lo, bin_hi, p.g);
  return (int)cudaGetLastError();
}

// whether the raw pass's blocks fill the card at most once
int one_wave(const AccPlan& p, bool* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, acc_kernel<RawAccTable>(p), kThreads, p.smem);
  *out = p.g.grid <= (long long)sms * per_sm;
  return (int)err;
}

// the raw probe of n queries over a table type's rounds
template <typename Table>
int rows_probe(const Table& tab, const void* hashes, const void* valid, void* out, long long n,
               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (tab.lb < 4 || tab.lb > 30) return (int)cudaErrorInvalidValue;
  bool streamed = false;
  const int err = stream_rows(tab.lb, &streamed);
  if (err != 0) return err;
  const long long grid = ((n + Table::kQ - 1) / Table::kQ + kThreads - 1) / kThreads;
  const auto kernel = streamed ? rows_probe_kernel<Table, true> : rows_probe_kernel<Table, false>;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(tab, (const uint64_t*)hashes,
                                                               (const uint8_t*)valid, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kuniq_chd_probe_acc(const void* codes, const void* ambig, const void* lengths,
                                   const void* disp, const void* rows, void* acc, int B, int LB,
                                   int W, int k, int nt, unsigned long long bin_lo,
                                   unsigned long long bin_hi, int lr, int lg, void* stream) {
  const ChdTable tab{(const uint32_t*)disp, (const uint4*)rows, lr, lg};
  return probe_acc(codes, ambig, lengths, tab, acc, B, LB, W, k, nt, bin_lo, bin_hi, lr, stream);
}

// ptags: u32 [2^lb][2], confirm: u32 [2^(lb+1)][2] (a raw chunk table);
// the rest as kuniq_chd_probe_acc's
extern "C" int kuniq_rows_probe_acc(const void* codes, const void* ambig, const void* lengths,
                                    const void* ptags, const void* confirm, void* acc, int B, int LB,
                                    int W, int k, int nt, unsigned long long bin_lo,
                                    unsigned long long bin_hi, int lb, void* stream) {
  if (lb < 4 || lb > 30) return (int)cudaErrorInvalidValue;
  const uint2 *pt = (const uint2*)ptags, *cf = (const uint2*)confirm;
  if (B > 0 && W > 0) {
    const AccPlan p = acc_plan(B, LB, W, k, nt, lb);
    bool wave = false;
    const int err = p.err != 0 ? p.err : one_wave(p, &wave);
    if (err != 0) return err;
    if (wave)
      return probe_acc(codes, ambig, lengths, RawAccWaveTable{pt, cf, lb}, acc, B, LB, W, k, nt, bin_lo,
                       bin_hi, lb, stream);
  }
  return probe_acc(codes, ambig, lengths, RawAccTable{pt, cf, lb}, acc, B, LB, W, k, nt, bin_lo, bin_hi, lb,
                   stream);
}

// ptags, confirm as kuniq_rows_probe_acc's; hashes, valid, out as
// kuniq_chd_probe's
extern "C" int kuniq_rows_probe(const void* ptags, const void* confirm, const void* hashes,
                                const void* valid, void* out, long long n, int lb, void* stream) {
  return rows_probe(RawProbeTable{(const uint2*)ptags, (const uint2*)confirm, lb}, hashes, valid, out, n,
                    stream);
}

extern "C" int kuniq_chd_probe(const void* disp, const void* rows, const void* hashes,
                               const void* valid, void* out, long long n, int lr, int lg,
                               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  bool streamed = false;
  const int err = stream_rows(lr, &streamed);
  if (err != 0) return err;
  const long long grid = ((n + kQ - 1) / kQ + kThreads - 1) / kThreads;
  const auto kernel = streamed ? chd_probe_kernel<true> : chd_probe_kernel<false>;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)disp, (const uint4*)rows, (const uint64_t*)hashes,
      (const uint8_t*)valid, (uint32_t*)out, n, lr, lg);
  return (int)cudaGetLastError();
}

// fused: u32 [2^lb][4] rows; hashes, valid, out as kuniq_chd_probe's.
extern "C" int kuniq_fused_probe(const void* fused, const void* hashes, const void* valid,
                                 void* out, long long n, int lb, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (lb < 4 || lb > 30) return (int)cudaErrorInvalidValue;
  bool streamed = false;
  const int err = stream_rows(lb, &streamed);
  if (err != 0) return err;
  const long long grid = ((n + kQF - 1) / kQF + kThreads - 1) / kThreads;
  const auto kernel = streamed ? fused_probe_kernel<true> : fused_probe_kernel<false>;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)fused, (const uint64_t*)hashes, (const uint8_t*)valid, (uint32_t*)out, n, lb);
  return (int)cudaGetLastError();
}
