// Device code shared by csrc/kmer_front.cu, csrc/chd_probe.cu and
// csrc/bsearch_lookup.cu: a block's staged bit string of bases, the
// canonical k-mer of a lane, murmur's finalizer, and the minimizer bins of a
// block's lanes.
//
// Staging. A block owns a tile of lanes: R whole rows (rows of at most a
// tile's bases), or, for a longer row, tl consecutive lanes of one row. It
// stages the bases its lanes read into shared memory as one bit string per
// plane, low bits first (base f at bits 2f of the code words, bit f of the
// flag words: the layout of kuniq_native.encode_unit_packed), starting `off`
// bases into the first word. Row rr of the tile starts at staged base
// rr * LB + off, LB the feed's row stride in bases. A lane's 2k code bits (or
// k flag bits) are then one funnel shift of two adjacent u64 words.
//
// Minimizer bins (krakendb.cpp:200-215): the bin of a k-mer is
//   min over its k - nt + 1 nt-mers of  xm ^ canonical(nt-mer),
// xm = INDEX2_XOR_MASK & (4^nt - 1). window_mins computes it in two phases:
//   A. one value per staged base position whose nt-mer lies in its row: the
//      nt-mer by one funnel shift (u32 words and __funnelshift_r for nt <= 16,
//      u64 words beyond), its reverse complement (~r) and forward form (the
//      2-bit reversal of r), the xor of the smaller; ~10 operations a base;
//   B. the sliding minimum over w = k - nt + 1 consecutive values (van Herk /
//      Gil-Werman): within blocks of w values aligned to each row's start,
//      a prefix minimum P and a suffix minimum S (one thread walks a block
//      forward, then back), so that a lane's window [i, i + w - 1] is
//      min(S[i], P[i + w - 1]): 3 operations a value whatever w is. A window
//      never crosses a row: values are indexed by row. The blocks lie at an
//      odd stride (w | 1), so the threads of a warp, one a block, read and
//      write distinct banks.
// The values live in shared memory (S in place of the values, P beside it),
// 4 B each for nt <= 16 and 8 B beyond, so a block stages 4,096 bases
// (kTileBasesU32) or 2,048 (kTileBasesU64): about 36 KB either way. A
// kernel that needs the bins of some lanes only (the out-of-core probe, the
// binary search's words entry) marks the blocks of values those lanes read
// (segment_needs), and phases A and B skip the others.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmer_window {

constexpr uint64_t kIndex2XorMask = 0xE37E28C4271B5A2Dull;  // krakendb.cpp:45
constexpr int kTileBasesU32 = 4096;  // bases a block stages, nt <= 16
constexpr int kTileBasesU64 = 2048;  // the same, nt > 16

__device__ __forceinline__ uint64_t murmur3_finalizer(uint64_t key) {
  key += 1;
  key ^= key >> 33;
  key *= 0xFF51AFD7ED558CCDull;
  key ^= key >> 33;
  key *= 0xC4CEB9FE1A85EC53ull;
  key ^= key >> 33;
  return key;
}

// Bits [bit, bit + 64) of the bit string held in s (low bits first).
__device__ __forceinline__ uint64_t window64(const uint64_t* s, int bit) {
  const int w = bit >> 6, sh = bit & 63;
  return (s[w] >> sh) | ((s[w + 1] << 1) << (63 - sh));
}

// The 2-bit reversal: base t's code (bits 2t, 2t + 1) goes to the top end.
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// The canonical k-mer (k <= 31) of the code window r (base t at bits 2t):
// the smaller of the forward k-mer (first base in the high bits) and the
// reverse complement.
__device__ __forceinline__ uint64_t canonical(uint64_t r, int k) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  r &= mask;
  const uint64_t fwd = rev2(r) >> (64 - 2 * k);
  const uint64_t rc = ~r & mask;
  return fwd < rc ? fwd : rc;
}

// xm ^ canonical nt-mer starting at staged base p.
template <typename V>
__device__ __forceinline__ V ntmer_value(const uint64_t* c64, int p, int nt, V xm);

template <>
__device__ __forceinline__ uint32_t ntmer_value<uint32_t>(const uint64_t* c64, int p, int nt,
                                                          uint32_t xm) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(c64);
  const uint32_t mask = 0xFFFFFFFFu >> (32 - 2 * nt);
  const uint32_t r = __funnelshift_r(s[p >> 4], s[(p >> 4) + 1], 2 * (p & 15)) & mask;
  const uint32_t fwd = rev2(r) >> (32 - 2 * nt);
  const uint32_t rc = ~r & mask;
  return xm ^ (fwd < rc ? fwd : rc);
}

template <>
__device__ __forceinline__ uint64_t ntmer_value<uint64_t>(const uint64_t* c64, int p, int nt,
                                                          uint64_t xm) {
  const uint64_t mask = (1ull << (2 * nt)) - 1;
  const uint64_t r = window64(c64, 2 * p) & mask;
  const uint64_t fwd = rev2(r) >> (64 - 2 * nt);
  const uint64_t rc = ~r & mask;
  return xm ^ (fwd < rc ? fwd : rc);
}

// A launch's cut of its [B, W] lanes into blocks, and a block's shared
// memory (in u64 words): staged codes, staged flags (0 words when the kernel
// reads none), the S and P values, a bit a lane and a byte a segment of
// values (0 words when the kernel keeps none).
struct Tiles {
  int R;     // whole rows a block; 1 when rows are cut into tiles
  int tpr;   // tiles a row (1: whole rows)
  int tl;    // lanes a tile when tpr > 1
  int W;     // lanes a row
  int LB;    // the feed's row stride in bases
  int nc64, na64, nv64, nm64, ng64;
  long long grid;
};

struct Tile {
  long long r0;  // first row
  int rows;      // rows of the tile
  int lane0;     // first lane in its row (0 for whole rows)
  int nl;        // lanes a row of the tile
};

// floor(n / d) by a multiply: m = magic(d), exact while n * d < 2^32
__host__ __device__ __forceinline__ unsigned magic(unsigned d) { return 0xFFFFFFFFu / d + 1u; }
__device__ __forceinline__ int fdiv(int n, int d, unsigned m) {
  return d == 1 ? n : (int)__umulhi((unsigned)n, m);
}

// The values of a tile row: nv = nl + w - 1 (one a base position whose
// nt-mer lies in the row, w = k - nt + 1), in nseg blocks of w laid out at
// the odd stride sw = w | 1, so that phase B's threads, one a block of w,
// fall on distinct shared-memory banks; row rr's values start at rr * rs.
struct Win {
  int w, sw, nv, nseg, rs;
  unsigned mw, mnv, mseg;
};

__host__ __device__ __forceinline__ int win_values(int nl, int w, int* nseg) {
  *nseg = (nl + w - 1 + w - 1) / w;
  return *nseg * (w | 1);
}

__device__ __forceinline__ Win win_of(const Tile& t, int k, int nt) {
  Win v;
  v.w = k - nt + 1;
  v.sw = v.w | 1;
  v.nv = t.nl + v.w - 1;
  v.rs = win_values(t.nl, v.w, &v.nseg);
  v.mw = magic(v.w);
  v.mnv = magic(v.nv);
  v.mseg = magic(v.nseg);
  return v;
}

// Where value j of row rr lives.
__device__ __forceinline__ int win_at(const Win& v, int rr, int j) {
  return rr * v.rs + j + fdiv(j, v.w, v.mw) * (v.sw - v.w);
}

// The plan for rows of LB bases (the staged stride), W <= LB - k + 1 lanes
// a row, windows of w nt-mers of vbytes-byte values (vbytes 0: no bins),
// flags and the lane bits and segment bytes when asked. A block stages up to
// tile_bases bases, fewer when its shared memory would pass the 48 KB of a
// launch without an opt-in; a row longer than that is cut into tiles of
// tile_bases - (k - 1) lanes.
inline Tiles plan_tiles(int B, int LB, int W, int k, int w, int tile_bases, int vbytes, bool flags,
                        bool lane_bits) {
  for (;; tile_bases /= 2) {
    Tiles g{};
    g.W = W;
    g.LB = LB;
    int n_max, lanes_max, rows;
    if (LB <= tile_bases) {
      g.R = tile_bases / LB;
      g.tpr = 1;
      g.tl = W;
      g.grid = (B + g.R - 1) / g.R;
      n_max = g.R * LB;
      lanes_max = g.R * W;
      rows = g.R;
    } else {
      g.R = 1;
      g.tl = tile_bases - (k - 1);
      g.tpr = (W + g.tl - 1) / g.tl;
      g.grid = (long long)B * g.tpr;
      n_max = g.tl + k - 1;
      lanes_max = g.tl;
      rows = 1;
    }
    int nseg = 0;
    const int values = vbytes ? rows * win_values(lanes_max / rows, w, &nseg) : 0;
    // the data words at the worst start within a word, and a zero word past them
    g.nc64 = ((15 + n_max + 15) / 16 + 1) / 2 + 1;
    g.na64 = flags ? ((31 + n_max + 31) / 32 + 1) / 2 + 1 : 0;
    g.nv64 = (vbytes * values + 7) / 8;  // each of S and P
    g.nm64 = lane_bits ? (lanes_max + 63) / 64 : 0;
    g.ng64 = lane_bits ? (rows * nseg + 7) / 8 : 0;
    if (sizeof(uint64_t) * (size_t)(g.nc64 + g.na64 + 2 * g.nv64 + g.nm64 + g.ng64) <= 48 * 1024 ||
        tile_bases <= 2 * k)
      return g;
  }
}

inline size_t smem_bytes(const Tiles& g) {
  return sizeof(uint64_t) * (size_t)(g.nc64 + g.na64 + 2 * g.nv64 + g.nm64 + g.ng64);
}

__device__ __forceinline__ Tile tile_of(const Tiles& g, int B) {
  Tile t;
  if (g.tpr == 1) {
    t.r0 = (long long)blockIdx.x * g.R;
    t.rows = (int)min((long long)g.R, (long long)B - t.r0);
    t.lane0 = 0;
    t.nl = g.W;
  } else {
    t.r0 = blockIdx.x / g.tpr;
    t.rows = 1;
    t.lane0 = (int)(blockIdx.x % g.tpr) * g.tl;
    t.nl = min(g.tl, g.W - t.lane0);
  }
  return t;
}

// The bases the tile's lanes read, from the feed's base r0 * LB + lane0.
__device__ __forceinline__ int tile_span(const Tile& t, int LB, int k) {
  return (t.rows - 1) * LB + t.nl + k - 1;
}

// Stage the words that hold bases [first, first + n) of a packed plane
// (per_word bases a word) into s, zero up to n64 u64 words; returns the
// offset of base `first` in the staged string. No __syncthreads.
__device__ __forceinline__ int stage_words(const uint32_t* __restrict__ words, long long first,
                                           int n, int per_word, uint32_t* s, int n64) {
  const long long w0 = first / per_word;
  const int off = (int)(first - w0 * per_word);
  const int nw = (off + n + per_word - 1) / per_word;
  for (int c = threadIdx.x; c < 2 * n64; c += blockDim.x) s[c] = c < nw ? words[w0 + c] : 0u;
  return off;
}

// seg[g] = whether a lane marked in `need` (a bit a lane, lane l of row rr
// at bit rr * nl + l) reads block g of values: lane l reads the blocks of
// its values l (S) and l + w - 1 (P), so block s of a row serves the lanes
// [s * w - w + 1, s * w + w - 1]. No __syncthreads.
__device__ __forceinline__ void segment_needs(const uint32_t* need, const Tile& t, const Win& v,
                                              uint8_t* seg) {
  for (int g = threadIdx.x; g < t.rows * v.nseg; g += blockDim.x) {
    const int rr = fdiv(g, v.nseg, v.mseg);
    const int s = g - rr * v.nseg;
    const int lo = max(0, s * v.w - v.w + 1), hi = min(t.nl - 1, s * v.w + v.w - 1);
    bool any = false;
    if (lo <= hi) {
      const int a = rr * t.nl + lo, b = rr * t.nl + hi;
      for (int wd = a >> 5; wd <= b >> 5; ++wd) {
        uint32_t m = need[wd];
        if (wd == a >> 5) m &= ~0u << (a & 31);
        if (wd == b >> 5) m &= ~0u >> (31 - (b & 31));
        any |= m != 0u;
      }
    }
    seg[g] = any;
  }
}

// Phases A and B on the staged code string c64 (row rr of the tile at
// staged base rr * LB + off): S and P of every value of the tile's rows at
// win_at(v, rr, j), or with `seg` only of the blocks it marks (w = 1: the
// values alone, S). Lane l of row rr then has the bin window_bin(S, P, v,
// rr, l). Ends with __syncthreads.
template <typename V>
__device__ __forceinline__ void window_mins(const uint64_t* c64, int off, const Tile& t, int LB,
                                            int nt, const Win& v, const uint8_t* seg, V* S, V* P) {
  const V xm = (V)(kIndex2XorMask & ((1ull << (2 * nt)) - 1));
  for (int i = threadIdx.x; i < t.rows * v.nv; i += blockDim.x) {
    const int rr = fdiv(i, v.nv, v.mnv);
    const int j = i - rr * v.nv;
    const int q = fdiv(j, v.w, v.mw);
    if (seg != nullptr && !seg[rr * v.nseg + q]) continue;
    S[rr * v.rs + j + q * (v.sw - v.w)] = ntmer_value<V>(c64, rr * LB + j + off, nt, xm);
  }
  __syncthreads();
  if (v.w == 1) return;  // a window of one value: S is the bin (window_bin)
  for (int g = threadIdx.x; g < t.rows * v.nseg; g += blockDim.x) {
    if (seg != nullptr && !seg[g]) continue;
    const int rr = fdiv(g, v.nseg, v.mseg);
    const int s = g - rr * v.nseg;
    const int j0 = rr * v.rs + s * v.sw;
    const int j1 = j0 + min(v.w, v.nv - s * v.w);
    V m = ~(V)0;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const V x = S[j];
      m = x < m ? x : m;
      P[j] = m;
    }
    m = ~(V)0;
#pragma unroll 4
    for (int j = j1 - 1; j >= j0; --j) {
      const V x = S[j];
      m = x < m ? x : m;
      S[j] = m;
    }
  }
  __syncthreads();
}

template <typename V>
__device__ __forceinline__ uint64_t window_bin(const V* S, const V* P, const Win& v, int rr, int l) {
  const V a = S[win_at(v, rr, l)];
  if (v.w == 1) return a;
  const V b = P[win_at(v, rr, l + v.w - 1)];
  return a < b ? a : b;
}

}  // namespace kmer_window
