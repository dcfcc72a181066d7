// The k-mer front of the classify step, fused into one pass.
//
// Replaces: the XLA ops of krakenuniq_tpu/kmer/ops.py (pack_windows,
// reverse_complement, canonical_representation, window_any) and
// krakenuniq_tpu/classify/device_step.py (murmur3_finalizer_device,
// encode_hash_device), which the JAX package left to XLA as ~31 shift/or
// passes over [B, W] uint64 planes plus the mixer and encoder passes.
// One thread per k-mer lane:
//   fwd   = the k 2-bit codes of the window, first base in the high bits
//   canon = min(fwd, reverse complement)           (k <= 31: below 2^62)
//   amb   = OR of the window's ambiguity flags
//   hash  = murmur3 finalizer of canon             (hyperloglogplus.cpp:830-838)
//   enc   = the 32-bit sparse HLL encoding of hash (hyperloglogplus.cpp:181-204)
// and, when the caller passes a canon plane (--exact, the long-read step),
// canon itself; a null canon_out writes nothing more (the template's
// kCanon = false form, the span route's default launch).
//
// Bound on the H100: bytes (2 B per base in, 13 B per lane out, 21 with the
// canon plane) and the per-lane integer work (window, reversal, murmur's
// two 64-bit multiplies, the encoder) are of one size; see
// chip_smoke.front_bound.
//
// Design: a block owns R whole rows (about 4,096 bases; a longer row, such
// as a long read's 32,768-base chunk, is one block, with 12.3 KB of shared
// memory at that length on either feed). Stage: it reads their codes and
// flags with aligned 16-byte loads and packs each 16 bases
// in registers (two multiplies per 4 bytes) into shared memory, as one bit
// string per plane: base f at bits 2f of the code words and bit f of the
// flag words, the layout of kuniq_native.encode_unit_packed (base j in bits
// 2(j % 16) of u32 word j / 16, its flag in bit j % 32 of word j / 32).
// Compute: a lane takes its 2k code bits and k flag bits with one funnel
// shift of two adjacent u64 words. Low-first packing gives r = sum c_t <<
// 2t, so the reverse complement is (~r) & (2^2k - 1) and the forward k-mer
// is the 2-bit reversal of r (a bit reversal and an adjacent-bit swap). A
// row's bit string starts anywhere in a word, so any LB and any byte
// alignment of the inputs work; consecutive threads write consecutive
// lanes, so the int64/int32/uint8 stores are coalesced. No intermediate
// plane touches device memory, and no thread loads a base from device
// memory more than once.
//
// Packed input (kuniq_kmer_front_packed, the span route's feed): the rows
// arrive as encode_unit_packed's int32 words ([B, LB/16] codes, [B, LB/32]
// flags, LB a multiple of 32), which is the staged layout already, with
// each row on a word boundary. So the stage is a copy of the block's words
// (3 bits per base read instead of 16) and the compute loop is the same.
// It replaces the JAX package's unpack_input (device_step.py:54-70), whose
// unpacked [B, LB] planes never exist here.
//
// Minimizer bins (kuniq_kmer_bins, kuniq_kmer_bins_packed: the binary-search
// lookup's front, lookup_mode "bsearch"). Replaces: the XLA ops of
// krakenuniq_tpu/kmer/ops.py's minimizers (pack_windows over nt, the
// canonical nt-mers, window_min) and the canonical k-mer plane of
// classify_step_core. Per lane it writes the canonical k-mer (int64) and
//   bin = min over m in [0, k - nt] of  xm ^ canonical(nt-mer at lane + m),
// xm = INDEX2_XOR_MASK & (4^nt - 1) (krakendb.cpp:200-215). Bound on the
// H100: bytes (2 bits or a byte a base in, 16 B a lane out; the function's
// own work, one nt-mer a base position and a sliding minimum, is a third of
// the time the bytes take; chip_smoke.bins_bound). Design: the same staging
// as kmer_front (codes only: the flags play no part), then kmer_window.cuh's
// window_mins: one nt-mer value per staged base position and a van
// Herk/Gil-Werman sliding minimum in shared memory, so a lane's bin is the
// minimum of two shared words; the canonical k-mer is the lane's funnel-shift
// window, as in front_lanes. A block stages 4,096 bases (2,048 for nt > 16,
// whose values take 8 B; fewer where the blocks' padding would pass 48 KB);
// a longer row is cut into tiles of lanes.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_window.cuh"

namespace {

using kmer_window::canonical;
using kmer_window::murmur3_finalizer;
using kmer_window::window64;

constexpr int kThreads = 256;
constexpr int kBlockBases = 4096;  // bases staged per block (whole rows, at least one)
constexpr int kPPrime = 25;        // sparse precision, hyperloglogplus.hpp:76

__device__ __forceinline__ uint32_t encode_hash(uint64_t h, int p) {
  const uint32_t idx = (uint32_t)((h >> (64 - kPPrime)) << (32 - kPPrime));
  if ((uint32_t)(idx << p) != 0) return idx;
  const uint64_t shifted = h << kPPrime;
  int clz = shifted == 0 ? 64 : __clzll((long long)shifted);
  clz = min(clz, 64 - kPPrime);
  return idx | ((uint32_t)(clz + 1) << 1) | 1u;
}

// 4 code bytes (0..3) -> 8 bits, byte t at bits 2t: the masked product puts
// byte t's two bits at 24 + 2t, with every other partial product below bit
// 24 in its own field or above bit 31.
__device__ __forceinline__ uint32_t pack4_codes(uint32_t x) {
  return ((x & 0x03030303u) * 0x01041040u) >> 24;
}

// 4 flag bytes (0/1) -> 4 bits, byte t at bit t (partial products at 24 + t).
__device__ __forceinline__ uint32_t pack4_flags(uint32_t x) {
  return (((x & 0x01010101u) * 0x01020408u) >> 24) & 0xFu;
}

// The per-lane work on a block's staged bit strings (code bit 2f and flag
// bit f hold the block's base f - off): lanes idx of the block's rows.
// kCanon: also store each lane's canonical k-mer in canon_out.
template <bool kCanon>
__device__ __forceinline__ void front_lanes(const uint64_t* c64, const uint64_t* a64, int offc,
                                            int offa, long long o0, int rows, int LB, int W,
                                            int k, int p, uint64_t* __restrict__ hash_out,
                                            uint32_t* __restrict__ enc_out,
                                            uint8_t* __restrict__ amb_out,
                                            uint64_t* __restrict__ canon_out) {
  const uint64_t maskk = (1ull << k) - 1;
  for (int idx = threadIdx.x; idx < rows * W; idx += kThreads) {
    const int rr = (int)((unsigned)idx / (unsigned)W);
    const int f = rr * LB + (idx - rr * W);  // the window's first base in the block
    const bool amb = (window64(a64, f + offa) & maskk) != 0;
    const uint64_t canon = canonical(window64(c64, 2 * (f + offc)), k);
    const uint64_t h = murmur3_finalizer(canon);
    hash_out[o0 + idx] = h;
    enc_out[o0 + idx] = encode_hash(h, p);
    amb_out[o0 + idx] = amb;
    if (kCanon) canon_out[o0 + idx] = canon;
  }
}

template <bool kCanon>
__global__ void __launch_bounds__(kThreads)
kmer_front_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ ambig,
                  uint64_t* __restrict__ hash_out, uint32_t* __restrict__ enc_out,
                  uint8_t* __restrict__ amb_out, uint64_t* __restrict__ canon_out, int B, int LB,
                  int k, int p, int R) {
  extern __shared__ uint64_t smem[];
  const long long r0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, (long long)B - r0);
  const int n = rows * LB;
  const int W = LB - k + 1;
  const uint8_t* cp = codes + r0 * LB;
  const uint8_t* ap = ambig + r0 * LB;
  // the 16-byte chunks that hold the block's bases (the first may start
  // before them; bytes outside the block's rows are staged but never read)
  const int offc = (int)((uintptr_t)cp & 15), offa = (int)((uintptr_t)ap & 15);
  const uint4* cv = reinterpret_cast<const uint4*>(cp - offc);
  const uint4* av = reinterpret_cast<const uint4*>(ap - offa);
  const int ncc = (n + offc + 15) / 16, nca = (n + offa + 15) / 16;
  const int nc64 = (ncc + 1) / 2 + 1, na64 = (nca + 3) / 4 + 1;  // + one zero word
  uint32_t* s_code = reinterpret_cast<uint32_t*>(smem);        // one word per chunk
  uint16_t* s_flag = reinterpret_cast<uint16_t*>(smem + nc64);  // one half per chunk

  for (int c = threadIdx.x; c < 2 * nc64; c += kThreads) {
    uint32_t v = 0;
    if (c < ncc) {
      const uint4 x = cv[c];
      v = pack4_codes(x.x) | pack4_codes(x.y) << 8 | pack4_codes(x.z) << 16 |
          pack4_codes(x.w) << 24;
    }
    s_code[c] = v;
  }
  for (int c = threadIdx.x; c < 4 * na64; c += kThreads) {
    uint32_t v = 0;
    if (c < nca) {
      const uint4 x = av[c];
      v = pack4_flags(x.x) | pack4_flags(x.y) << 4 | pack4_flags(x.z) << 8 |
          pack4_flags(x.w) << 12;
    }
    s_flag[c] = (uint16_t)v;
  }
  __syncthreads();

  front_lanes<kCanon>(smem, smem + nc64, offc, offa, r0 * W, rows, LB, W, k, p, hash_out,
                      enc_out, amb_out, canon_out);
}

// The packed feed: row b's codes are words [b * LB/16, (b + 1) * LB/16) of
// `codes` and its flags words [b * LB/32, (b + 1) * LB/32) of `ambig`, so a
// block's rows are one contiguous run of words in each plane.
template <bool kCanon>
__global__ void __launch_bounds__(kThreads)
kmer_front_packed_kernel(const uint32_t* __restrict__ codes, const uint32_t* __restrict__ ambig,
                         uint64_t* __restrict__ hash_out, uint32_t* __restrict__ enc_out,
                         uint8_t* __restrict__ amb_out, uint64_t* __restrict__ canon_out, int B,
                         int LB, int k, int p, int R) {
  extern __shared__ uint64_t smem[];
  const long long r0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, (long long)B - r0);
  const int W = LB - k + 1;
  const int ncw = rows * (LB / 16), naw = rows * (LB / 32);
  const int nc64 = (ncw + 1) / 2 + 1, na64 = (naw + 1) / 2 + 1;  // + one zero word
  uint32_t* s_code = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_flag = reinterpret_cast<uint32_t*>(smem + nc64);
  const uint32_t* cw = codes + r0 * (LB / 16);
  const uint32_t* aw = ambig + r0 * (LB / 32);
  for (int c = threadIdx.x; c < 2 * nc64; c += kThreads) s_code[c] = c < ncw ? cw[c] : 0u;
  for (int c = threadIdx.x; c < 2 * na64; c += kThreads) s_flag[c] = c < naw ? aw[c] : 0u;
  __syncthreads();
  front_lanes<kCanon>(smem, smem + nc64, 0, 0, r0 * W, rows, LB, W, k, p, hash_out, enc_out,
                      amb_out, canon_out);
}

// The minimizer-bin pass of a block's tile: canonical k-mer and bin of every
// lane. kPacked: `codes` are the packed feed's int32 words (LB/16 a row);
// else uint8 codes [B, LB], packed into the staged string as they are read.
template <typename V, bool kPacked>
__global__ void __launch_bounds__(kThreads)
kmer_bins_kernel(const void* __restrict__ codes, uint64_t* __restrict__ canon_out,
                 uint64_t* __restrict__ bin_out, int B, int k, int nt, kmer_window::Tiles g) {
  extern __shared__ uint64_t smem[];
  const kmer_window::Tile t = kmer_window::tile_of(g, B);
  const int n = kmer_window::tile_span(t, g.LB, k);
  const long long first = t.r0 * g.LB + t.lane0;
  uint32_t* s_code = reinterpret_cast<uint32_t*>(smem);
  int off;
  if (kPacked) {
    off = kmer_window::stage_words(static_cast<const uint32_t*>(codes), first, n, 16, s_code,
                                   g.nc64);
  } else {
    // the 16-byte chunks that hold the tile's bases (the first may start
    // before them; bytes outside the tile are staged but never read)
    const uint8_t* cp = static_cast<const uint8_t*>(codes) + first;
    off = (int)((uintptr_t)cp & 15);
    const uint4* cv = reinterpret_cast<const uint4*>(cp - off);
    const int ncc = (n + off + 15) / 16;
    for (int c = threadIdx.x; c < 2 * g.nc64; c += kThreads) {
      uint32_t v = 0;
      if (c < ncc) {
        const uint4 x = cv[c];
        v = pack4_codes(x.x) | pack4_codes(x.y) << 8 | pack4_codes(x.z) << 16 |
            pack4_codes(x.w) << 24;
      }
      s_code[c] = v;
    }
  }
  __syncthreads();
  V* S = reinterpret_cast<V*>(smem + g.nc64);
  V* P = reinterpret_cast<V*>(smem + g.nc64 + g.nv64);
  const kmer_window::Win v = kmer_window::win_of(t, k, nt);
  kmer_window::window_mins<V>(smem, off, t, g.LB, nt, v, nullptr, S, P);
  const unsigned m_nl = kmer_window::magic(t.nl);
  for (int idx = threadIdx.x; idx < t.rows * t.nl; idx += kThreads) {
    const int rr = kmer_window::fdiv(idx, t.nl, m_nl);
    const int l = idx - rr * t.nl;
    const long long o = (t.r0 + rr) * g.W + t.lane0 + l;
    canon_out[o] = canonical(window64(smem, 2 * (rr * g.LB + l + off)), k);
    bin_out[o] = kmer_window::window_bin(S, P, v, rr, l);
  }
}

template <bool kPacked>
int launch_bins(const void* codes, void* canon_out, void* bin_out, int B, int LB, int k, int nt,
                void* stream) {
  const bool wide = nt > 16;
  const kmer_window::Tiles g = kmer_window::plan_tiles(
      B, LB, LB - k + 1, k, k - nt + 1, wide ? kmer_window::kTileBasesU64 : kmer_window::kTileBasesU32,
      wide ? 8 : 4, false, false);
  const size_t smem = kmer_window::smem_bytes(g);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const auto kernel = wide ? kmer_bins_kernel<uint64_t, kPacked> : kmer_bins_kernel<uint32_t, kPacked>;
  kernel<<<(unsigned)g.grid, kThreads, smem, (cudaStream_t)stream>>>(
      codes, (uint64_t*)canon_out, (uint64_t*)bin_out, B, k, nt, g);
  return (int)cudaGetLastError();
}

}  // namespace

// codes: uint8 [B, LB] (0..3), ambig: uint8 [B, LB] (0/1); hash int64, enc
// int32, amb uint8 and canon (null: not written) int64, each [B, LB - k + 1].
extern "C" int kuniq_kmer_front(const void* codes, const void* ambig, void* hash_out,
                                void* enc_out, void* amb_out, void* canon_out, int B, int LB,
                                int k, int p, void* stream) {
  if (B <= 0 || LB - k + 1 <= 0) return (int)cudaGetLastError();
  const int R = LB >= kBlockBases ? 1 : kBlockBases / LB;
  // shared words for the largest block, at the worst 15-byte misalignment
  const int ncc = (R * LB + 30) / 16;
  const size_t smem = sizeof(uint64_t) * (size_t)((ncc + 1) / 2 + 1 + (ncc + 3) / 4 + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + R - 1) / R;
  const auto kernel = canon_out ? kmer_front_kernel<true> : kmer_front_kernel<false>;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)ambig, (uint64_t*)hash_out, (uint32_t*)enc_out,
      (uint8_t*)amb_out, (uint64_t*)canon_out, B, LB, k, p, R);
  return (int)cudaGetLastError();
}

// codes: int32 [B, LB/16] and ambig: int32 [B, LB/32] words of
// encode_unit_packed (LB a multiple of 32); the outputs as above.
extern "C" int kuniq_kmer_front_packed(const void* codes, const void* ambig, void* hash_out,
                                       void* enc_out, void* amb_out, void* canon_out, int B,
                                       int LB, int k, int p, void* stream) {
  if (B <= 0 || LB - k + 1 <= 0) return (int)cudaGetLastError();
  if (LB % 32 != 0) return (int)cudaErrorInvalidValue;
  const int R = LB >= kBlockBases ? 1 : kBlockBases / LB;
  const size_t smem = sizeof(uint64_t) * (size_t)((R * (LB / 16) + 1) / 2 + 1 +
                                                  (R * (LB / 32) + 1) / 2 + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + R - 1) / R;
  const auto kernel = canon_out ? kmer_front_packed_kernel<true> : kmer_front_packed_kernel<false>;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)codes, (const uint32_t*)ambig, (uint64_t*)hash_out, (uint32_t*)enc_out,
      (uint8_t*)amb_out, (uint64_t*)canon_out, B, LB, k, p, R);
  return (int)cudaGetLastError();
}

// codes: uint8 [B, LB]; canon and bin: int64 [B, LB - k + 1]; 1 <= nt <= k.
extern "C" int kuniq_kmer_bins(const void* codes, void* canon_out, void* bin_out, int B, int LB,
                               int k, int nt, void* stream) {
  if (B <= 0 || LB - k + 1 <= 0) return (int)cudaGetLastError();
  if (nt < 1 || nt > k || k > 31) return (int)cudaErrorInvalidValue;
  return launch_bins<false>(codes, canon_out, bin_out, B, LB, k, nt, stream);
}

// codes: int32 [B, LB/16] words of encode_unit_packed (LB a multiple of 32).
extern "C" int kuniq_kmer_bins_packed(const void* codes, void* canon_out, void* bin_out, int B,
                                      int LB, int k, int nt, void* stream) {
  if (B <= 0 || LB - k + 1 <= 0) return (int)cudaGetLastError();
  if (nt < 1 || nt > k || k > 31 || LB % 32 != 0) return (int)cudaErrorInvalidValue;
  return launch_bins<true>(codes, canon_out, bin_out, B, LB, k, nt, stream);
}
