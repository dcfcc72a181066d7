// Candidate designs of the raw two-level probe round (csrc/chd_probe.cu,
// RawTable) that the kept one was chosen over, built beside it for
// tools/kernel_variants.py to time on the card, each through the same
// kernels as the kept round (rows_probe_kernel, and chd_probe_acc_kernel for
// the out-of-core pass), with its own kQ and minimum blocks an SM (the pass
// keeps __launch_bounds__(kThreads), so there only kQ varies):
//  * speculative confirm pair: round 1 loads each valid query's b1 tag row
//    and, beside it and not dependent on it, b1's two confirm rows (16
//    adjacent bytes at confirm[2*b1], one sector; the plane 16-byte
//    aligned), so a query screened at b1 is answered after one round; round
//    2 does the same for b2 on the queries no b1 slot screened (b2 != b1).
//    One dependent round less on a screened query, but a confirm pair read
//    beside every tag row, and 16-byte registers for it.
//  * both tag rows (csrc's RawTableBoth, the first design's round with its
//    slot in 32 bits): both buckets' tag rows of every valid query, then the confirm
//    row of the first screened slot. The out-of-core pass takes it where its
//    blocks fill the card at most once; these points take it everywhere.
//  * the kept round at other kQ and minimum blocks.
// form: 0 the kept round, 1 speculative confirm pair, 2 both tag rows; q: 4
// or 8; min_blocks: 1 (no budget), 4, 6 or 8. A point that is not built
// returns cudaErrorInvalidValue.

#include "chd_probe.cu"

namespace {

// A raw bucket's answer from its tag row `t` and confirm pair `c` (slot 0's
// row in x, y; slot 1's in z, w) for a query of tag p and low word lo: the
// first slot whose tag is p confirms, else 0; `screened`: whether one was
__device__ __forceinline__ uint32_t raw_bucket(uint2 t, uint4 c, uint32_t p, uint32_t lo, bool& screened) {
  screened = t.x == p || t.y == p;
  return t.x == p ? (c.x == lo ? c.y : 0u) : t.y == p ? (c.z == lo ? c.w : 0u) : 0u;
}

template <int Q, int MinBlocks>
struct RawTableSpec {
  static constexpr int kQ = Q;
  static constexpr int kMinBlocks = MinBlocks;
  const uint2* ptags;
  const uint4* confirm;  // a bucket's two confirm rows
  int lb;

  template <bool kStream>
  __device__ __forceinline__ void probe(const uint64_t (&h)[kQ], const bool (&v)[kQ],
                                        uint32_t (&word)[kQ]) const {
    uint2 t[kQ];
    uint4 c[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const uint32_t b1 = (uint32_t)(h[j] >> (64 - lb));
      t[j] = v[j] ? __ldg(ptags + b1) : make_uint2(0u, 0u);
      c[j] = !v[j] ? make_uint4(0u, 0u, 0u, 0u) : kStream ? __ldcs(confirm + b1) : __ldg(confirm + b1);
    }
    unsigned second = 0u;  // bit j: query j goes on to b2
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      bool screened;
      word[j] = raw_bucket(t[j], c[j], (uint32_t)((h[j] << lb) >> 32), (uint32_t)h[j], screened);
      const bool other = (uint32_t)(h[j] >> (64 - lb)) != (uint32_t)((h[j] * kGolden) >> (64 - lb));
      if (v[j] && !screened && other) second |= 1u << j;
    }
    if (second == 0u) return;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (!((second >> j) & 1u)) continue;
      const uint32_t b2 = (uint32_t)((h[j] * kGolden) >> (64 - lb));
      t[j] = __ldg(ptags + b2);
      c[j] = kStream ? __ldcs(confirm + b2) : __ldg(confirm + b2);
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (!((second >> j) & 1u)) continue;
      bool screened;
      word[j] = raw_bucket(t[j], c[j], (uint32_t)(((h[j] * kGolden) << lb) >> 32), (uint32_t)h[j], screened);
    }
  }
};

template <int Form, int Q, int MinBlocks>
struct RawForm;
template <int Q, int MinBlocks>
struct RawForm<0, Q, MinBlocks> {
  using type = RawTable<Q, MinBlocks>;
  using row = uint2;
};
template <int Q, int MinBlocks>
struct RawForm<1, Q, MinBlocks> {
  using type = RawTableSpec<Q, MinBlocks>;
  using row = uint4;
};
template <int Q, int MinBlocks>
struct RawForm<2, Q, MinBlocks> {
  using type = RawTableBoth<Q, MinBlocks>;
  using row = uint2;
};

template <int Form, int Q, int MinBlocks>
typename RawForm<Form, Q, MinBlocks>::type raw_table(const void* ptags, const void* confirm, int lb) {
  return {(const uint2*)ptags, (const typename RawForm<Form, Q, MinBlocks>::row*)confirm, lb};
}

}  // namespace

// the kept round's entry checks hold for every form; the speculative
// form's pair loads need a 16-byte aligned confirm plane
#define ROWS_POINT(F, Q, M)                                                                       \
  if (form == F && q == Q && min_blocks == M)                                                    \
    return rows_probe(raw_table<F, Q, M>(ptags, confirm, lb), hashes, valid, out, n, stream);

extern "C" int kuniq_rows_probe_variant(int form, int q, int min_blocks, const void* ptags, const void* confirm,
                                        const void* hashes, const void* valid, void* out, long long n, int lb,
                                        void* stream) {
  if (form == 1 && ((uintptr_t)confirm & 15)) return (int)cudaErrorInvalidValue;
  ROWS_POINT(0, 4, 1) ROWS_POINT(0, 4, 4) ROWS_POINT(0, 4, 6) ROWS_POINT(0, 4, 8)
  ROWS_POINT(0, 8, 1) ROWS_POINT(0, 8, 4) ROWS_POINT(0, 8, 6) ROWS_POINT(0, 8, 8)
  ROWS_POINT(1, 4, 1) ROWS_POINT(1, 4, 4) ROWS_POINT(1, 4, 6) ROWS_POINT(1, 4, 8)
  ROWS_POINT(1, 8, 1) ROWS_POINT(1, 8, 4) ROWS_POINT(1, 8, 6) ROWS_POINT(1, 8, 8)
  ROWS_POINT(2, 4, 1)
  return (int)cudaErrorInvalidValue;
}

#define ACC_POINT(F, Q, M)                                                                          \
  if (form == F && q == Q && min_blocks == M)                                                      \
    return probe_acc(codes, ambig, lengths, raw_table<F, Q, M>(ptags, confirm, lb), acc, B, LB, W, k, nt, \
                     bin_lo, bin_hi, lb, stream);

extern "C" int kuniq_rows_probe_acc_variant(int form, int q, int min_blocks, const void* codes,
                                            const void* ambig, const void* lengths, const void* ptags,
                                            const void* confirm, void* acc, int B, int LB, int W, int k, int nt,
                                            unsigned long long bin_lo, unsigned long long bin_hi, int lb,
                                            void* stream) {
  if (lb < 4 || lb > 30 || (form == 1 && ((uintptr_t)confirm & 15))) return (int)cudaErrorInvalidValue;
  ACC_POINT(0, 4, 1) ACC_POINT(0, 8, 1)
  ACC_POINT(1, 4, 1) ACC_POINT(1, 8, 1)
  ACC_POINT(2, 4, 1)
  return (int)cudaErrorInvalidValue;
}
