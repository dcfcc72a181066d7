// Dense HLL register update: reg[row(taxon), idx] = max(reg[..], rank).
//
// Replaces: the register half of krakenuniq_tpu/classify/device_counters.py
// update_core (:95-152), which the JAX package left to XLA in three forms
// that compute the same maximum: a direct scatter-max when register rows
// are the id space (:109-116), a sort + searchsorted segment max over
// global slot keys (:118-145), and a lut gather + scatter-max (:147-152).
// This one kernel serves all three: `lut` maps a taxon to its register row,
// or is null when the rows are the id space.
//
// Per counted lane (the uint32 encoding `enc` of hyperloglogplus.cpp:181-204):
//   idx  = enc >> (32 - p)
//   rank = flagged (enc & 1) ? ((enc >> 1) & 63) + 25 - p
//                            : min(clz32(enc << p), 32 - p) + 1
// with clz32(0) = 32, as utils/bits.decode_rank decodes it.
//
// Bound on the H100: bytes. Per lane a 4-byte taxon, a 4-byte encoding and
// a 1-byte flag are read; the register plane is read and written once. The
// arithmetic is a few integer operations per lane. Under zipf-skewed taxa
// the work is not spread over the plane: a third of the lanes can fall in
// one 4 KB register row (p = 12), so their reads and atomics queue on the
// few L2 slices that hold it.
//
// Design: one thread per lane. The registers are bytes and the card has no
// byte atomics, so an update is a compare-and-swap loop on the aligned
// 32-bit word that holds the byte (want = __vmaxu4(old, rank << shift)).
// Before any atomic, a pre-check reads the word through L1 (ld.global.ca,
// __ldca) and stops when the byte already holds >= rank. This is exact
// although L1 is not coherent with other SMs' atomics: registers only
// grow, so any value the word ever held, stale or not, is a lower bound of
// its current value. A stale read can only send a lane on to the CAS, whose
// returned value is the current word and ends the loop once it is >= rank;
// it can never skip a needed update. So the hot row's pre-checks are
// served from each SM's L1 instead of all queueing on the same L2 lines.
// Measured on the card (PERF.md) and not kept: warp aggregation
// (__match_any_sync on the word, byte maxima combined, one CAS per word per
// warp) costs more in the match than it saves except when one slot takes
// every lane; several lanes per thread with 16-byte loads; a block's hot
// row privatised in shared memory. Taxa outside the lut and rows outside
// [0, P) are skipped, so no access leaves its plane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void byte_max(uint8_t* reg, long long slot, unsigned rank) {
  unsigned* word = reinterpret_cast<unsigned*>(reg + (slot & ~3LL));
  const unsigned packed = rank << ((int)(slot & 3) * 8);
  unsigned old = __ldca(word);  // a lower bound of the word (see above)
  while (true) {
    const unsigned want = __vmaxu4(old, packed);
    if (want == old) return;
    const unsigned prev = atomicCAS(word, old, want);
    if (prev == old) return;
    old = prev;
  }
}

__global__ void __launch_bounds__(kThreads)
hll_regmax_kernel(uint8_t* __restrict__ reg, const int32_t* __restrict__ taxa,
                  const uint32_t* __restrict__ enc, const uint8_t* __restrict__ lanes,
                  const int32_t* __restrict__ lut, long long n, int n_ids, int n_rows,
                  int p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !lanes[i]) return;
  const int taxon = taxa[i];
  if (lut && (unsigned)taxon >= (unsigned)n_ids) return;
  const int row = lut ? __ldg(lut + taxon) : taxon;
  if ((unsigned)row >= (unsigned)n_rows) return;
  const uint32_t e = enc[i];
  const uint32_t idx = e >> (32 - p);
  unsigned rank;
  if (e & 1u) {
    rank = (((e >> 1) & 0x3Fu) + 25u - (unsigned)p) & 0xFFu;
  } else {
    const uint32_t shifted = e << p;
    unsigned clz = shifted ? (unsigned)__clz(shifted) : 32u;
    if (clz > 32u - (unsigned)p) clz = 32u - (unsigned)p;
    rank = clz + 1u;
  }
  byte_max(reg, ((long long)row << p) + idx, rank);
}

}  // namespace

extern "C" int kuniq_hll_regmax(void* reg, const void* taxa, const void* enc, const void* lanes,
                                const void* lut, long long n, int n_ids, int n_rows, int p,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long grid = (n + kThreads - 1) / kThreads;
  hll_regmax_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)reg, (const int32_t*)taxa, (const uint32_t*)enc, (const uint8_t*)lanes,
      (const int32_t*)lut, n, n_ids, n_rows, p);
  return (int)cudaGetLastError();
}
