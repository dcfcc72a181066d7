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
// arithmetic is a few integer operations per lane.
//
// Design: one thread per lane. The registers are bytes and the card has no
// byte atomics, so each update is a compare-and-swap loop on the aligned
// 32-bit word that holds the byte. Registers only grow, so a plain read that
// already shows a value >= rank ends the update without an atomic: once a
// taxon's registers fill up most lanes cost no atomic at all. Taxa outside
// the lut and rows outside [0, P) are skipped, so no access leaves its plane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void byte_max(uint8_t* reg, long long slot, unsigned rank) {
  unsigned* word = reinterpret_cast<unsigned*>(reg + (slot & ~3LL));
  const int shift = (int)(slot & 3) * 8;
  unsigned old = *reinterpret_cast<volatile unsigned*>(word);
  while (((old >> shift) & 0xFFu) < rank) {
    const unsigned want = (old & ~(0xFFu << shift)) | (rank << shift);
    const unsigned prev = atomicCAS(word, old, want);
    if (prev == old) break;
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
