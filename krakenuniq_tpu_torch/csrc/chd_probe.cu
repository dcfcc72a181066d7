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
// dependent reads at random addresses of a table far larger than the 50 MB
// L2 (4 bytes of the displacement plane, then one 16-byte row), so device
// memory serves two sectors per query whatever the byte count.
//
// Design: one thread per query, the row read as one 16-byte vector load
// (uint4) so a query touches exactly one sector of the row plane; the
// displacement word and the row go through the read-only path (__ldg).
// Invalid lanes skip both reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kC2 = 0xC2B2AE3D27D4EB4Full;

__global__ void __launch_bounds__(kThreads)
chd_probe_kernel(const uint32_t* __restrict__ disp, const uint4* __restrict__ rows,
                 const uint64_t* __restrict__ hashes, const uint8_t* __restrict__ valid,
                 uint32_t* __restrict__ out, long long n, int lr, int lg) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    out[i] = 0;
    return;
  }
  const uint64_t h = hashes[i];
  const uint32_t p = (uint32_t)(h >> (64 - lr));
  const uint64_t r = h & ((1ull << (64 - lr)) - 1);
  const uint32_t g = (uint32_t)((r * kGolden) >> (64 - lg));
  const uint32_t q = (uint32_t)((r * kC2) >> (64 - lr));
  const uint32_t d = __ldg(disp + g);
  const uint32_t v_mask = (1u << lr) - 1;
  const uint32_t row = (p + (d & 0xFFFFu) + (d >> 16) * q) & v_mask;
  const uint4 rw = __ldg(rows + row);
  const uint32_t e_hi = (uint32_t)(r >> (32 - lr));
  const uint32_t e_lo = (uint32_t)((r & ((1ull << (32 - lr)) - 1)) << lr);
  const uint32_t v0 = (rw.x == e_hi && (rw.y & ~v_mask) == e_lo) ? (rw.y & v_mask) : 0u;
  const uint32_t v1 = (rw.z == e_hi && (rw.w & ~v_mask) == e_lo) ? (rw.w & v_mask) : 0u;
  out[i] = v0 > v1 ? v0 : v1;
}

}  // namespace

extern "C" int kuniq_chd_probe(const void* disp, const void* rows, const void* hashes,
                               const void* valid, void* out, long long n, int lr, int lg,
                               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long grid = (n + kThreads - 1) / kThreads;
  chd_probe_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)disp, (const uint4*)rows, (const uint64_t*)hashes,
      (const uint8_t*)valid, (uint32_t*)out, n, lr, lg);
  return (int)cudaGetLastError();
}
