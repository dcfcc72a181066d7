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
//
// Bound on the H100: bytes. Each lane reads k code and k flag bytes that
// overlap its neighbours' (one pass over [B, LB] from device memory, the
// rest hits L1) and writes 13 bytes; the arithmetic is a few dozen integer
// operations per lane.
//
// Design: consecutive threads take consecutive lanes of a row, so the
// window reads of a warp fall on the same cache lines and the int64/int32/
// uint8 stores are coalesced. No intermediate plane touches device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPPrime = 25;  // sparse precision, hyperloglogplus.hpp:76

__device__ __forceinline__ uint64_t reverse_complement(uint64_t x, int n) {
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return (~x) >> (64 - 2 * n);
}

__device__ __forceinline__ uint64_t murmur3_finalizer(uint64_t key) {
  key += 1;
  key ^= key >> 33;
  key *= 0xFF51AFD7ED558CCDull;
  key ^= key >> 33;
  key *= 0xC4CEB9FE1A85EC53ull;
  key ^= key >> 33;
  return key;
}

__device__ __forceinline__ uint32_t encode_hash(uint64_t h, int p) {
  const uint32_t idx = (uint32_t)((h >> (64 - kPPrime)) << (32 - kPPrime));
  if ((uint32_t)(idx << p) != 0) return idx;
  const uint64_t shifted = h << kPPrime;
  int clz = shifted == 0 ? 64 : __clzll((long long)shifted);
  clz = min(clz, 64 - kPPrime);
  return idx | ((uint32_t)(clz + 1) << 1) | 1u;
}

__global__ void __launch_bounds__(kThreads)
kmer_front_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ ambig,
                  uint64_t* __restrict__ hash_out, uint32_t* __restrict__ enc_out,
                  uint8_t* __restrict__ amb_out, int B, int LB, int k, int p) {
  const int W = LB - k + 1;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * W) return;
  const long long row = idx / W;
  const int lane = (int)(idx - row * W);
  const uint8_t* c = codes + row * LB + lane;
  const uint8_t* a = ambig + row * LB + lane;
  uint64_t fwd = 0;
  uint8_t amb = 0;
  for (int t = 0; t < k; ++t) {
    fwd |= (uint64_t)c[t] << (2 * (k - 1 - t));
    amb |= a[t];
  }
  const uint64_t rc = reverse_complement(fwd, k);
  const uint64_t h = murmur3_finalizer(fwd < rc ? fwd : rc);
  hash_out[idx] = h;
  enc_out[idx] = encode_hash(h, p);
  amb_out[idx] = amb != 0;
}

}  // namespace

extern "C" int kuniq_kmer_front(const void* codes, const void* ambig, void* hash_out,
                                void* enc_out, void* amb_out, int B, int LB, int k, int p,
                                void* stream) {
  const long long n = (long long)B * (LB - k + 1);
  if (n <= 0) return (int)cudaGetLastError();
  const long long grid = (n + kThreads - 1) / kThreads;
  kmer_front_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)ambig, (uint64_t*)hash_out, (uint32_t*)enc_out,
      (uint8_t*)amb_out, B, LB, k, p);
  return (int)cudaGetLastError();
}
