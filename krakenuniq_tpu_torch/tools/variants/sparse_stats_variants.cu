// A candidate design of csrc/sparse_stats.cu that the kept kernels were
// chosen over, built beside them for tools/kernel_variants.py to time on the
// card. It runs the kept tile bodies (decide_tile, emit_tile, emit_tail) on
// the kept scratch, which the kept key build clears:
//  * kPipelined: each pass on a persistent grid (its resident blocks) whose
//    blocks take tiles from the pass's counter in turn and copy the next
//    tile's keys into the other half of their shared memory (cp.async)
//    while they work on the current one, so that the copies overlap the
//    look-back's wait. The kept kernels take one tile a block.

#include "sparse_stats.cu"

namespace {

enum Form { kKept = 0, kPipelined = 1 };

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::); }

// start copying a tile's keys, as stored (sign-flipped), into sh
__device__ __forceinline__ void prefetch_keys(const long long* __restrict__ sk, long long n, int tile,
                                              unsigned long long* sh) {
  const long long t0 = (long long)tile * kTile;
  for (int p = threadIdx.x; p < kTile + 2; p += kThreads) {
    const long long i = t0 - 1 + p;
    if (i >= 0 && i < n)
      cp_async8(sh + p + (p >> 4), sk + i);
    else
      sh[p + (p >> 4)] = kPad ^ kSign;
  }
}

// the tiles of a pass, the next one's keys in flight while `body` runs
template <typename Body>
__device__ __forceinline__ void tiles_of(const long long* __restrict__ sk, long long n, int tiles, int* counter,
                                         Body body) {
  extern __shared__ unsigned long long stage[];  // two buffers of kStage
  __shared__ int ord_sh[2];
  if (threadIdx.x == 0) ord_sh[0] = atomicAdd(counter, 1);
  __syncthreads();
  int ord = ord_sh[0];
  if (ord < tiles) prefetch_keys(sk, n, ord, stage);
  cp_async_commit();
  for (int buf = 0; ord < tiles; buf ^= 1) {
    if (threadIdx.x == 0) ord_sh[buf ^ 1] = atomicAdd(counter, 1);
    __syncthreads();  // the next ordinal; the other buffer's last reader is done
    const int next = ord_sh[buf ^ 1];
    if (next < tiles) prefetch_keys(sk, n, next, stage + (buf ^ 1) * kStage);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    unsigned long long* sh = stage + buf * kStage;
    for (int p = threadIdx.x; p < kTile + 2; p += kThreads) sh[p + (p >> 4)] ^= kSign;  // as stage_keys leaves them
    __syncthreads();
    body(ord, sh);
    ord = next;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
sparse_stats_pipelined_decide_kernel(const long long* __restrict__ sk, const long long* __restrict__ ps,
                                     long long n, int th, int tiles, Scratch s) {
  tiles_of(sk, n, tiles, s.counter_a, [&](int tile, unsigned long long* sh) { decide_tile(tile, sh, ps, th, s); });
}

__global__ void __launch_bounds__(kThreads, 3)
sparse_stats_pipelined_emit_kernel(const long long* __restrict__ sk, long long n, int tiles, Scratch s,
                                   long long* __restrict__ buf, long long buf_len, int* __restrict__ n_pairs,
                                   int* __restrict__ n_events) {
  const long long np = s.totals[0];
  tiles_of(sk, n, tiles, s.counter_b,
           [&](int tile, unsigned long long* sh) { emit_tile(tile, sh, s, np, buf, buf_len); });
  emit_tail(s, buf, buf_len, n_pairs, n_events);
}

// a kernel's resident blocks over the card, its shared memory opted in
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int smem, int* blocks) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return err != cudaSuccess ? err : per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

// kuniq_sparse_stats' arguments after the form; kKept launches the kept entry.
extern "C" int kuniq_sparse_stats_variant(int form, const void* sk, const void* ps, long long n, int th, void* buf,
                                          long long buf_len, void* n_pairs, void* n_events, void* scratch,
                                          void* stream) {
  if (form == kKept) return kuniq_sparse_stats(sk, ps, n, th, buf, buf_len, n_pairs, n_events, scratch, stream);
  if (form != kPipelined || n <= 0 || n >= (1LL << 29)) return (int)cudaErrorInvalidValue;
  const Scratch s = layout(scratch, n);
  const int tiles = (int)n_tiles(n), smem = 2 * kStage * (int)sizeof(unsigned long long);
  int blocks_a = 0, blocks_b = 0;
  cudaError_t err = persistent_blocks(sparse_stats_pipelined_decide_kernel, smem, &blocks_a);
  if (err == cudaSuccess) err = persistent_blocks(sparse_stats_pipelined_emit_kernel, smem, &blocks_b);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* k = (const long long*)sk;
  sparse_stats_pipelined_decide_kernel<<<min(tiles, blocks_a), kThreads, smem, st>>>(k, (const long long*)ps, n, th,
                                                                                    tiles, s);
  sparse_stats_pipelined_emit_kernel<<<min(tiles, blocks_b), kThreads, smem, st>>>(
      k, n, tiles, s, (long long*)buf, buf_len, (int*)n_pairs, (int*)n_events);
  return (int)cudaGetLastError();
}
