// The per-span taxon dictionary: the sorted distinct dense ids a span can
// emit, and each lane's id remapped to its rank in it (a u16 local id).
//
// Replaces: the local_dict block of classify_step_core,
// krakenuniq_tpu/classify/device_step.py:286-370 (without its mesh merge),
// which the JAX package left to XLA: a sort of every lane of the span's id
// plane plus its calls, a cumsum of the first-occurrence flags, cap
// searchsorted probes for the dictionary and a scatter / gather remap.
// Over the ids x of ids[0, n) and calls[0, b) (all in [0, T)), with n_u
// distinct values u_0 < u_1 < ...:
//   lut[j]   = u_j for j < min(n_u, cap), 2^30 for the other j < cap
//   lut[cap] = n_u
//   local[i] = j if ids[i] == u_j and j < cap, else 0 (calls likewise)
// so a span past the dictionary's capacity keeps its first cap ids in the
// lut and the true n_u in its last element, and the ids it drops remap to 0
// (the JAX scatter's mode="drop"). Ids outside [0, T) are no entry and
// remap to 0.
//
// Bound on the H100: bytes. Each id of the plane and the calls is read once
// and each local id written once; a few operations per id.
//
// Design, with no sort and no table over the dense id space: one bit per
// id (T / 8 bytes: 300 KB at 2.4M ids, resident in the L2), in four
// records: (0) a memset clears the bitmap and the scan's look-back state;
// (1) mark: a persistent grid, one 1024-thread block an SM, walks the plane
// and the calls, and every id sets its bit in its block's shared table of
// bitmap words, unless it repeats the lane before it; each block adds its
// table to the bitmap at its end, one atomic or a word (an id whose slot
// another word holds sets its bit in the bitmap, if a read from the L2
// finds it unset): zipf ids send most lanes to a few hot words, and a
// span's ids cluster in few words, so atomics on the bitmap itself would
// serialize; (2) scan: one block per superblock of kSuperWords
// words takes the popcounts of its words, its first rank from the
// superblocks before it by decoupled look-back, keeps each word with its
// first rank ({bits, rank} in 8 bytes) and writes lut[rank] = id for each
// set bit below cap; the last superblock writes n_u and the pads; (3)
// remap: each id's rank is its word's first rank plus the popcount of the
// word's bits below it, one 8-byte read from the L2. The id plane is read
// twice, by (1) and (3); (3) reads it and writes the local ids evict-first,
// so that the part of the plane (34 MB at the span) that the L2 still holds
// from (1) is not pushed out by the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kSuperWords = kThreads * kWordsPerThread;  // bitmap words of one scan block
constexpr int kLutPad = 1 << 30;                          // above any dense id: keeps the lut sorted
constexpr int kTableBits = 12;                            // slots of a mark block's table of words
constexpr int kMarkThreads = 1024, kMarkBlocksPerSm = 1;  // one table of marked ids an SM
constexpr int kUnroll = 4;                                // quads of lanes a mark thread loads at once
constexpr unsigned kFull = 0xffffffffu;

// Exclusive sum over the block of one int per thread; *total gets the sum.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int inc = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const int out = (warp == 0 ? 0 : warp_tot[warp - 1]) + inc - x;
  *total = warp_tot[n_warps - 1];
  __syncthreads();
  return out;
}

__host__ __device__ __forceinline__ long long n_words(int t) { return ((long long)t + 31) / 32; }
__host__ __device__ __forceinline__ int n_supers(int t) { return (int)((n_words(t) + kSuperWords - 1) / kSuperWords); }

// Scratch, as int32 words: the bitmap, the scan's block counter and, on 8
// bytes, its look-back word per superblock (all cleared by the memset), then
// each word with its first rank.
struct Scratch {
  unsigned* bits;
  int* counter;
  unsigned long long* status;
  int2* word_rank;
};

__host__ __device__ __forceinline__ long long status_offset(int t) { return (n_words(t) + 1 + 1) / 2 * 2; }
__host__ __device__ __forceinline__ long long cleared_words(int t) { return status_offset(t) + 2LL * n_supers(t); }

__host__ __device__ __forceinline__ Scratch layout(void* base, int t) {
  int* w = (int*)base;
  return Scratch{(unsigned*)w, w + n_words(t), (unsigned long long*)(w + status_offset(t)),
                 (int2*)(w + cleared_words(t))};
}

// A block's table of bitmap words (direct-mapped, 2^kTableBits slots in
// shared memory: a word index, -1 while the slot is free, and the bits the
// block has seen in it). An id whose word holds a slot sets its bit there,
// after reading it (zipf ids send most lanes to a few hot words, and the
// ids a span holds cluster in few words); the block adds each word's bits
// to the bitmap with one atomic or at its end. An id whose slot holds
// another word (a slot is never given up, so no bit is lost to a race)
// reads its word from the L2 and sets its bit there only if it is unset.
struct WordTable {
  int* word;
  unsigned* bits;
};

__device__ __forceinline__ void mark(Scratch s, WordTable tab, const int (&x)[4], int t) {
#pragma unroll
  for (int j = 0; j < 4; j++) {
    if ((unsigned)x[j] >= (unsigned)t || (j > 0 && x[j] == x[j - 1])) continue;
    const int w = x[j] >> 5;
    const unsigned bit = 1u << (x[j] & 31);
    const int slot = ((unsigned)w * 2654435761u) >> (32 - kTableBits);
    int held = tab.word[slot];
    if (held < 0) {
      held = atomicCAS(tab.word + slot, -1, w);
      if (held < 0) held = w;
    }
    if (held == w) {
      if (!(tab.bits[slot] & bit)) atomicOr(tab.bits + slot, bit);
    } else if (!(__ldcg(s.bits + w) & bit)) {
      atomicOr(s.bits + w, bit);
    }
  }
}

// (1) a grid-stride walk over the plane's quads of lanes, kUnroll quads a
// thread a step with their loads in flight together (one 16-byte load a
// quad when `vec`), then over the calls
__global__ void __launch_bounds__(kMarkThreads)
span_dict_mark_kernel(const int32_t* __restrict__ ids, long long n, const int32_t* __restrict__ calls, int b,
                      bool vec, Scratch s, int t) {
  __shared__ int table_word[1 << kTableBits];
  __shared__ unsigned table_bits[1 << kTableBits];
  const WordTable tab{table_word, table_bits};
  for (int i = threadIdx.x; i < (1 << kTableBits); i += kMarkThreads) {
    table_word[i] = -1;
    table_bits[i] = 0;
  }
  __syncthreads();
  // quads below `full` are read by one 16-byte load each, issued together
  // (at a clamped index, without a branch); the rest lane by lane
  const long long stride = (long long)gridDim.x * kMarkThreads, quads = (n + 3) / 4, full = vec ? n / 4 : 0;
  for (long long q0 = (long long)blockIdx.x * kMarkThreads + threadIdx.x; q0 < quads; q0 += kUnroll * stride) {
    int4 v[kUnroll];
    if (full > 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; u++) {
        const long long q = q0 + u * stride;
        v[u] = __ldg((const int4*)ids + (q < full ? q : full - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const long long q = q0 + u * stride;
      int x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      if (q >= full) {
#pragma unroll
        for (int j = 0; j < 4; j++) x[j] = 4 * q + j < n ? ids[4 * q + j] : -1;
      }
      mark(s, tab, x, t);
    }
  }
  for (long long c = (long long)blockIdx.x * kMarkThreads + threadIdx.x; c < b; c += stride) {
    const int x[4] = {calls[c], -1, -1, -1};
    mark(s, tab, x, t);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (1 << kTableBits); i += kMarkThreads)
    if (table_bits[i]) atomicOr(s.bits + table_word[i], table_bits[i]);
}

// The exclusive prefix of the superblocks before ordinal d, by decoupled
// look-back over one 64-bit word per superblock (state << 32 | count; state
// 1: its count, 2: the inclusive prefix), run by warp 0 (every lane gets it);
// publishes this superblock's count and then its inclusive prefix.
__device__ int look_back(int d, int count, unsigned long long* status) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* vs = status;
  if (lane == 0) vs[d] = (d == 0 ? 2ull << 32 : 1ull << 32) | (unsigned)count;
  int run = 0;
  if (d == 0) return run;
  for (int i = d - 1;; i -= 32) {
    const int j = i - lane;
    unsigned long long v = 2ull << 32;  // before ordinal 0: nothing
    if (j >= 0) {
      do {
        v = vs[j];
      } while ((v >> 32) == 0);
    }
    const unsigned inclusive = __ballot_sync(kFull, (v >> 32) == 2);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    run += __reduce_add_sync(kFull, lane <= stop ? (int)(unsigned)v : 0);
    if (inclusive) break;
  }
  if (lane == 0) vs[d] = (2ull << 32) | (unsigned)(run + count);
  return run;
}

// (2) superblocks of kSuperWords words in the order of a block counter:
// each word with its first rank; lut[rank] = id below cap; from the last
// superblock, lut[cap] = n_u and the pads from n_u to cap
__global__ void __launch_bounds__(kThreads)
span_dict_scan_kernel(Scratch s, int t, int32_t* __restrict__ lut, int cap) {
  __shared__ int ord_sh, before_sh;
  if (threadIdx.x == 0) ord_sh = atomicAdd(s.counter, 1);
  __syncthreads();
  const int ord = ord_sh;
  const long long words = n_words(t);
  const long long w0 = (long long)ord * kSuperWords + threadIdx.x * kWordsPerThread;
  unsigned bw[kWordsPerThread];
  int c = 0;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; j += 4) {
    if (w0 + j + 4 <= words) {
      const uint4 v = __ldcg((const uint4*)(s.bits + w0 + j));
      bw[j] = v.x, bw[j + 1] = v.y, bw[j + 2] = v.z, bw[j + 3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; k++) bw[j + k] = w0 + j + k < words ? __ldcg(s.bits + w0 + j + k) : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kWordsPerThread; j++) c += __popc(bw[j]);
  int count;
  const int excl = block_exclusive_sum(c, &count);
  if (threadIdx.x < 32) {
    const int before = look_back(ord, count, s.status);
    if (threadIdx.x == 0) before_sh = before;
  }
  __syncthreads();
  int r = before_sh + excl;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; j++) {
    if (w0 + j >= words) break;
    s.word_rank[w0 + j] = make_int2((int)bw[j], r);
    int rr = r;
    for (unsigned m = bw[j]; m && rr < cap; m &= m - 1, rr++) lut[rr] = (int)((w0 + j) * 32 + __ffs(m) - 1);
    r += __popc(bw[j]);
  }
  if (ord == (int)gridDim.x - 1) {
    const int n_u = before_sh + count;
    for (int j = n_u + threadIdx.x; j < cap; j += kThreads) lut[j] = kLutPad;
    if (threadIdx.x == 0) lut[cap] = n_u;
  }
}

__device__ __forceinline__ int rank_of(const int2* __restrict__ word_rank, int x, int t, int cap) {
  if ((unsigned)x >= (unsigned)t) return 0;
  const int2 v = __ldg(word_rank + (x >> 5));
  const int r = v.y + __popc((unsigned)v.x & ((1u << (x & 31)) - 1));
  return r < cap ? r : 0;
}

// (3) each lane's local id (and each call's): thread q < quads takes the
// plane's lanes 4q .. 4q + 3 (one 16-byte load when `vec`), the next b
// threads one call each
__global__ void __launch_bounds__(kThreads)
span_dict_remap_kernel(const int32_t* __restrict__ ids, long long n, const int32_t* __restrict__ calls, int b,
                       bool vec, const int2* __restrict__ word_rank, int t, int cap, int32_t* __restrict__ local,
                       int32_t* __restrict__ local_call) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x, quads = (n + 3) / 4;
  if (q < quads) {
    const long long i0 = 4 * q;
    if (vec && i0 + 4 <= n) {
      const int4 v = __ldcs((const int4*)(ids + i0));
      __stcs((int4*)(local + i0), make_int4(rank_of(word_rank, v.x, t, cap), rank_of(word_rank, v.y, t, cap),
                                            rank_of(word_rank, v.z, t, cap), rank_of(word_rank, v.w, t, cap)));
    } else {
      for (long long i = i0; i < n && i < i0 + 4; i++) local[i] = rank_of(word_rank, ids[i], t, cap);
    }
  } else if (local_call && q - quads < b) {
    local_call[q - quads] = rank_of(word_rank, calls[q - quads], t, cap);
  }
}

// The current device's SM count, cached per device.
cudaError_t sm_count(int* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (cached[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  *sms = cached[dev];
  return cudaSuccess;
}

}  // namespace

// int32 words of scratch kuniq_span_dict needs for a dense space of t ids.
extern "C" int kuniq_span_dict_scratch(int t) { return (int)(cleared_words(t) + 2 * n_words(t)); }

// ids int32 [n], calls int32 [b] (ids in [0, t)); lut int32 [cap + 1];
// local int32 [n]; local_call int32 [b] or null (no call remap); scratch of
// kuniq_span_dict_scratch(t) int32 words.
extern "C" int kuniq_span_dict(const void* ids, long long n, const void* calls, int b, int t, int cap, void* lut,
                               void* local, void* local_call, void* scratch, void* stream) {
  if (n < 0 || b < 0 || t <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = layout(scratch, t);
  const bool vec = ((uintptr_t)ids | (uintptr_t)local) % 16 == 0;
  const long long threads = (n + 3) / 4 + b;
  int sms = 0;
  cudaError_t rc = sm_count(&sms);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(scratch, 0, (size_t)cleared_words(t) * 4, st);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  const long long mark_blocks = (threads + kMarkThreads - 1) / kMarkThreads;
  if (threads > 0)
    span_dict_mark_kernel<<<(unsigned)(mark_blocks < sms * kMarkBlocksPerSm ? mark_blocks : sms * kMarkBlocksPerSm),
                            kMarkThreads, 0, st>>>((const int32_t*)ids, n, (const int32_t*)calls, b, vec, s, t);
  span_dict_scan_kernel<<<n_supers(t), kThreads, 0, st>>>(s, t, (int32_t*)lut, cap);
  if (threads > 0)
    span_dict_remap_kernel<<<(unsigned)blocks, kThreads, 0, st>>>((const int32_t*)ids, n, (const int32_t*)calls, b,
                                                                  vec, s.word_rank, t, cap, (int32_t*)local,
                                                                  (int32_t*)local_call);
  return (int)cudaGetLastError();
}
