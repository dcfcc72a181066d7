// Candidate designs of csrc/span_dict.cu that the kept kernels were chosen
// over, built beside them for tools/kernel_variants.py to time on the card.
// Each runs the kept memset, scan and (but for kPlainRemap) remap, and
// changes one stage:
//  * kMatchMark: the first marking design: every lane of the plane and the
//    calls, the first lane of a warp holding an id alone (__match_any_sync),
//    reads the word through L1 and sets the bit by an atomic or (no table of
//    marked ids, a thread a lane);
//  * kIdTable: a block's shared table of the ids it has marked (direct-
//    mapped, an id a slot) in front of the bitmap: an id's first sighting
//    in a block reads its word from the L2 and sets its bit there by an
//    atomic or if it is unset (the kept kernel keeps a table of words and
//    adds each to the bitmap once, at the block's end);
//  * kBlindMark: the table of ids, but every first sighting sets its bit
//    by an atomic or without reading the word first;
//  * kPlainRemap: the kept marking, the remap reading the ids and writing
//    the local ids with the default cache policy instead of evict-first.

#include "span_dict.cu"

namespace {

enum Form { kKept = 0, kMatchMark = 1, kBlindMark = 2, kPlainRemap = 3, kIdTable = 4 };

constexpr int kSeenBits = 12;  // slots of a block's table of ids

__device__ __forceinline__ void mark_match(Scratch s, int x, bool active, int t) {
  const bool ok = active && (unsigned)x < (unsigned)t;
  const unsigned act = __ballot_sync(kFull, ok);
  if (!ok) return;
  const unsigned peers = __match_any_sync(act, x);
  if ((int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  const unsigned bit = 1u << (x & 31);
  unsigned* word = s.bits + (x >> 5);
  if (!(__ldca(word) & bit)) atomicOr(word, bit);  // a stale 0 read through L1 only repeats the atomic
}

// a thread a lane of the plane, then of the calls, on whole warps
__global__ void __launch_bounds__(kThreads)
span_dict_match_mark_kernel(const int32_t* __restrict__ ids, long long n, const int32_t* __restrict__ calls, int b,
                            Scratch s, int t) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x, lanes = (n + 31) / 32 * 32;
  if (i < lanes)
    mark_match(s, i < n ? ids[i] : -1, i < n, t);
  else
    mark_match(s, i - lanes < b ? calls[i - lanes] : -1, i - lanes < b, t);
}

// a lane a thread, over a persistent grid, behind a block's table of ids;
// `read`: a first sighting reads its word before setting its bit
template <bool kRead>
__global__ void __launch_bounds__(kMarkThreads)
span_dict_id_table_mark_kernel(const int32_t* __restrict__ ids, long long n, const int32_t* __restrict__ calls,
                               int b, Scratch s, int t) {
  __shared__ int seen[1 << kSeenBits];
  for (int i = threadIdx.x; i < (1 << kSeenBits); i += kMarkThreads) seen[i] = -1;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kMarkThreads;
  for (long long i = (long long)blockIdx.x * kMarkThreads + threadIdx.x; i < n + b; i += stride) {
    const int x = i < n ? ids[i] : calls[i - n];
    if ((unsigned)x >= (unsigned)t) continue;
    int* slot = seen + (((unsigned)x * 2654435761u) >> (32 - kSeenBits));
    if (*slot == x) continue;
    *slot = x;
    const unsigned bit = 1u << (x & 31);
    if (!kRead || !(__ldcg(s.bits + (x >> 5)) & bit)) atomicOr(s.bits + (x >> 5), bit);
  }
}

// the kept remap with the default cache policy
__global__ void __launch_bounds__(kThreads)
span_dict_plain_remap_kernel(const int32_t* __restrict__ ids, long long n, const int32_t* __restrict__ calls, int b,
                             bool vec, const int2* __restrict__ word_rank, int t, int cap,
                             int32_t* __restrict__ local, int32_t* __restrict__ local_call) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x, quads = (n + 3) / 4;
  if (q < quads) {
    const long long i0 = 4 * q;
    if (vec && i0 + 4 <= n) {
      const int4 v = *(const int4*)(ids + i0);
      *(int4*)(local + i0) = make_int4(rank_of(word_rank, v.x, t, cap), rank_of(word_rank, v.y, t, cap),
                                       rank_of(word_rank, v.z, t, cap), rank_of(word_rank, v.w, t, cap));
    } else {
      for (long long i = i0; i < n && i < i0 + 4; i++) local[i] = rank_of(word_rank, ids[i], t, cap);
    }
  } else if (local_call && q - quads < b) {
    local_call[q - quads] = rank_of(word_rank, calls[q - quads], t, cap);
  }
}

}  // namespace

// kuniq_span_dict's arguments after the form; kKept launches the kept entry.
extern "C" int kuniq_span_dict_variant(int form, const void* ids, long long n, const void* calls, int b, int t,
                                       int cap, void* lut, void* local, void* local_call, void* scratch,
                                       void* stream) {
  if (form == kKept) return kuniq_span_dict(ids, n, calls, b, t, cap, lut, local, local_call, scratch, stream);
  if (n < 0 || b < 0 || t <= 0 || cap <= 0 || form < 0 || form > kIdTable) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = layout(scratch, t);
  const bool vec = ((uintptr_t)ids | (uintptr_t)local) % 16 == 0;
  const int32_t *x = (const int32_t*)ids, *c = (const int32_t*)calls;
  const long long threads = (n + 3) / 4 + b;
  int sms = 0;
  cudaError_t rc = sm_count(&sms);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(scratch, 0, (size_t)cleared_words(t) * 4, st);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  const long long mark_blocks = (threads + kMarkThreads - 1) / kMarkThreads;
  const unsigned persistent =
      (unsigned)(mark_blocks < sms * kMarkBlocksPerSm ? mark_blocks : sms * kMarkBlocksPerSm);
  if (n + b > 0) {
    if (form == kMatchMark)
      span_dict_match_mark_kernel<<<(unsigned)(((n + 31) / 32 * 32 + b + kThreads - 1) / kThreads), kThreads, 0,
                                    st>>>(x, n, c, b, s, t);
    else if (form == kBlindMark)
      span_dict_id_table_mark_kernel<false><<<persistent, kMarkThreads, 0, st>>>(x, n, c, b, s, t);
    else if (form == kIdTable)
      span_dict_id_table_mark_kernel<true><<<persistent, kMarkThreads, 0, st>>>(x, n, c, b, s, t);
    else
      span_dict_mark_kernel<<<persistent, kMarkThreads, 0, st>>>(x, n, c, b, vec, s, t);
  }
  span_dict_scan_kernel<<<n_supers(t), kThreads, 0, st>>>(s, t, (int32_t*)lut, cap);
  if (n + b > 0) {
    if (form == kPlainRemap)
      span_dict_plain_remap_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(x, n, c, b, vec, s.word_rank, t, cap,
                                                                          (int32_t*)local, (int32_t*)local_call);
    else
      span_dict_remap_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(x, n, c, b, vec, s.word_rank, t, cap,
                                                                    (int32_t*)local, (int32_t*)local_call);
  }
  return (int)cudaGetLastError();
}
