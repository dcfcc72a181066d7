// Random row fetches with a set number of copies in flight:
// out[i] = table[q[i]] for a [R, row_words] uint32 table.
//
// Replaces: tools/probe_dma_exp.py, make_probe, the TPU probe that measured
// random-row fetch rates against the number S of row DMAs in flight: one
// scalar core issued row copies into a VMEM scratch block through a ring of S
// semaphores, waiting on copy i-S before issuing copy i, and wrote the block
// out. (That TPU backend could not compile a 16-byte copy, so it fetched
// 512-byte rows; the card copies 16-byte rows as they are.)
//
// Bound on the H100: bytes, counted as 4 bytes of index plus one row read
// and one row written per query. The reads land on random addresses of a
// table far larger than the 50 MB L2, so for rows under 32 bytes device
// memory serves a whole 32-byte sector per row, and what it sustains for
// such scattered sectors (about 25 G per second from a 1 GiB table, the
// same at every S from 1 to 64) is the limit, not the kernel. 512-byte rows
// run at 87% of the bytes bound.
//
// Design: a row is c = row_words / 4 16-byte chunks (c divides 32) and the
// work is n * c chunks. A block is one warp and takes one tile of K * 32
// consecutive chunks (K = copies per lane, at least S), lane l the chunks
// 32 j + l: index loads and row stores coalesce and a lane's chunk within
// its rows never changes. The grid is sized from the work, so even one work
// unit's queries give every SM blocks, and the card's block scheduler keeps
// each SM as full as the rings' shared memory allows (up to 32 one-warp
// blocks), starting a new block as soon as one ends. Each lane runs the TPU
// kernel's ring: its copy j is a 16-byte cp.async into ring slot j % S,
// committed as its own group; before issuing copy j it waits
// (cp.async.wait_group S-1) for copy j-S, writes that slot's chunk out and
// reuses the slot. No index block is staged: the index of copy j+S rides in
// copy j's group (a 4-byte cp.async into a second ring), so it has landed
// when copy j+S is issued. S is a template parameter because wait_group
// takes an immediate. A lane reads only the slots it filled itself, so no
// barrier is needed between copy and store. Indices outside [0, R) give a
// zero row instead of a read. Measured and not kept (the candidates are in
// tools/variants/row_gather_variants.cu, timed by tools/kernel_variants.py):
// a ring of S registers (ld.global.nc) for S <= 16, blocks of up to 1024
// threads sized from S on a persistent grid, and one-lane-per-warp
// cp.async.bulk copies with an mbarrier per slot. None was faster at S = 16
// on 8.5M 16-byte rows or at 512-byte rows; bulk copies were ~4x slower at
// 16 bytes. The register ring is faster at one unit's 532,480 rows, and
// blocks sized from S at S = 256, each by under 10%.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int S>
__global__ void __launch_bounds__(kLanes)
row_gather_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ q, uint4* __restrict__ out,
                  long long units, long long n_rows, int lc, int copies) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x;
  uint4* ring = smem + lane;  // slot j at ring[j * kLanes]
  int32_t* qring = reinterpret_cast<int32_t*>(smem + S * kLanes) + lane;
  const long long base = (long long)blockIdx.x * copies * kLanes + lane;  // copy k's chunk: base + 32 k
  const long long left = units - base;
  const int k_end = left > 0 ? (int)min((long long)copies, (left + kLanes - 1) / kLanes) : 0;
  const int chunk = lane & ((1 << lc) - 1);

  auto fetch_index = [&](int k) {
    if (k < k_end) cp_async4(qring + (k % S) * kLanes, q + ((base + (long long)k * kLanes) >> lc));
  };
  auto store = [&](int k) { out[base + (long long)k * kLanes] = ring[(k % S) * kLanes]; };

  for (int k = 0; k < S; ++k) fetch_index(k);
  cp_async_commit();
  cp_async_wait<0>();
  for (int k = 0; k < k_end; ++k) {
    if (k >= S) {
      cp_async_wait<S - 1>();  // copy k-S and the index of copy k have landed
      store(k - S);
    }
    const int32_t idx = qring[(k % S) * kLanes];
    uint4* slot = ring + (k % S) * kLanes;
    if (idx >= 0 && idx < n_rows) {
      cp_async16(slot, table + ((long long)idx << lc) + chunk);
    } else {
      *slot = make_uint4(0u, 0u, 0u, 0u);
    }
    fetch_index(k + S);
    cp_async_commit();
  }
  cp_async_wait<0>();
  for (int k = k_end > S ? k_end - S : 0; k < k_end; ++k) store(k);
}

template <int S>
int launch(const void* table, const void* q, void* out, long long n, long long n_rows, int lc, int copies,
           cudaStream_t stream, long long* geometry) {
  const size_t smem = (size_t)S * kLanes * (sizeof(uint4) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(row_gather_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long units = n << lc;
  const long long per_block = (long long)copies * kLanes;
  const long long grid = (units + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (geometry) {  // report the launch instead of making it
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_gather_kernel<S>, kLanes, smem);
    geometry[0] = kLanes;
    geometry[1] = grid;
    geometry[2] = (long long)smem;
    geometry[3] = per_sm;
    return (int)e;
  }
  row_gather_kernel<S><<<(unsigned)grid, kLanes, smem, stream>>>(
      (const uint4*)table, (const int32_t*)q, (uint4*)out, units, n_rows, lc, copies);
  return (int)cudaGetLastError();
}

int dispatch(const void* table, const void* q, void* out, long long n, long long n_rows, int row_words, int depth,
             int copies, cudaStream_t s, long long* geometry) {
  const int c = row_words / 4;
  if (row_words % 4 || c < 1 || kLanes % c || copies < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0 && !geometry) return (int)cudaGetLastError();
  int lc = 0;
  while ((1 << lc) < c) ++lc;
  switch (depth) {
    case 1: return launch<1>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 2: return launch<2>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 4: return launch<4>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 8: return launch<8>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 16: return launch<16>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 32: return launch<32>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 64: return launch<64>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 128: return launch<128>(table, q, out, n, n_rows, lc, copies, s, geometry);
    case 256: return launch<256>(table, q, out, n, n_rows, lc, copies, s, geometry);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// depth: S, the copies in flight per lane (1-256, a power of two); copies:
// the copies per lane in all (at least 1).
extern "C" int kuniq_row_gather(const void* table, const void* q, void* out, long long n, long long n_rows,
                                int row_words, int depth, int copies, void* stream) {
  return dispatch(table, q, out, n, n_rows, row_words, depth, copies, (cudaStream_t)stream, nullptr);
}

// The launch kuniq_row_gather makes for the same n, row_words, depth and
// copies on the current device, launching nothing: geometry[0] threads per
// block, [1] blocks, [2] shared memory bytes per block, [3] blocks one SM
// holds (the occupancy calculator's answer).
extern "C" int kuniq_row_gather_geometry(long long n, int row_words, int depth, int copies, long long* geometry) {
  return dispatch(nullptr, nullptr, nullptr, n, 0, row_words, depth, copies, nullptr, geometry);
}
