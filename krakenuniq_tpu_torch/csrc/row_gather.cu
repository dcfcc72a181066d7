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
// memory serves a whole 32-byte sector per row: the sweep over S measures
// how close the random sector rate comes to that.
//
// Design: a block is one warp and owns `rows_per_block` consecutive queries,
// whose indices it first stages in shared memory (the TPU kernel's SMEM
// query block). A row is c = row_words / 4 16-byte chunks (c divides 32);
// each lane copies one chunk of a row, so a warp step covers 32 / c rows.
// Each lane runs the TPU kernel's ring: its load j is a 16-byte cp.async into
// ring slot j % S, committed as its own group; before issuing load j it waits
// (cp.async.wait_group S-1) for load j-S, writes that slot's chunk to `out`
// and reuses the slot. So each lane keeps S copies in flight: S rows of 512
// bytes, or 32 S rows of 16 bytes, per block. S is a template parameter
// because wait_group takes an immediate. A lane reads only the slots it
// filled itself, so no barrier is needed between the copy and the write.
// Query indices outside [0, R) give a zero row instead of a read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int S>
__global__ void __launch_bounds__(kLanes)
row_gather_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ q,
                  uint4* __restrict__ out, long long n, long long n_rows, int c,
                  int loads_per_lane) {
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                                   // [S][kLanes]
  int32_t* qs = reinterpret_cast<int32_t*>(smem + S * kLanes);  // [rows_per_block]
  const int lane = threadIdx.x;
  const int rows_per_step = kLanes / c;
  const int rows_per_block = loads_per_lane * rows_per_step;
  const long long base = (long long)blockIdx.x * rows_per_block;
  for (int r = lane; r < rows_per_block; r += kLanes) {
    const long long row = base + r;
    qs[r] = row < n ? q[row] : -1;
  }
  __syncwarp();
  const int chunk = lane % c;
  const int sub = lane / c;

  auto issue = [&](int j) {
    const int r = j * rows_per_step + sub;
    uint4* slot = ring + (j % S) * kLanes + lane;
    if (base + r >= n) return;
    const long long idx = qs[r];
    if (idx < 0 || idx >= n_rows) {
      *slot = make_uint4(0u, 0u, 0u, 0u);
    } else {
      cp_async16(slot, table + idx * c + chunk);
    }
  };
  auto store = [&](int j) {
    const long long row = base + j * rows_per_step + sub;
    if (row < n) out[row * c + chunk] = ring[(j % S) * kLanes + lane];
  };

  for (int j = 0; j < loads_per_lane; ++j) {
    if (j >= S) {
      cp_async_wait<S - 1>();
      store(j - S);
    }
    issue(j);
    cp_async_commit();
  }
  cp_async_wait<0>();
  for (int j = loads_per_lane > S ? loads_per_lane - S : 0; j < loads_per_lane; ++j) store(j);
}

template <int S>
int launch(const void* table, const void* q, void* out, long long n, long long n_rows, int c,
           int loads_per_lane, cudaStream_t stream) {
  const int rows_per_block = loads_per_lane * (kLanes / c);
  const size_t smem = (size_t)S * kLanes * sizeof(uint4) + (size_t)rows_per_block * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_gather_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (n + rows_per_block - 1) / rows_per_block;
  row_gather_kernel<S><<<(unsigned)grid, kLanes, smem, stream>>>(
      (const uint4*)table, (const int32_t*)q, (uint4*)out, n, n_rows, c, loads_per_lane);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kuniq_row_gather(const void* table, const void* q, void* out, long long n,
                                long long n_rows, int row_words, int depth, int loads_per_lane,
                                void* stream) {
  const int c = row_words / 4;
  if (row_words % 4 || c < 1 || kLanes % c || loads_per_lane < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (depth) {
    case 1: return launch<1>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 2: return launch<2>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 4: return launch<4>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 8: return launch<8>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 16: return launch<16>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 32: return launch<32>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 64: return launch<64>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 128: return launch<128>(table, q, out, n, n_rows, c, loads_per_lane, s);
    case 256: return launch<256>(table, q, out, n, n_rows, c, loads_per_lane, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
