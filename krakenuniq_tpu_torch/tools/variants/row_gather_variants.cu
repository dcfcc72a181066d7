// Candidate designs of csrc/row_gather.cu that the kept kernel was chosen
// over, built beside it for tools/kernel_variants.py to time on the card.
// Each fetches out[i] = table[q[i]] (a zero row for an index outside
// [0, R)) with S copies in flight, on a persistent grid: the blocks one SM
// holds (the occupancy calculator's answer) times the SMs, walking the work
// grid-stride, so even one work unit's queries reach every SM. A row is
// c = row_words / 4 16-byte chunks and consecutive threads take consecutive
// chunks. Three forms, with the block size chosen by the caller:
//  * registers (S <= kRegMaxDepth): S 16-byte `ld.global.nc.L1::no_allocate`
//    loads in flight in a ring of registers, each stored straight out when
//    its turn comes; no shared memory at all.
//  * shared: the kept kernel's ring of S 16-byte cp.async copies per thread,
//    with the indices of the next S copies fetched by 4-byte cp.async into
//    a second ring, in blocks sized from S so that the rings take the SM's
//    shared memory.
//  * bulk: the closest form of the TPU's DMA-and-semaphore ring. One lane of
//    each warp issues one `cp.async.bulk` per row into a ring of S row slots,
//    each with its mbarrier, and sends each arrived row out with a bulk store
//    from shared memory; the warp's lanes fetch its indices 32 at a time.
// S is a template parameter: wait_group takes an immediate and the register
// ring needs compile-time slots.

#include "row_gather.cu"

namespace {

constexpr int kRegMaxDepth = 16;
constexpr int kRegThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 ld_row(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// ------------------------------------------------------------- registers

template <int S>
__global__ void __launch_bounds__(kRegThreads)
gather_regs_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ q, uint4* __restrict__ out,
                   long long units, long long n_rows, int lc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long u0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = (int)(u0 & ((1 << lc) - 1));  // the stride is a multiple of c
  auto index = [&](long long u) -> int32_t { return u < units ? __ldcs(q + (u >> lc)) : -1; };
  auto fetch = [&](int32_t idx) -> uint4 {
    return (idx >= 0 && idx < n_rows) ? ld_row(table + ((long long)idx << lc) + chunk) : make_uint4(0, 0, 0, 0);
  };
  int32_t idx[S];
  uint4 row[S];
#pragma unroll
  for (int s = 0; s < S; ++s) idx[s] = index(u0 + s * stride);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    row[s] = fetch(idx[s]);
    idx[s] = index(u0 + (S + s) * stride);
  }
  for (long long base = u0; base < units; base += S * stride) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long u = base + s * stride;
      if (u < units) __stcs(out + u, row[s]);
      row[s] = fetch(idx[s]);                  // the copy S turns ahead
      idx[s] = index(u + 2LL * S * stride);    // its index, one more ring ahead
    }
  }
}

// ---------------------------------------------------------------- shared

template <int S>
__global__ void __launch_bounds__(1024)
gather_smem_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ q, uint4* __restrict__ out,
                   long long units, long long n_rows, int lc) {
  extern __shared__ uint4 smem[];
  uint4* ring = smem + threadIdx.x;  // slot j at ring[j * blockDim.x]
  int32_t* qring = reinterpret_cast<int32_t*>(smem + S * blockDim.x) + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long u0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = (int)(u0 & ((1 << lc) - 1));
  const long long k_end = u0 < units ? (units - u0 + stride - 1) / stride : 0;  // this thread's copies
  auto fetch_index = [&](long long k) {
    if (k < k_end) cp_async4(qring + (k % S) * blockDim.x, q + ((u0 + k * stride) >> lc));
  };
  auto store = [&](long long k) { __stcs(out + u0 + k * stride, ring[(k % S) * blockDim.x]); };
  for (int k = 0; k < S; ++k) fetch_index(k);
  cp_async_commit();
  cp_async_wait<0>();
  for (long long k = 0; k < k_end; ++k) {
    if (k >= S) {
      cp_async_wait<S - 1>();  // copy k-S and the index of copy k have landed
      store(k - S);
    }
    const int32_t idx = qring[(k % S) * blockDim.x];
    uint4* slot = ring + (k % S) * blockDim.x;
    if (idx >= 0 && idx < n_rows) {
      cp_async16(slot, table + ((long long)idx << lc) + chunk);
    } else {
      *slot = make_uint4(0, 0, 0, 0);
    }
    fetch_index(k + S);
    cp_async_commit();
  }
  cp_async_wait<0>();
  for (long long k = k_end > S ? k_end - S : 0; k < k_end; ++k) store(k);
}

// ------------------------------------------------------------------ bulk

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// Wait for the phase of `parity` to complete; a copy that never lands traps
// (a launch error) instead of hanging the card.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int S>
__global__ void __launch_bounds__(1024)
gather_bulk_kernel(const unsigned char* __restrict__ table, const int32_t* __restrict__ q,
                   unsigned char* __restrict__ out, long long n, long long n_rows, int rb) {
  extern __shared__ __align__(16) unsigned char bulk_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned bars = smem_addr(bulk_smem) + (unsigned)(warp * S * 8);           // [warps][S] mbarriers
  const unsigned ring = smem_addr(bulk_smem) + (unsigned)(warps * S * 8 + warp * S * rb);  // [warps][S][rb]
  if (lane == 0) {
    for (int s = 0; s < S; ++s) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // this warp's rows: tiles of 32 consecutive rows, grid-stride over tiles
  const long long tiles = (n + 31) >> 5;
  const long long wstride = (long long)gridDim.x * warps;
  const long long w0 = (long long)blockIdx.x * warps + warp;
  const long long my_tiles = w0 < tiles ? (tiles - 1 - w0) / wstride + 1 : 0;
  const long long last = w0 + (my_tiles - 1) * wstride;  // this warp's last tile
  const long long k_end = my_tiles == 0 ? 0 : (my_tiles - 1) * 32 + min(32LL, n - last * 32);
  auto row_of = [&](long long k) { return (w0 + (k >> 5) * wstride) * 32 + (k & 31); };
  int32_t cur = 0, nxt = 0;  // lane i: the index of row 32 t + i of the current and next tile
  if (k_end > 0) cur = lane < k_end ? __ldcs(q + row_of(lane)) : -1;
  for (long long k = 0; k < k_end + S - 1; ++k) {
    if ((k & 31) == 0 && k < k_end) {
      const long long kn = k + 32 + lane;
      nxt = kn < k_end ? __ldcs(q + row_of(kn)) : -1;
    }
    const int32_t idx = __shfl_sync(kFull, cur, (int)(k & 31));
    if ((k & 31) == 31) cur = nxt;
    if (lane != 0) continue;
    const long long r = k - S + 1;  // the row this turn sends out
    if (r >= 0) {
      const int s = (int)(r % S);
      bar_wait(bars + 8 * s, (unsigned)((r / S) & 1));
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(out + row_of(r) * rb),
                   "r"(ring + s * rb), "r"(rb)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (k < k_end) {
      bulk_wait_read<1>();  // the store of row k-S, sent last turn, has read slot k % S
      const int s = (int)(k % S);
      const unsigned bar = bars + 8 * s, slot = ring + s * rb;
      if (idx >= 0 && idx < n_rows) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(rb) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(slot),
            "l"(table + (long long)idx * rb), "r"(rb), "r"(bar)
            : "memory");
      } else {
        for (int o = 0; o < rb; o += 16)
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(slot + o), "r"(0), "r"(0), "r"(0), "r"(0)
                       : "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
      }
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- launch

enum Form { kRegs = 0, kShared = 1, kBulk = 2 };

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Launch `kernel` on the persistent grid: the blocks of `threads` threads and
// `smem` bytes one SM holds, times the SMs, but no more blocks than `work`.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int threads, size_t smem, long long work, cudaStream_t stream,
                      Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * sm_count();
  if (grid > work) grid = work;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int S>
int launch_variant(int form, int threads, const void* table, const void* q, void* out, long long n,
                   long long n_rows, int c, cudaStream_t stream) {
  int lc = 0;
  while ((1 << lc) < c) ++lc;
  const long long units = n * c;
  if (form == kRegs) {
    if constexpr (S <= kRegMaxDepth) {
      if (threads != kRegThreads) return (int)cudaErrorInvalidValue;
      return launch_persistent(gather_regs_kernel<S>, threads, 0, (units + threads - 1) / threads, stream,
                               (const uint4*)table, (const int32_t*)q, (uint4*)out, units, n_rows, lc);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (form == kShared) {
    const size_t smem = (size_t)S * threads * (sizeof(uint4) + sizeof(int32_t));
    return launch_persistent(gather_smem_kernel<S>, threads, smem, (units + threads - 1) / threads, stream,
                             (const uint4*)table, (const int32_t*)q, (uint4*)out, units, n_rows, lc);
  }
  if (form == kBulk) {
    if constexpr (S >= 2) {
      const int rb = 16 * c;
      const size_t smem = (size_t)S * (threads / 32) * (8 + rb);
      const long long tiles = (n + 31) / 32;
      return launch_persistent(gather_bulk_kernel<S>, threads, smem, (tiles + threads / 32 - 1) / (threads / 32),
                               stream, (const unsigned char*)table, (const int32_t*)q, (unsigned char*)out, n,
                               n_rows, rb);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// form: 0 registers (depth <= 16, 256 threads), 1 shared, 2 bulk (depth >=
// 2); threads: the block size (a multiple of 32, at most 1024). Otherwise the
// arguments of kuniq_row_gather.
extern "C" int kuniq_row_gather_variant(const void* table, const void* q, void* out, long long n, long long n_rows,
                                        int row_words, int depth, int form, int threads, void* stream) {
  const int c = row_words / 4;
  if (row_words % 4 || c < 1 || 32 % c || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (depth) {
    case 1: return launch_variant<1>(form, threads, table, q, out, n, n_rows, c, s);
    case 2: return launch_variant<2>(form, threads, table, q, out, n, n_rows, c, s);
    case 4: return launch_variant<4>(form, threads, table, q, out, n, n_rows, c, s);
    case 8: return launch_variant<8>(form, threads, table, q, out, n, n_rows, c, s);
    case 16: return launch_variant<16>(form, threads, table, q, out, n, n_rows, c, s);
    case 32: return launch_variant<32>(form, threads, table, q, out, n, n_rows, c, s);
    case 64: return launch_variant<64>(form, threads, table, q, out, n, n_rows, c, s);
    case 128: return launch_variant<128>(form, threads, table, q, out, n, n_rows, c, s);
    case 256: return launch_variant<256>(form, threads, table, q, out, n, n_rows, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
