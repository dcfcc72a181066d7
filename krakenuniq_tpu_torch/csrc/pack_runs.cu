// RLE rows of the span step: per read, the run-length encoding of its
// per-k-mer code packed into one row of u32 words, so that the host fetches
// one small row per read instead of the [B, W] planes; optionally fused
// with the step's u16 HLL feed over the same planes.
//
// Replaces: _pack_runs, krakenuniq_tpu/classify/device_step.py:408-490,
// which the JAX package left to XLA (a cumsum of the change flags and masked
// reductions over R run slots), and the feed's jnp.where at :389-391. Per
// read b and k-mer lane l < n_kmers[b]:
//   code(l) = -1 if kmer_ambig[b, l], else ids[b, l] (as u32)
// a run is a maximal stretch of equal codes; run j's fields are its length
// (< 2^15), its ambiguity (constant within a run) and the largest id of its
// lanes (every lane of an unambiguous run has the same id). Row layouts:
//   compact (layout 0): R words id<<16 | amb<<15 | len, then
//                       call<<16 | n_runs
//   dense   (layout 1): R such words, then call, then hits<<16 | n_runs
//   wide    (layout 2): R ids (through `map` when given), R/2 words of two
//                       16-bit len | amb<<15 (even run low), then call,
//                       n_kmers, hits<<16 | n_runs
// Slots past the read's runs are zero (id 0, mapped in the wide layout).
// n_runs counts every run, also those past R: the host re-fetches such
// rows from the planes. The fused feed (hll16 given): lane l of read b is
// ids[b, l] & 0xFFFF where l < hll_stop[b] and the lane is not ambiguous,
// else 0xFFFF, every lane of the [B, W] plane (padding lanes included).
//
// Bound on the H100: bytes (an id and a flag per valid lane in, a row of
// R + 1 to R + R/2 + 3 words per read out, and 2 B per lane of the feed);
// the work per lane is a compare and a few selects, far below the integer
// rate. What binds the kernel is instruction issue, not memory: a ring of
// bulk copies alone streams the planes in well under the walk's time, and
// the first design's walk (one warp a read, a ballot per 32 lanes) is a
// chain of dependent instructions every 32 lanes.
//
// Design: a persistent grid (the blocks the SM holds, times the SMs) walks
// tiles of kTile = 16 consecutive reads. A tile's ids, flags, n_kmers, call,
// hits and hll_stop are each one contiguous range, 16-byte aligned for any W
// when the base pointers are, so a producer warp brings the whole tile into
// shared memory with up to six 1-D bulk copies (cp.async.bulk) completing on
// the stage's `full` mbarrier, in a ring of kStages stages; it refills a
// stage once the stage's `empty` mbarrier has all kConsumers consumer warps'
// arrivals. No block barrier ties one consumer warp to another: a warp with
// short reads runs ahead by up to the ring's depth. Each consumer warp walks
// its reads of the tile (r, r + kConsumers, ...), one step of 32 kLanes =
// 160 lanes for the span's W = 130: (1) each thread loads its kLanes
// consecutive lanes from the stage (kLanes odd: a warp's loads hit 32 banks)
// and compares each code with the lane before (a register; the stage's copy
// for its first lane), one bit of `starts` per run start; (2) an inclusive
// warp scan of the threads' start counts gives each thread the runs started
// before its lanes, so a lane's run index is a running sum; (3) the lane
// that starts run j <= R writes the run's start (and, j < R, its ambiguity
// and id) to the warp's slots, and an ambiguous lane folds its id into its
// run's slot with a shared atomicMax. Run j's length is start[j + 1] -
// start[j] (n_kmers for the last run); n_runs counts every run. Lanes j < R
// then write the row straight to global memory. With the feed, the step
// covers all W lanes, each lane's feed word goes over its id in the stage,
// and the warp copies the read's feed row out (two lanes a 4-byte store when
// W is even). R = 8, the span route's, is a compile-time constant (the
// slots' offsets become immediates); other R take the same code with R read
// at run time. A base pointer off the 16-byte grid (a row-sliced view) or a
// W too long for two stages takes the same walk with plain loads from global
// memory, as does the ragged last tile.
//
// Tried and not kept (tools/variants/pack_runs_variants.cu, timed by
// tools/kernel_variants.py, except where noted): one warp per read with
// plain coalesced loads from global memory (the first design); the ballot
// walk of the first design on this ring (32 lanes a step, the next step's
// loads issued before the ballot); a thread per read on the ring (each
// thread walks its read lane by lane: one serial chain a thread, and
// shared memory holds a few warps an SM); this walk with plain loads
// instead of the ring, and other tile sizes and ring depths. Chosen by
// compiling this file with other constants (not kept): 3 lanes a thread,
// blocks of 4 consumer warps, and register caps of 40 and 56 (spills) or
// none (96-104 registers, fewer warps).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumers = 8;            // warps that walk reads; one more issues the copies
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kMinBlocks = 3;            // blocks an SM: 27 warps, at most 72 registers a thread
constexpr int kStages = 3;               // depth of the ring of staged tiles
constexpr int kTile = 16;                // reads a tile: two a consumer warp
constexpr int kMaxStages = 8;
constexpr int kLanes = 5;                // consecutive lanes a thread a step (odd: no bank conflicts)
constexpr int kBarBytes = 16 * kMaxStages;  // the ring's full and empty mbarriers lead the layout
constexpr int kSmemOptIn = 232448;       // shared memory a block may opt into
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* ids;
  const uint8_t* amb;
  const int32_t* n_kmers;
  const int32_t* call;
  const int32_t* hits;
  const int32_t* map;
  int n_map;
  uint32_t* out;
  uint16_t* hll;          // NULL: no feed
  const int32_t* hll_stop;
  int B, W, R, layout, cols;
  int tile;               // reads a tile
  int stages;             // ring depth; 0: plain loads throughout
  int stage_bytes;
};

// A tile's inputs, in a ring stage (shared memory) or in global memory.
struct Tile {
  const int32_t* ids;
  const uint8_t* amb;
  const int32_t* nk;
  const int32_t* call;
  const int32_t* hits;
  const int32_t* stop;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A stage: ids (tile * W words), flags (tile * W bytes), then n_kmers,
// call, hits and hll_stop (tile words each); every section 16-byte aligned.
int stage_size(int tile, int W) { return tile * W * 5 + 16 * tile; }

__device__ __forceinline__ Tile staged_tile(const Params& p, const unsigned char* st) {
  const int lanes = p.tile * p.W;
  const int32_t* meta = reinterpret_cast<const int32_t*>(st + 5 * lanes);
  return {reinterpret_cast<const int32_t*>(st), st + 4 * lanes, meta, meta + p.tile, meta + 2 * p.tile,
          meta + 3 * p.tile};
}

__device__ __forceinline__ Tile global_tile(const Params& p, long long b0) {
  return {p.ids + b0 * p.W, p.amb + b0 * p.W, p.n_kmers + b0, p.call + b0, p.hits + b0, p.hll_stop + b0};
}

// One thread: the stage's expected bytes, then one bulk copy per section.
__device__ __forceinline__ void issue_tile(const Params& p, unsigned char* st, uint64_t* bar, long long t) {
  const long long b0 = t * p.tile;
  const uint32_t lanes = p.tile * p.W, nb = 4 * p.tile;
  const int n_meta = p.hll != nullptr ? 4 : 3;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(5 * lanes + n_meta * nb)
               : "memory");
  bulk_load(st, p.ids + b0 * p.W, 4 * lanes, bar);
  bulk_load(st + 4 * lanes, p.amb + b0 * p.W, lanes, bar);
  unsigned char* meta = st + 5 * lanes;
  bulk_load(meta, p.n_kmers + b0, nb, bar);
  bulk_load(meta + nb, p.call + b0, nb, bar);
  bulk_load(meta + 2 * nb, p.hits + b0, nb, bar);
  if (p.hll != nullptr) bulk_load(meta + 3 * nb, p.hll_stop + b0, nb, bar);
}

struct Run {
  uint32_t id, amb, len;
};

__device__ __forceinline__ Run slot(const int* start, const uint32_t* idmax, const int* ambf, int j,
                                    int n_runs, int nk) {
  if (j >= n_runs) return {0u, 0u, 0u};
  const int e = j + 1 < n_runs ? start[j + 1] : nk;
  return {idmax[j], (uint32_t)ambf[j], (uint32_t)(e - start[j])};
}

// One read, by one warp: each thread takes kLanes consecutive lanes a
// step (32 kLanes = 160 lanes: one step for W up to 160) and writes the
// row to `row` (global memory). A step: (1) the thread loads its lanes and
// compares each code with the lane before (a register; the shared or
// global copy for its first lane), a bit of `starts` per run start; (2) an
// inclusive warp scan of the threads' start counts gives each thread the
// runs started before its lanes; (3) the lane that starts run j <= R
// writes the run's start (and, j < R, its ambiguity and id) to the warp's
// slots, and an ambiguous lane folds its id into its run's slot with a
// shared atomicMax. With the feed the step covers all W lanes and each
// lane's feed word goes over its id in the stage (staged; the warp then
// copies the read's feed row out, 2 lanes a 4-byte store) or straight to
// the global plane (plain loads). The warp's slots: R + 1 run starts, R
// ids, R flags.
template <bool kStaged, int kR>
__device__ __forceinline__ void pack_read(const Params& p, int32_t* idr, const uint8_t* ar, int nk_raw,
                                          uint32_t call, uint32_t hits, int stop, uint16_t* feed, int* start,
                                          uint32_t* row, int lane) {
  const int R = kR > 0 ? kR : p.R, W = p.W;
  uint32_t* idmax = reinterpret_cast<uint32_t*>(start + R + 1);
  int* ambf = start + 2 * R + 1;
  for (int j = lane; j < R; j += 32) {
    idmax[j] = 0u;
    ambf[j] = 0;
  }
  __syncwarp();
  const int nk = min(max(nk_raw, 0), W);
  // lanes read: the valid ones, and with the feed those below hll_stop
  const int lim = feed != nullptr ? min(max(nk, stop), W) : nk;
  const int end = feed != nullptr ? W : nk;
  int count = 0;  // runs started before this step
  int carry_a = 0;  // the code of the previous step's last lane (its id may
  uint32_t carry_id = 0u;  // be under a feed word by now)
  for (int base = 0; base < end; base += 32 * kLanes) {
    const int q0 = base + kLanes * lane;
    int a[kLanes];
    uint32_t id[kLanes];
    int pa = carry_a;
    uint32_t pid = carry_id;
    if (lane > 0 && q0 < nk) {
      pa = ar[q0 - 1] != 0;
      pid = (uint32_t)idr[q0 - 1];
    }
    unsigned starts = 0u;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int q = q0 + j;
      a[j] = 0;
      id[j] = 0u;
      if (q < lim) {
        a[j] = ar[q] != 0;
        id[j] = (uint32_t)idr[q];
      }
      if (q < nk && (q == 0 || a[j] != pa || (!a[j] && id[j] != pid))) starts |= 1u << j;
      pa = a[j];
      pid = id[j];
    }
    carry_a = __shfl_sync(kFull, pa, 31);
    carry_id = __shfl_sync(kFull, pid, 31);
    const int mine = __popc(starts);
    int upto = mine;  // inclusive scan of the start counts over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, upto, d);
      if (lane >= d) upto += y;
    }
    int rid = count + upto - mine - 1;  // the run of the lane before this thread's first
    count += __shfl_sync(kFull, upto, 31);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int q = q0 + j;
      const bool change = (starts >> j) & 1u;
      rid += change;
      const bool first = change && rid < R;
      if (change && rid <= R) start[rid] = q;
      if (first) ambf[rid] = a[j];
      if (first && !a[j]) idmax[rid] = id[j];
      if (a[j] && q < nk && rid < R) atomicMax(&idmax[rid], id[j]);
      if (feed != nullptr && q < W) {
        const uint32_t f = (q < stop && !a[j]) ? (id[j] & 0xFFFFu) : 0xFFFFu;
        if (kStaged) {
          idr[q] = (int32_t)f;
        } else {
          feed[q] = (uint16_t)f;
        }
      }
    }
  }
  __syncwarp();
  if (kStaged && feed != nullptr) {
    // the feed words of the read, from the stage: a 4-byte store of two
    // lanes when the row starts on a 4-byte boundary (W even), else 2 bytes
    if ((W & 1) == 0) {
      for (int i = lane; 2 * i < W; i += 32)
        reinterpret_cast<uint32_t*>(feed)[i] = (uint32_t)idr[2 * i] | ((uint32_t)idr[2 * i + 1] << 16);
    } else {
      for (int q = lane; q < W; q += 32) feed[q] = (uint16_t)idr[q];
    }
  }

  const int n_runs = count;
  if (p.layout != 2) {
    for (int j = lane; j < R; j += 32) {
      const Run r = slot(start, idmax, ambf, j, n_runs, nk);
      row[j] = (r.id << 16) | (r.amb << 15) | r.len;
    }
    if (lane == 0) {
      if (p.layout == 0) {
        row[R] = (call << 16) | (uint32_t)n_runs;
      } else {
        row[R] = call;
        row[R + 1] = (hits << 16) | (uint32_t)n_runs;
      }
    }
  } else {
    for (int j = lane; j < R; j += 32) {
      const uint32_t id = slot(start, idmax, ambf, j, n_runs, nk).id;
      row[j] = p.map == nullptr ? id : ((long long)id < p.n_map ? (uint32_t)p.map[id] : 0u);
    }
    for (int j = lane; j < R / 2; j += 32) {
      const Run r0 = slot(start, idmax, ambf, 2 * j, n_runs, nk);
      const Run r1 = slot(start, idmax, ambf, 2 * j + 1, n_runs, nk);
      row[R + j] = (r0.len | (r0.amb << 15)) | ((r1.len | (r1.amb << 15)) << 16);
    }
    if (lane == 0) {
      row[R + R / 2] = call;
      row[R + R / 2 + 1] = (uint32_t)nk_raw;
      row[R + R / 2 + 2] = (hits << 16) | (uint32_t)n_runs;
    }
  }
  __syncwarp();  // the row read the slots; the warp's next read clears them
}

// The tile's nr reads: consumer warp w walks reads w, w + kConsumers, ...
// (staged: the tile's ids are the stage's, written over by the feed)
template <bool kStaged, int kR>
__device__ __forceinline__ void pack_tile(const Params& p, const Tile& t, long long b0, int nr, int* start,
                                          int warp, int lane) {
  for (int r = warp; r < nr; r += kConsumers) {
    const long long b = b0 + r;
    uint16_t* feed = p.hll != nullptr ? p.hll + b * p.W : nullptr;
    pack_read<kStaged, kR>(p, const_cast<int32_t*>(t.ids) + r * p.W, t.amb + r * p.W, t.nk[r],
                       (uint32_t)t.call[r], (uint32_t)t.hits[r], p.hll != nullptr ? t.stop[r] : 0, feed, start,
                       p.out + b * p.cols, lane);
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// One producer warp (the last) keeps the ring full: one thread waits for a
// stage's `empty` barrier (every consumer warp done with it) and issues the
// next tile's bulk copies into it, completing on its `full` barrier. The
// consumer warps wait for `full`, walk their reads of the tile and arrive
// on `empty`; no barrier ties one consumer warp to another, so a warp with
// short reads runs ahead by up to the ring's depth.
// kR: the run slots, 0 for p.R (a compile-time 8 for the span route's rows)
template <int kR>
__global__ void __launch_bounds__(kThreads, kMinBlocks) pack_runs_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + kBarBytes;
  int* slots = reinterpret_cast<int*>(ring + (size_t)p.stages * p.stage_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_tiles = (p.B + p.tile - 1) / p.tile;
  const long long n_full = p.stages > 0 ? p.B / p.tile : 0;  // the tiles that come by bulk copy
  const long long first = blockIdx.x, step = gridDim.x;
  const int m = first < n_full ? (int)((n_full - 1 - first) / step + 1) : 0;

  if (m > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < p.stages; ++s) {
        bar_init(&full[s], 1);
        bar_init(&empty[s], kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  if (warp == kConsumers) {
    if (lane == 0) {
      for (int i = 0; i < m; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages) bar_wait(&empty[s], (uint32_t)(i / p.stages - 1) & 1u);
        issue_tile(p, ring + (size_t)s * p.stage_bytes, &full[s], first + i * step);
      }
    }
    return;
  }
  int* start = slots + warp * (3 * p.R + 1);
  for (int i = 0; i < m; ++i) {
    const int s = i % p.stages;
    unsigned char* st = ring + (size_t)s * p.stage_bytes;
    bar_wait(&full[s], (uint32_t)(i / p.stages) & 1u);
    pack_tile<true, kR>(p, staged_tile(p, st), (first + i * step) * p.tile, p.tile, start, warp, lane);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
  // the ragged last tile, or every tile of a launch without the ring
  for (long long t = first + (long long)m * step; t < n_tiles; t += step) {
    const long long b0 = t * p.tile;
    pack_tile<false, kR>(p, global_tile(p, b0), b0, (int)min((long long)p.tile, p.B - b0), start, warp, lane);
  }
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15u) == 0; }

// The current device's SM count, and the kernel's resident blocks an SM
// (the occupancy calculator's answer) at a block size and shared memory,
// each cached: the launch path queries them once per device and plan.
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

template <int kR>
cudaError_t blocks_per_sm(size_t smem, int* per_sm) {
  static size_t last_smem = 0;
  static int last = 0;
  if (smem == last_smem && last > 0) {
    *per_sm = last;
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pack_runs_kernel<kR>, kThreads, smem);
  if (err == cudaSuccess) {
    last_smem = smem;
    last = *per_sm;
  }
  return err;
}

template <int kR>
int launch_r(const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(pack_runs_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess || (err = blocks_per_sm<kR>(smem, &per_sm)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (p.B + p.tile - 1) / p.tile;
  const int grid = (int)std::min(n_tiles, (long long)per_sm * sms);
  pack_runs_kernel<kR><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch with `tile` reads a tile (each stage section 16-byte aligned: a
// multiple of 4 with tile * W a multiple of 16) and a ring of `stages` (0:
// plain loads; fewer when shared memory cannot hold them, none when it
// cannot hold two or an input is off the 16-byte grid).
int launch_pack_runs(Params p, int tile, int stages, cudaStream_t stream) {
  const bool aligned = aligned16(p.ids) && aligned16(p.amb) && aligned16(p.n_kmers) &&
                       aligned16(p.call) && aligned16(p.hits) && aligned16(p.hll_stop);
  if (tile <= 0 || tile % 4 != 0 || (long long)tile * p.W % 16 != 0 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  p.tile = tile;
  p.stage_bytes = stage_size(tile, p.W);
  const size_t fixed = kBarBytes + sizeof(uint32_t) * (size_t)kConsumers * (3 * p.R + 1);
  p.stages = aligned ? stages : 0;
  while (p.stages >= 2 && fixed + (size_t)p.stages * p.stage_bytes > (size_t)kSmemOptIn) --p.stages;
  if (p.stages < 2) p.stages = 0;
  const size_t smem = fixed + (size_t)p.stages * p.stage_bytes;
  if (smem > (size_t)kSmemOptIn) return (int)cudaErrorInvalidValue;
  return p.R == 8 ? launch_r<8>(p, smem, stream) : launch_r<0>(p, smem, stream);
}

Params make_params(const void* ids, const void* amb, const void* n_kmers, const void* call, const void* hits,
                   const void* map, int n_map, void* out, void* hll16, const void* hll_stop, int B, int W,
                   int R, int layout, int cols) {
  Params p{};
  p.ids = (const int32_t*)ids;
  p.amb = (const uint8_t*)amb;
  p.n_kmers = (const int32_t*)n_kmers;
  p.call = (const int32_t*)call;
  p.hits = (const int32_t*)hits;
  p.map = (const int32_t*)map;
  p.n_map = n_map;
  p.out = (uint32_t*)out;
  p.hll = (uint16_t*)hll16;
  p.hll_stop = (const int32_t*)(hll_stop != nullptr ? hll_stop : n_kmers);
  p.B = B;
  p.W = W;
  p.R = R;
  p.layout = layout;
  p.cols = cols;
  return p;
}

bool bad_shape(int B, int W, int R, int layout) {
  return B < 0 || R <= 0 || R % 2 != 0 || W <= 0 || W >= (1 << 15) || layout < 0 || layout > 2;
}

}  // namespace

// ids: int32 [B, W]; amb: bool [B, W]; n_kmers, call, hits: int32 [B];
// map: int32 [n_map] or NULL; out: int32 [B, cols] with cols = R + 1
// (layout 0), R + 2 (1) or R + R/2 + 3 (2); hll16: int16 [B, W] or NULL
// (no feed); hll_stop: int32 [B] or NULL (n_kmers). R even and > 0,
// W < 2^15.
extern "C" int kuniq_pack_runs(const void* ids, const void* amb, const void* n_kmers, const void* call,
                               const void* hits, const void* map, int n_map, void* out, void* hll16,
                               const void* hll_stop, int B, int W, int R, int layout, int cols,
                               void* stream) {
  if (bad_shape(B, W, R, layout)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const Params p = make_params(ids, amb, n_kmers, call, hits, map, n_map, out, hll16, hll_stop, B, W, R,
                               layout, cols);
  return launch_pack_runs(p, kTile, kStages, (cudaStream_t)stream);
}
