// Candidate designs of csrc/pack_runs.cu that the kept kernel was chosen
// over, built beside it for tools/kernel_variants.py to time on the card.
// Each writes exactly the kept kernel's rows (the unfused form):
//  * warp per read (form 0): the first design. One warp a read in blocks of
//    8 reads, each step of 32 lanes one coalesced 128-byte id load and one
//    32-byte flag load straight from global memory, the previous lane's code
//    taken by a shuffle and carried from step to step, the row stored by
//    lanes 0 to R of the warp. Its loads are issued one step at a time.
//  * the kept tile loop (form 1) with another tile size and ring depth
//    (stages 0: plain loads from global memory, no ring).
//  * the first design's ballot walk on the kept kernel's ring (form 3: the
//    producer warp, full and empty mbarriers, tiles of `tile` reads): a
//    consumer warp walks a read 32 lanes a step, each lane's code compared
//    with the lane before (both from the stage), run starts from a ballot
//    and run indices from prefix popcounts, the next step's loads issued
//    before the ballot; rows straight to global memory.
//  * a thread per read on the same ring of staged tiles (form 2; `tile`
//    reads = the block's threads, 32 to 128): each thread walks its read
//    lane by lane from shared memory, the run index, the run's largest id
//    and the previous code in registers, no ballot; the feed words go over
//    the ids in the stage and out with 16-byte stores. Its lanes are one
//    serial chain a thread and shared memory holds a few warps an SM.

#include "pack_runs.cu"

namespace {

constexpr int kWarpReads = 8;  // the first design: reads (warps) a block

__global__ void __launch_bounds__(kWarpReads * 32)
pack_runs_warp_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ amb,
                 const int32_t* __restrict__ n_kmers, const int32_t* __restrict__ call,
                 const int32_t* __restrict__ hits, const int32_t* __restrict__ map, int n_map,
                 uint32_t* __restrict__ out, int B, int W, int R, int layout, int cols) {
  extern __shared__ int warp_slots[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarpReads + warp;
  if (b >= B) return;
  int* start = warp_slots + warp * (3 * R + 1);  // R + 1 run starts
  uint32_t* idmax = reinterpret_cast<uint32_t*>(start + R + 1);  // R ids
  int* ambf = start + 2 * R + 1;                                 // R flags
  for (int j = lane; j < R; j += 32) {
    idmax[j] = 0u;
    ambf[j] = 0;
  }
  __syncwarp();

  const int nk = min(max(n_kmers[b], 0), W);
  const int32_t* idr = ids + b * W;
  const uint8_t* ar = amb + b * W;
  int count = 0;  // runs started before this step
  int prev_a = 0;
  uint32_t prev_id = 0u;
  for (int base = 0; base < nk; base += 32) {
    const int p = base + lane;
    const bool v = p < nk;
    const int a = v ? (ar[p] != 0) : 0;
    const uint32_t id = v ? (uint32_t)idr[p] : 0u;
    int pa = __shfl_up_sync(0xffffffffu, a, 1);
    uint32_t pid = __shfl_up_sync(0xffffffffu, id, 1);
    if (lane == 0) {
      pa = prev_a;
      pid = prev_id;
    }
    const bool change = v && (p == 0 || a != pa || (!a && id != pid));
    const unsigned starts = __ballot_sync(0xffffffffu, change);
    const int rid = count + __popc(starts & (0xffffffffu >> (31 - lane))) - 1;
    if (change && rid <= R) start[rid] = p;
    if (change && rid < R) {
      ambf[rid] = a;
      if (!a) idmax[rid] = id;
    }
    if (v && a && rid < R) atomicMax(&idmax[rid], id);
    count += __popc(starts);
    prev_a = __shfl_sync(0xffffffffu, a, 31);
    prev_id = __shfl_sync(0xffffffffu, id, 31);
  }
  __syncwarp();

  const int n_runs = count;
  uint32_t* row = out + b * cols;
  if (layout != 2) {
    for (int j = lane; j < R; j += 32) {
      const Run r = slot(start, idmax, ambf, j, n_runs, nk);
      row[j] = (r.id << 16) | (r.amb << 15) | r.len;
    }
    if (lane == 0) {
      if (layout == 0) {
        row[R] = ((uint32_t)call[b] << 16) | (uint32_t)n_runs;
      } else {
        row[R] = (uint32_t)call[b];
        row[R + 1] = ((uint32_t)hits[b] << 16) | (uint32_t)n_runs;
      }
    }
    return;
  }
  for (int j = lane; j < R; j += 32) {
    const uint32_t id = slot(start, idmax, ambf, j, n_runs, nk).id;
    row[j] = map == nullptr ? id : ((long long)id < n_map ? (uint32_t)map[id] : 0u);
  }
  for (int j = lane; j < R / 2; j += 32) {
    const Run r0 = slot(start, idmax, ambf, 2 * j, n_runs, nk);
    const Run r1 = slot(start, idmax, ambf, 2 * j + 1, n_runs, nk);
    row[R + j] = (r0.len | (r0.amb << 15)) | ((r1.len | (r1.amb << 15)) << 16);
  }
  if (lane == 0) {
    row[R + R / 2] = (uint32_t)call[b];
    row[R + R / 2 + 1] = (uint32_t)n_kmers[b];
    row[R + R / 2 + 2] = ((uint32_t)hits[b] << 16) | (uint32_t)n_runs;
  }
}

namespace thread_walk {

// A thread's run slots, strided by the block's threads (no bank conflicts):
// R + 1 run starts, R largest ids, R ambiguity flags.
struct Slots {
  int* base;
  int nt, R;
  __device__ __forceinline__ int& start(int j) const { return base[j * nt]; }
  __device__ __forceinline__ int& idmax(int j) const { return base[(R + 1 + j) * nt]; }
  __device__ __forceinline__ int& ambf(int j) const { return base[(2 * R + 1 + j) * nt]; }
};

// One read, by one thread: walk lanes [0, q_end) of its ids and flags
// (shared or global memory) and write its row to `row` (shared memory).
// With the feed, each lane below W gets its feed word: staged, over the
// lane's id in the stage (as a u32, through idr itself, so the compiler
// sees that a store does not alias the next lanes' loads); else in the
// global plane (feed).
template <bool kStaged>
__device__ __forceinline__ void thread_read(const Params& p, int32_t* idr, const uint8_t* ar, int nk_raw,
                                          uint32_t call, uint32_t hits, int stop, bool with_feed,
                                          uint16_t* feed, int q_end, const Slots& s, uint32_t* row) {
  const int R = p.R, W = p.W;
  const int nk = min(max(nk_raw, 0), W);
  // lanes read: the valid ones, and with the feed those below hll_stop
  const int lim = with_feed ? min(max(nk, stop), W) : nk;
  int rid = -1;            // index of the run the lane belongs to
  uint32_t runmax = 0u;    // the largest id of that run so far
  int pa = 0;
  uint32_t pid = 0u;
#pragma unroll 4
  for (int q = 0; q < q_end; ++q) {
    int a = 0;
    uint32_t id = 0u;
    if (q < lim) {
      a = ar[q] != 0;
      id = (uint32_t)idr[q];
    }
    const bool v = q < nk;
    if (v && (q == 0 || a != pa || (!a && id != pid))) {
      if (rid >= 0 && rid < R) s.idmax(rid) = (int)runmax;
      ++rid;
      if (rid <= R) s.start(rid) = q;
      if (rid < R) s.ambf(rid) = a;
      runmax = id;
    } else if (v) {
      runmax = max(runmax, id);
    }
    pa = a;
    pid = id;
    if (with_feed && q < W) {
      const uint32_t f = (q < stop && !a) ? (id & 0xFFFFu) : 0xFFFFu;
      if (kStaged) {
        idr[q] = (int32_t)f;
      } else {
        feed[q] = (uint16_t)f;
      }
    }
  }
  if (rid >= 0 && rid < R) s.idmax(rid) = (int)runmax;

  const int n_runs = rid + 1;
  auto len = [&](int j) -> uint32_t {
    return (uint32_t)((j + 1 < n_runs ? s.start(j + 1) : nk) - s.start(j));
  };
  if (p.layout != 2) {
    for (int j = 0; j < R; ++j)
      row[j] = j < n_runs ? ((uint32_t)s.idmax(j) << 16) | ((uint32_t)s.ambf(j) << 15) | len(j) : 0u;
    if (p.layout == 0) {
      row[R] = (call << 16) | (uint32_t)n_runs;
    } else {
      row[R] = call;
      row[R + 1] = (hits << 16) | (uint32_t)n_runs;
    }
    return;
  }
  for (int j = 0; j < R; ++j) {
    const uint32_t id = j < n_runs ? (uint32_t)s.idmax(j) : 0u;
    row[j] = p.map == nullptr ? id : ((long long)id < p.n_map ? (uint32_t)p.map[id] : 0u);
  }
  for (int j = 0; j < R / 2; ++j) {
    uint32_t w = 0u;
    for (int h = 0; h < 2; ++h) {
      const int jj = 2 * j + h;
      if (jj < n_runs) w |= (len(jj) | ((uint32_t)s.ambf(jj) << 15)) << (16 * h);
    }
    row[R + j] = w;
  }
  row[R + R / 2] = call;
  row[R + R / 2 + 1] = (uint32_t)nk_raw;
  row[R + R / 2 + 2] = (hits << 16) | (uint32_t)n_runs;
}

// The tile's nr reads: thread t walks read t. Every thread of a warp walks
// the same lanes (all W with the feed, else its warp's longest read); a
// thread past nr walks none.
template <bool kStaged>
__device__ __forceinline__ void thread_tile(const Params& p, const Tile& t, long long b0, int nr,
                                          uint32_t* rows, int* slots) {
  const int r = threadIdx.x;
  const bool on = r < nr;
  const int nk = on ? t.nk[r] : 0;
  const int stop = on && p.hll != nullptr ? t.stop[r] : 0;
  int q_end = p.W;
  if (p.hll == nullptr) q_end = (int)__reduce_max_sync(0xffffffffu, (unsigned)min(max(nk, 0), p.W));
  if (!on) return;
  const Slots s{slots + r, p.tile, p.R};
  uint16_t* feed = !kStaged && p.hll != nullptr ? p.hll + (b0 + r) * p.W : nullptr;
  // staged: the tile's ids are the stage's, written over by the feed
  int32_t* idr = const_cast<int32_t*>(t.ids) + (long long)r * p.W;
  thread_read<kStaged>(p, idr, t.amb + (long long)r * p.W, nk, (uint32_t)t.call[r], (uint32_t)t.hits[r],
                     stop, p.hll != nullptr, feed, q_end, s, rows + r * p.cols);
}

// The tile's rows, one contiguous range from a 16-byte-aligned start.
__device__ __forceinline__ void thread_rows(const Params& p, const uint32_t* rows, long long b0, int nr) {
  const int nw = nr * p.cols, nv = nw >> 2;
  uint32_t* dst = p.out + b0 * p.cols;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(rows)[i];
  for (int i = 4 * nv + threadIdx.x; i < nw; i += blockDim.x) dst[i] = rows[i];
}

// A full staged tile's feed words (u32 in the stage) to the u16 plane,
// 8 lanes a thread: two 16-byte shared loads, one 16-byte store.
__device__ __forceinline__ void thread_feed(const Params& p, const unsigned char* stage, long long b0) {
  const uint4* src = reinterpret_cast<const uint4*>(stage);
  uint4* dst = reinterpret_cast<uint4*>(p.hll + b0 * p.W);
  const int n8 = p.tile * p.W / 8;
  for (int i = threadIdx.x; i < n8; i += blockDim.x) {
    const uint4 lo = src[2 * i], hi = src[2 * i + 1];
    dst[i] = make_uint4(lo.x | (lo.y << 16), lo.z | (lo.w << 16), hi.x | (hi.y << 16), hi.z | (hi.w << 16));
  }
}

__global__ void __launch_bounds__(128) pack_runs_thread_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  uint32_t* rows = reinterpret_cast<uint32_t*>(ring + (size_t)p.stages * p.stage_bytes);
  int* slots = reinterpret_cast<int*>(rows + p.tile * p.cols);
  const long long n_tiles = (p.B + p.tile - 1) / p.tile;
  const long long n_full = p.stages > 0 ? p.B / p.tile : 0;  // the tiles that come by bulk copy
  const long long first = blockIdx.x, step = gridDim.x;
  const int m = first < n_full ? (int)((n_full - 1 - first) / step + 1) : 0;

  if (m > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < p.stages; ++s) bar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int i = 0; i < min(m, p.stages); ++i)
        issue_tile(p, ring + (size_t)i * p.stage_bytes, &bars[i], first + i * step);
    }
    __syncthreads();
  }
  for (int i = 0; i < m; ++i) {
    const int s = i % p.stages;
    unsigned char* st = ring + (size_t)s * p.stage_bytes;
    bar_wait(&bars[s], (uint32_t)(i / p.stages) & 1u);
    const long long b0 = (first + i * step) * p.tile;
    thread_tile<true>(p, staged_tile(p, st), b0, p.tile, rows, slots);
    __syncthreads();  // the rows and the feed words are written
    thread_rows(p, rows, b0, p.tile);
    if (p.hll != nullptr) thread_feed(p, st, b0);
    __syncthreads();  // the stage and the row buffer are free again
    if (threadIdx.x == 0 && i + p.stages < m) issue_tile(p, st, &bars[s], first + (i + p.stages) * step);
  }
  if (m > 0 && threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s)
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_addr(&bars[s])) : "memory");
  }
  // the ragged last tile, or every tile of a launch without the ring
  for (long long t = first + (long long)m * step; t < n_tiles; t += step) {
    const long long b0 = t * p.tile;
    const int nr = (int)min((long long)p.tile, p.B - b0);
    thread_tile<false>(p, global_tile(p, b0), b0, nr, rows, slots);
    __syncthreads();
    thread_rows(p, rows, b0, nr);
    __syncthreads();
  }
}

cudaError_t thread_blocks_per_sm(int threads, size_t smem, int* per_sm) {
  static int last_threads = 0, last = 0;
  static size_t last_smem = 0;
  if (threads == last_threads && smem == last_smem && last > 0) {
    *per_sm = last;
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pack_runs_thread_kernel, threads, smem);
  if (err == cudaSuccess) {
    last_threads = threads;
    last_smem = smem;
    last = *per_sm;
  }
  return err;
}

// Launch with `tile` reads a tile (= threads a block: 32, 64, 96 or 128)
// and a ring of `stages` (0: plain loads; fewer when shared memory cannot
// hold them, none when it cannot hold two or an input is off the 16-byte
// grid).
int launch(Params p, int tile, int stages, cudaStream_t stream) {
  const bool aligned = aligned16(p.ids) && aligned16(p.amb) && aligned16(p.n_kmers) &&
                       aligned16(p.call) && aligned16(p.hits) && aligned16(p.hll_stop);
  if (tile <= 0 || tile % 32 != 0 || tile > 128 || stages > kBarBytes / 8 || !aligned16(p.out) ||
      (p.hll && !aligned16(p.hll)))
    return (int)cudaErrorInvalidValue;
  p.tile = tile;
  p.stage_bytes = stage_size(tile, p.W);
  const size_t fixed = kBarBytes + sizeof(uint32_t) * (size_t)tile * (p.cols + 3 * p.R + 1);
  p.stages = aligned ? stages : 0;
  while (p.stages >= 2 && fixed + (size_t)p.stages * p.stage_bytes > (size_t)kSmemOptIn) --p.stages;
  if (p.stages < 2) p.stages = 0;
  const size_t smem = fixed + (size_t)p.stages * p.stage_bytes;
  if (smem > (size_t)kSmemOptIn) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(pack_runs_thread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess || (err = thread_blocks_per_sm(tile, smem, &per_sm)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (p.B + tile - 1) / tile;
  const int grid = (int)std::min(n_tiles, (long long)per_sm * sms);
  pack_runs_thread_kernel<<<grid, tile, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace thread_walk

namespace ballot_walk {

// A lane's inputs for one step: its code and the previous lane's.
struct Lane {
  int a, pa;
  uint32_t id, pid;
};

__device__ __forceinline__ Lane load_lane(const int32_t* idr, const uint8_t* ar, int q, int nk, int lim) {
  Lane l{0, 0, 0u, 0u};
  if (q < lim) {
    l.a = ar[q] != 0;
    l.id = (uint32_t)idr[q];
  }
  if (q > 0 && q < nk) {
    l.pa = ar[q - 1] != 0;
    l.pid = (uint32_t)idr[q - 1];
  }
  return l;
}

// One read, by one warp: walk lanes [0, nk) (all W with the feed) 32 a
// step and write the row to `row` (global memory). A step issues the next
// step's loads first, then its ballot, then its slot stores, so the loads
// are in flight behind the ballot and the stores cannot hold them back;
// the feed words go straight to the read's feed row (64 coalesced bytes a
// step). The warp's slots: R + 1 run starts, R ids, R flags.
__device__ __forceinline__ void ballot_read(const Params& p, const int32_t* idr, const uint8_t* ar, int nk_raw,
                                          uint32_t call, uint32_t hits, int stop, uint16_t* feed, int* start,
                                          uint32_t* row, int lane) {
  const int R = p.R, W = p.W;
  uint32_t* idmax = reinterpret_cast<uint32_t*>(start + R + 1);
  int* ambf = start + 2 * R + 1;
  for (int j = lane; j < R; j += 32) {
    idmax[j] = 0u;
    ambf[j] = 0;
  }
  const int nk = min(max(nk_raw, 0), W);
  // lanes read: the valid ones, and with the feed those below hll_stop
  const int lim = feed != nullptr ? min(max(nk, stop), W) : nk;
  const int end = feed != nullptr ? W : nk;
  const unsigned upto_me = kFull >> (31 - lane);
  int count = 0;  // runs started before this step
  Lane next = load_lane(idr, ar, lane, nk, lim);
  __syncwarp();
  for (int q = lane; q - lane < end; q += 32) {
    const Lane l = next;
    if (q - lane + 32 < end) next = load_lane(idr, ar, q + 32, nk, lim);
    const bool change = q < nk && (q == 0 || l.a != l.pa || (!l.a && l.id != l.pid));
    const unsigned starts = __ballot_sync(kFull, change);
    const int rid = count + __popc(starts & upto_me) - 1;
    count += __popc(starts);
    if (feed != nullptr && q < W) feed[q] = (q < stop && !l.a) ? (uint16_t)l.id : (uint16_t)0xFFFFu;
    if (change && rid <= R) start[rid] = q;
    if (change && rid < R) {
      ambf[rid] = l.a;
      if (!l.a) idmax[rid] = l.id;
    }
    if (l.a && q < nk && rid < R) atomicMax(&idmax[rid], l.id);
  }
  __syncwarp();

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
__device__ __forceinline__ void ballot_tile(const Params& p, const Tile& t, long long b0, int nr, int* start,
                                          int warp, int lane) {
  for (int r = warp; r < nr; r += kConsumers) {
    const long long b = b0 + r;
    uint16_t* feed = p.hll != nullptr ? p.hll + b * p.W : nullptr;
    ballot_read(p, t.ids + r * p.W, t.amb + r * p.W, t.nk[r], (uint32_t)t.call[r], (uint32_t)t.hits[r],
              p.hll != nullptr ? t.stop[r] : 0, feed, start, p.out + b * p.cols, lane);
  }
}


// One producer warp (the last) keeps the ring full: one thread waits for a
// stage's `empty` barrier (every consumer warp done with it) and issues the
// next tile's bulk copies into it, completing on its `full` barrier. The
// consumer warps wait for `full`, walk their reads of the tile and arrive
// on `empty`; no barrier ties one consumer warp to another, so a warp with
// short reads runs ahead by up to the ring's depth.
__global__ void __launch_bounds__(kThreads) pack_runs_ballot_kernel(const Params p) {
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
    const unsigned char* st = ring + (size_t)s * p.stage_bytes;
    bar_wait(&full[s], (uint32_t)(i / p.stages) & 1u);
    ballot_tile(p, staged_tile(p, st), (first + i * step) * p.tile, p.tile, start, warp, lane);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
  // the ragged last tile, or every tile of a launch without the ring
  for (long long t = first + (long long)m * step; t < n_tiles; t += step) {
    const long long b0 = t * p.tile;
    ballot_tile(p, global_tile(p, b0), b0, (int)min((long long)p.tile, p.B - b0), start, warp, lane);
  }
}

cudaError_t ballot_blocks_per_sm(size_t smem, int* per_sm) {
  static size_t last_smem = 0;
  static int last = 0;
  if (smem == last_smem && last > 0) {
    *per_sm = last;
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pack_runs_ballot_kernel, kThreads, smem);
  if (err == cudaSuccess) {
    last_smem = smem;
    last = *per_sm;
  }
  return err;
}

int ballot_launch(Params p, int tile, int stages, cudaStream_t stream) {
  const bool aligned = aligned16(p.ids) && aligned16(p.amb) && aligned16(p.n_kmers) &&
                       aligned16(p.call) && aligned16(p.hits) && aligned16(p.hll_stop);
  if (tile <= 0 || tile % 16 != 0 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  p.tile = tile;
  p.stage_bytes = stage_size(tile, p.W);
  const size_t fixed = kBarBytes + sizeof(uint32_t) * (size_t)kConsumers * (3 * p.R + 1);
  p.stages = aligned ? stages : 0;
  while (p.stages >= 2 && fixed + (size_t)p.stages * p.stage_bytes > (size_t)kSmemOptIn) --p.stages;
  if (p.stages < 2) p.stages = 0;
  const size_t smem = fixed + (size_t)p.stages * p.stage_bytes;
  if (smem > (size_t)kSmemOptIn) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(pack_runs_ballot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess || (err = ballot_blocks_per_sm(smem, &per_sm)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (p.B + p.tile - 1) / p.tile;
  const int grid = (int)std::min(n_tiles, (long long)per_sm * sms);
  pack_runs_ballot_kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace ballot_walk

}  // namespace

// form, tile, stages, then kuniq_pack_runs' arguments without the feed.
extern "C" int kuniq_pack_runs_variant(int form, int tile, int stages, const void* ids, const void* amb,
                                       const void* n_kmers, const void* call, const void* hits,
                                       const void* map, int n_map, void* out, int B, int W, int R,
                                       int layout, int cols, void* stream) {
  if (bad_shape(B, W, R, layout)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (form >= 1 && form <= 3) {
    const Params p = make_params(ids, amb, n_kmers, call, hits, map, n_map, out, nullptr, nullptr, B, W,
                                 R, layout, cols);
    if (form == 1) return launch_pack_runs(p, tile, stages, (cudaStream_t)stream);
    if (form == 2) return thread_walk::launch(p, tile, stages, (cudaStream_t)stream);
    return ballot_walk::ballot_launch(p, tile, stages, (cudaStream_t)stream);
  }
  const size_t smem = sizeof(int) * (size_t)kWarpReads * (3 * R + 1);
  if (form != 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  pack_runs_warp_kernel<<<(B + kWarpReads - 1) / kWarpReads, kWarpReads * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const uint8_t*)amb, (const int32_t*)n_kmers, (const int32_t*)call,
      (const int32_t*)hits, (const int32_t*)map, n_map, (uint32_t*)out, B, W, R, layout, cols);
  return (int)cudaGetLastError();
}
