// The dense build counts of one merged stream, in one cooperative launch.
//
// Input: one merged, ascending int32 stream s[0, L) of `key' << 1 | tag`,
// builds odd (tag 1) and probes even, so a key's probes precede its
// builds; INT32_MAX entries are phantom builds, which sort last. Output:
// bc int32[m], bc[j] = the probes in the run of the j-th build entry of
// the stream (table row j, for a pre-sorted table); build entries past the
// m-th, the phantoms among them, are dropped; ranks the stream does not
// reach get 0.
//
// Replaces: ccve_tpu/kernels/merge_scan.py `_make_counts32_dense_kernel`
// (entry `merge_scan_build_counts` :491), which scans [256, 128] tiles in
// order, carrying the probe count and the run base in SMEM, and compacts
// each tile's build counts through an in-register butterfly and a VMEM
// ring flushed R rows at a time.
//
// What bounds it on an H100: device memory and launches. The work is the
// stream read once (4 bytes an element), bc written once (4 bytes a rank)
// and a few integer operations an element: 2.4 us for the small-probe
// route's widest call (8192 probes against 1M builds). A memset of bc and
// a three-launch segmented scan that reads the stream twice took 26.4-26.9
// us of device time there on an H100 (the memset 1.8, the block reduce
// 5.7, the one-block scan 3.1, the apply pass 16.0).
//
// Design: one persistent cooperative launch, nothing to initialise.
//  - The grid is at most kBlocksPerSM blocks an SM, all co-resident (the
//    caller sizes it, `merge_scan.dense_counts_grid`); each block takes a
//    contiguous run of kTile-element tiles. A thread holds kItems
//    consecutive elements in registers, loaded as four 16-byte vectors.
//  - Pass 1: each block reduces its tiles to one CountSeg (whether it
//    holds a run start, the probes since its last run start, its builds)
//    and writes it to scratch[block]: scratch is written before it is
//    read, so a fresh torch.empty serves.
//  - One grid.sync(). Then each block scans the grid's aggregates (one a
//    thread) for its exclusive prefix and the stream's build total.
//  - Pass 2 emits bc[rank] = the run's probes at each build. The block's
//    last tile is still in registers, and goes first, from the prefix of
//    the tiles before it; the others are read again in order (only when
//    the stream has more tiles than the grid has blocks: 264 on an H100,
//    2.16M elements).
//  - A tile's builds hold consecutive ranks, so each thread stages its
//    counts in shared memory and the block writes them to bc in order,
//    coalesced. (Each thread writing its own ranks, 16 apart across a
//    warp, took 18.5 us at 8192 probes on an H100; staged, 7.4.)
//  - The ranks from the stream's build total up to m get 0, so bc needs
//    no memset.
// Blocks scan with warp shuffles and one shared array of warp totals.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // stream elements a tile
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;
constexpr unsigned kFull = 0xffffffffu;

// A segment of the stream: whether it holds a run start, the probes since
// its last run start (or over all of it), and all its builds.
struct CountSeg {
  int start;
  int probes;
  int builds;
};

__device__ __forceinline__ CountSeg identity() { return CountSeg{0, 0, 0}; }

__device__ __forceinline__ CountSeg combine(const CountSeg& a, const CountSeg& b) {
  return CountSeg{a.start | b.start, b.start ? b.probes : a.probes + b.probes,
                  a.builds + b.builds};
}

__device__ __forceinline__ CountSeg shfl_up(const CountSeg& x, int d) {
  return CountSeg{__shfl_up_sync(kFull, x.start, d), __shfl_up_sync(kFull, x.probes, d),
                  __shfl_up_sync(kFull, x.builds, d)};
}

__device__ __forceinline__ CountSeg warp_inclusive(CountSeg x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const CountSeg y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  return x;
}

// Stage slot of the p-th build count of a tile: one pad word every 32, so
// that the threads of a warp, whose counts lie about 16 apart, write to
// distinct banks.
__device__ __forceinline__ int slot(int p) { return p + (p >> 5); }

struct Shared {
  CountSeg warp[kWarps];
  int last[kWarps];
  CountSeg prefix;
  int stage[kTile + kTile / 32];  // a tile's build counts, in rank order
};

// The exclusive scan of one CountSeg a thread across the block, and the
// block's total. Ends with a barrier, so `sh` may be reused at once.
__device__ CountSeg block_exclusive(const CountSeg& x, Shared& sh, CountSeg& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const CountSeg incl = warp_inclusive(x);
  if (lane == 31) sh.warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const CountSeg w = warp_inclusive(lane < kWarps ? sh.warp[lane] : identity());
    if (lane < kWarps) sh.warp[lane] = w;
  }
  __syncthreads();
  CountSeg before = shfl_up(incl, 1);
  if (lane == 0) before = identity();
  const CountSeg excl = warp ? combine(sh.warp[warp - 1], before) : before;
  total = sh.warp[kWarps - 1];
  __syncthreads();
  return excl;
}

// The thread's kItems elements from stream position i0 (0 past L): four
// 16-byte loads where all are in range and s is 16-byte aligned.
__device__ __forceinline__ void load_items(const int* __restrict__ s, long long L,
                                           long long i0, bool aligned, int (&x)[kItems]) {
  if (aligned && i0 + kItems <= L) {
    const int4* v = reinterpret_cast<const int4*>(s + i0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 w = v[q];
      x[4 * q] = w.x;
      x[4 * q + 1] = w.y;
      x[4 * q + 2] = w.z;
      x[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) x[k] = i0 + k < L ? s[i0 + k] : 0;
  }
}

// Loads tile t into x, and returns the thread's segment of it and the run
// starts among its elements (bit k for element k).
__device__ CountSeg load_tile(const int* __restrict__ s, long long L, long long t,
                              bool aligned, Shared& sh, int (&x)[kItems],
                              unsigned& starts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = t * kTile;
  const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
  // the element before the tile, loaded beside the tile's own
  const int before = threadIdx.x == 0 && base > 0 ? s[base - 1] : 0;
  load_items(s, L, i0, aligned, x);
  // the element before the thread's first: the previous thread's last
  int prev = __shfl_up_sync(kFull, x[kItems - 1], 1);
  if (lane == 31) sh.last[warp] = x[kItems - 1];
  __syncthreads();
  if (lane == 0) prev = warp ? sh.last[warp - 1] : before;
  CountSeg a = identity();
  starts = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k < L) {
      const int p = k ? x[k - 1] : prev;
      const int st = (i0 + k == 0) || ((x[k] >> 1) != (p >> 1));
      const int build = x[k] & 1;
      starts |= static_cast<unsigned>(st) << k;
      a = combine(a, CountSeg{st, 1 - build, build});
    }
  }
  return a;
}

// bc[rank] = the run's probes at each build of a tile. `before` is the
// stream's segment before the tile, `excl` the thread's exclusive scan in
// the tile, `builds` the tile's builds. The tile's builds hold the ranks
// [before.builds, before.builds + builds): each thread stages its counts
// in shared memory, then the block writes the ranks below m to bc in
// order, coalesced.
__device__ void emit_tile(const int (&x)[kItems], unsigned starts, long long i0, long long L,
                          const CountSeg& before, const CountSeg& excl, int builds,
                          long long m, Shared& sh, int* __restrict__ bc) {
  const long long r0 = before.builds;
  CountSeg run = combine(before, excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k < L) {
      const int build = x[k] & 1;
      run = combine(run, CountSeg{static_cast<int>((starts >> k) & 1u), 1 - build, build});
      if (build && run.builds - 1 < m) {
        sh.stage[slot(static_cast<int>(run.builds - 1 - r0))] = run.probes;
      }
    }
  }
  __syncthreads();
  const long long n_out = m - r0 < builds ? m - r0 : builds;
  for (int i = threadIdx.x; i < n_out; i += kThreads) bc[r0 + i] = sh.stage[slot(i)];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dense_counts_kernel(const int* __restrict__ s, long long L, long long m,
                    CountSeg* __restrict__ agg, int* __restrict__ bc) {
  __shared__ Shared sh;
  const bool aligned = (reinterpret_cast<std::uintptr_t>(s) & 15u) == 0;
  const long long n_tiles = (L + kTile - 1) / kTile;
  const long long t0 = n_tiles * blockIdx.x / gridDim.x;
  const long long t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  const long long i_off = static_cast<long long>(threadIdx.x) * kItems;

  // pass 1: the block's aggregate; the last tile stays in registers
  int x[kItems];
  unsigned starts = 0;
  CountSeg block_agg = identity(), before_last = identity(), excl_last = identity();
  int builds_last = 0;
  for (long long t = t0; t < t1; ++t) {
    const CountSeg mine = load_tile(s, L, t, aligned, sh, x, starts);
    CountSeg total;
    const CountSeg excl = block_exclusive(mine, sh, total);
    before_last = block_agg;
    excl_last = excl;
    builds_last = total.builds;
    block_agg = combine(block_agg, total);
  }
  if (threadIdx.x == 0) agg[blockIdx.x] = block_agg;
  cg::this_grid().sync();

  // the block's prefix and the stream's total from the grid's aggregates
  CountSeg a = identity();
  if (threadIdx.x < gridDim.x) {
    const int* g = reinterpret_cast<const int*>(agg + threadIdx.x);
    a = CountSeg{__ldcg(g), __ldcg(g + 1), __ldcg(g + 2)};
  }
  CountSeg grand;
  const CountSeg excl_grid = block_exclusive(a, sh, grand);
  if (threadIdx.x == blockIdx.x) sh.prefix = excl_grid;
  __syncthreads();
  const CountSeg prefix = sh.prefix;

  // pass 2: the last tile from registers, then the others again, in order
  if (t1 > t0) {
    emit_tile(x, starts, (t1 - 1) * kTile + i_off, L, combine(prefix, before_last), excl_last,
              builds_last, m, sh, bc);
  }
  CountSeg run = prefix;
  for (long long t = t0; t + 1 < t1; ++t) {
    const CountSeg mine = load_tile(s, L, t, aligned, sh, x, starts);
    CountSeg total;
    const CountSeg excl = block_exclusive(mine, sh, total);
    emit_tile(x, starts, t * kTile + i_off, L, run, excl, total.builds, m, sh, bc);
    run = combine(run, total);
  }

  // ranks the stream's builds do not reach
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = grand.builds + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       r < m; r += stride) {
    bc[r] = 0;
  }
}

}  // namespace

// s: int32[L]; bc: int32[m] (any contents: every rank is written); grid:
// the cooperative launch's blocks, 1 <= grid <= 512 and co-resident at
// kBlocksPerSM an SM (else the launch is refused); scratch: grid CountSegs
// (12 bytes each), any contents.
extern "C" int ccve_merge_build_counts_i32(const void* s, long long L, long long m, int grid,
                                           void* scratch, void* bc, void* stream) {
  if (L < 0 || L > 0x7FFFFFFFLL || m < 0 || m > 0x7FFFFFFFLL || grid < 1 ||
      grid > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  const int* sp = static_cast<const int*>(s);
  CountSeg* agg = static_cast<CountSeg*>(scratch);
  int* out = static_cast<int*>(bc);
  void* args[] = {&sp, &L, &m, &agg, &out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(dense_counts_kernel), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
