// Stream compaction: the rows j of C int32 planes (a [C, n] array) where
// mask[j] holds, packed to the front in their order, zeros after them, and
// their count.
//
// Replaces: ccve_tpu/kernels/compact.py `_make_ring_kernel` (entries
// `pallas_compact_i32`, `pallas_compact`): per (R, 128) tile a
// Hillis-Steele rank and a butterfly compaction in log2(tile) shift
// rounds (the VPU has no compress instruction and no scatter), then an
// append into a VMEM ring that flushes whole blocks to HBM, with the ring
// fill and the output row carried from one grid step to the next. The TPU
// path takes that kernel only when the candidate count is a multiple of
// 128 (a lane constraint); this one takes any n.
//
// What bounds it on an H100: device memory. The mask and the C planes are
// read once, and every output slot is written once (kept rows and zeros
// alike); the ranks are a popcount and a warp scan an element.
//
// Design: one launch. Blocks take tiles of kTile rows in order from a
// counter, so a block waits only on tiles that blocks started before it
// took. A thread reads its kItems mask bytes in 16-byte loads, ranks its
// kept rows by popcounts, and a warp-shuffle scan plus the warps' totals
// rank them in the tile. The tile's output offset `excl` (rows kept before
// it) comes from a decoupled look-back over the tiles before it, kThreads
// tiles a window: each tile publishes its count, then its inclusive prefix,
// as one 8-byte word holding the state and the value (zeroed, kNone, by the
// one memset before the launch). A naturally aligned 8-byte store or load is
// single-copy atomic, so a reader never sees a state with another state's
// value, and the loads need no acquire order (seg_scan.cuh's 16-byte Seg
// cannot travel so). As soon as a block has its tile it starts copying the
// tile's rows of up to kStaged planes into shared memory (cp.async, 16-byte
// copies), so that they are in flight while it ranks its rows and looks
// back. Each plane is then compacted in place in shared memory (every thread
// reads its kept rows, a barrier, then writes them at their ranks) and
// written to the tile's one contiguous range [excl, excl + cnt), coalesced;
// planes past kStaged are staged kStaged at a time after the ones before
// them. The zeros come from the kernel, not a memset of the output: with U =
// tile0 - excl unselected rows before the tile and u in it, the tile writes
// its u zeros to [n - U - u, n - U). Those ranges tile [count, n) (the last
// tile's first), so every output slot is written exactly once. The last
// tile's inclusive prefix is the count. No atomics decide an output
// position, so the output is the same on every run.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;                  // rows a thread: 16-byte loads of the mask
constexpr int kTile = kThreads * kItems;    // rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kStaged = 3;                  // planes staged in shared memory at once
constexpr int kRegion = kTile + 4;          // a staged plane: 16-byte congruent with its source
constexpr size_t kDefaultSmem = 48 * 1024;
static_assert(kItems % 16 == 0 && kItems <= 32, "a thread's rows are bits of one word");

// The look-back's state, in scratch, all zeroed before the launch: the
// tile counter (in 16 bytes), then each tile's word, its state in the high
// half and its count (kAggregate) or inclusive prefix (kPrefix) in the low.
enum : unsigned { kNone = 0, kAggregate = 1, kPrefix = 2 };
struct LookBack {
  unsigned* next;
  unsigned long long* words;
};

__host__ __device__ long long n_tiles(long long n) { return (n + kTile - 1) / kTile; }
long long state_bytes(long long n) { return 16 + 8 * n_tiles(n); }

__device__ __forceinline__ void publish(unsigned long long* word, unsigned state, int value) {
  const unsigned long long w =
      static_cast<unsigned long long>(state) << 32 | static_cast<unsigned>(value);
#ifdef __CUDA_ARCH__
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
#else
  *reinterpret_cast<volatile unsigned long long*>(word) = w;
#endif
}

__device__ __forceinline__ unsigned long long read(const unsigned long long* word) {
#ifdef __CUDA_ARCH__
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  return w;
#else
  return *reinterpret_cast<const volatile unsigned long long*>(word);
#endif
}

// One bit a byte of w that is not zero, in byte order.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return ((w & 0xFFu) != 0) | (((w >> 8) & 0xFFu) != 0) << 1 | (((w >> 16) & 0xFFu) != 0) << 2 |
         ((w >> 24) != 0) << 3;
}

// The rows kept before `tile` (> 0), by the whole block after the tile's
// count is published; every thread returns it. A window is a tile a
// thread, kThreads tiles nearest first: each warp sums its lanes' counts
// up to its nearest inclusive prefix, and every thread folds the warps'
// sums up to the nearest warp that met one. The window is as wide as the
// block because the tiles just before this one started at about the same
// time and may still be looking back themselves: a window of one warp let
// prefixes reach only 32 tiles further on each round trip to L2.
__device__ int look_back(const LookBack& lb, long long tile) {
  __shared__ int warp_sum[kWarps];
  __shared__ int warp_met[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int prefix = 0;
  for (long long hi = tile - 1;; hi -= kThreads) {
    const long long j = hi - t;
    unsigned long long w = static_cast<unsigned long long>(kPrefix) << 32;  // before tile 0
    if (j >= 0) {
      do {
        w = read(lb.words + j);
      } while ((w >> 32) == kNone);
    }
    int v = static_cast<int>(static_cast<unsigned>(w));
    const unsigned prefixes = __ballot_sync(0xFFFFFFFFu, (w >> 32) == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;  // the warp's nearest prefix
    if (lane > stop) v = 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    if (lane == 0) {
      warp_sum[warp] = v;
      warp_met[warp] = prefixes != 0;
    }
    __syncthreads();
    bool met = false;
    for (int k = 0; k < kWarps && !met; ++k) {
      prefix += warp_sum[k];
      met = warp_met[k];
    }
    __syncthreads();  // the warps' sums are free for the next window
    if (met) return prefix;
  }
}

__global__ void __launch_bounds__(kThreads)
    compact_kernel(const int* __restrict__ planes, const unsigned char* __restrict__ mask,
                   long long n, int n_planes, LookBack lb, int* __restrict__ out,
                   long long* __restrict__ count) {
  extern __shared__ __align__(16) int staged[];  // min(n_planes, kStaged) regions
  __shared__ unsigned tile_s;
  __shared__ int warp_total[kWarps];
  __shared__ unsigned own_bits[kThreads];  // each thread's kept rows
  __shared__ int own_rank[kThreads];       // the tile's kept rows before each thread's
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(lb.next, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long tile0 = tile * kTile;
  const int rows = n - tile0 < kTile ? static_cast<int>(n - tile0) : kTile;
  const auto plane_rows = [&](int p) { return planes + p * n + tile0; };

  // the first planes' rows are in flight while the block ranks and looks back
  const int first = n_planes < kStaged ? n_planes : kStaged;
  for (int q = 0; q < first; ++q) {
    cp_async::stage<kThreads>(plane_rows(q), rows, staged + q * kRegion, 0);
  }

  // this thread's rows [r0, r0 + kItems) as bits
  const int r0 = t * kItems;
  const unsigned char* m = mask + tile0 + r0;
  unsigned bits = 0;
  if (r0 + kItems <= rows && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kItems / 16; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(m)[q];
      bits |= (nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 | nonzero_bytes(w.z) << 8 |
               nonzero_bytes(w.w) << 12)
              << (16 * q);
    }
  } else {
    for (int k = 0; k < kItems && r0 + k < rows; ++k) bits |= (m[k] != 0 ? 1u : 0u) << k;
  }
  const int own = __popc(bits);
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_total[w] : 0;
    cnt += warp_total[w];
  }
  own_bits[t] = bits;
  own_rank[t] = before + incl - own;
  if (t == 0) {
    if (tile == 0) {
      publish(lb.words, kPrefix, cnt);
    } else {
      publish(lb.words + tile, kAggregate, cnt);
    }
  }
  __syncthreads();

  // element e = t + j * kThreads of the tile, striped: its place among the
  // tile's kept rows, or -1
  int slot[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = t + j * kThreads;
    const unsigned b = own_bits[e / kItems];
    const int k = e % kItems;
    slot[j] = e < rows && (b >> k & 1u) ? own_rank[e / kItems] + __popc(b & ((1u << k) - 1u))
                                        : -1;
  }
  const long long excl = tile > 0 ? look_back(lb, tile) : 0;
  if (tile > 0 && t == 0) {
    publish(lb.words + tile, kPrefix, static_cast<int>(excl) + cnt);
  }
  const int u = rows - cnt;
  for (int p0 = 0; p0 < n_planes; p0 += kStaged) {
    const int group = n_planes - p0 < kStaged ? n_planes - p0 : kStaged;
    for (int q = 0; q < group && p0 > 0; ++q) {
      cp_async::stage<kThreads>(plane_rows(p0 + q), rows, staged + q * kRegion, 0);
    }
    cp_async::wait_all();
    __syncthreads();  // the group's rows are visible
    const long long zeros0 = n - (tile0 - excl) - u;  // U = tile0 - excl unselected before
    for (int q = 0; q < group; ++q) {
      // compacted in place: every thread reads its kept rows, then writes them
      int* s = cp_async::staged_at(plane_rows(p0 + q), staged + q * kRegion, 0);
      int v[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (slot[j] >= 0) v[j] = s[t + j * kThreads];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (slot[j] >= 0) s[slot[j]] = v[j];
      }
      __syncthreads();
      int* row = out + (p0 + q) * n;
      for (int i = t; i < cnt; i += kThreads) row[excl + i] = s[i];
      for (int i = t; i < u; i += kThreads) row[zeros0 + i] = 0;
    }
    __syncthreads();  // the regions are free for the next group
  }
  if (t == 0 && tile == n_tiles(n) - 1) *count = excl + cnt;
}

}  // namespace

// Bytes of scratch the wrapper allocates for n elements: the look-back's
// state, zeroed by the entry point.
extern "C" long long ccve_compact_scratch_bytes(long long n) { return state_bytes(n); }

// planes, out: int32[n_planes, n] (every slot of out is written); mask:
// bool[n]; count: one int64; scratch: as sized above.
extern "C" int ccve_compact_i32(const void* planes, const void* mask, long long n, int n_planes,
                                void* scratch, void* out, void* count, void* stream) {
  if (n < 0 || n > 0x7FFFFFFFLL || n_planes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(count, 0, sizeof(long long), st));
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const cudaError_t err = cudaMemsetAsync(base, 0, static_cast<size_t>(state_bytes(n)), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LookBack lb{reinterpret_cast<unsigned*>(base),
                    reinterpret_cast<unsigned long long*>(base + 16)};
  const size_t smem = (n_planes < kStaged ? n_planes : kStaged) * kRegion * sizeof(int);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  compact_kernel<<<static_cast<unsigned>(n_tiles(n)), kThreads, smem, st>>>(
      static_cast<const int*>(planes), static_cast<const unsigned char*>(mask), n, n_planes, lb,
      static_cast<int*>(out), static_cast<long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
