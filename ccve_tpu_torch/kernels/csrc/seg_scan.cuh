// A single-pass segmented scan of (build count, payload sum) over one
// sorted stream, for the stats scans of merge_stats.cu and the expansion's
// candidates of candidates.cu.
//
// The TPU kernels carry their cursors and running sums from one grid step
// to the next. CUDA blocks run in no fixed order, so a block takes its tile
// from a counter (the order in which blocks start), and finds the prefix of
// the tiles before it by decoupled look-back: it publishes its tile's
// aggregate as soon as it has it, and its inclusive prefix once it knows
// it; its threads read the tiles before it, one each, kThreads at a time
// nearest first, and combine aggregates until they meet an inclusive
// prefix. A
// block waits only on tiles that blocks which started before it took, so
// the scan cannot deadlock, and the stream is read once.
//
// A block's tile is kChunk = kThreads * kItems elements. The warps read it
// striped (each instruction 32 consecutive elements, whole sectors) into
// shared memory, and each thread takes its kItems consecutive elements
// from there into registers; the slots are skewed so that neither access
// conflicts on banks. A thread reduces its elements serially; a warp
// scans its threads' segments by shuffles, and each thread folds the (at
// most 7) warp totals before its own from shared memory. Then each thread
// rescans its elements from its exclusive prefix and hands every element
// its inclusive segment value; outputs in stream order go back out the
// same way, striped.
//
// A stream policy P says what an element is and what is written:
//   size_t smem() const;  // bytes of shared memory it uses (host side)
//   struct Items;   // a thread's kItems elements, in registers
//   void load(Items&, long long tile0, long long L, unsigned char* smem) const;
//                   // the thread's elements of the tile at tile0 (below L;
//                   // load_blocked), and the key before them
//   Seg element(const Items&, int k, long long i) const;
//                   // element k (stream position i; i == 0 starts a run)
//   void emit(Items&, int k, long long i, const Seg& run) const;
//                   // element k with its inclusive scan value
//   void finish(const Items&, long long tile0, long long L,
//               unsigned char* smem) const;
//                   // after the thread's last emit; every thread calls
//                   // load and finish, so either may synchronise the block
#pragma once

#include <cuda_runtime.h>

namespace seg_scan {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;  // stream elements per tile
constexpr int kWarps = kThreads / 32;

// A segment of the stream: whether it holds a run start, and the build
// count and payload sum since its last run start (or over all of it).
struct Seg {
  int start;
  int count;
  long long sum;

  static __device__ __forceinline__ Seg identity() { return Seg{0, 0, 0}; }
  static __device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
    return Seg{a.start | b.start, b.start ? b.count : a.count + b.count,
               b.start ? b.sum : a.sum + b.sum};
  }
};

__device__ __forceinline__ Seg shfl_up(const Seg& x, int d) {
  return Seg{__shfl_up_sync(0xFFFFFFFFu, x.start, d), __shfl_up_sync(0xFFFFFFFFu, x.count, d),
             __shfl_up_sync(0xFFFFFFFFu, x.sum, d)};
}

__device__ __forceinline__ Seg shfl_down(const Seg& x, int d) {
  return Seg{__shfl_down_sync(0xFFFFFFFFu, x.start, d),
             __shfl_down_sync(0xFFFFFFFFu, x.count, d),
             __shfl_down_sync(0xFFFFFFFFu, x.sum, d)};
}

// Shared slots of a tile's exchange: one skipped after every 16, so that
// the 16 consecutive elements of a thread start 17 slots after its
// neighbour's (an odd number of 4-byte banks; in 8-byte elements, distinct
// bank pairs for the 16 threads of a half-warp), and striped accesses stay
// one slot apart.
constexpr int kSlots = kChunk + kChunk / 16;
__device__ __forceinline__ int skew(int i) { return i + (i >> 4); }

// A thread's kItems consecutive elements of the tile at tile0 (zero past
// L), into x; the element before them into before (tile0 > 0 or t > 0).
// The warps read the tile striped, 32 consecutive elements an
// instruction, into `buf` (kSlots elements of shared memory), and each
// thread reads its run back.
template <typename T>
__device__ __forceinline__ void load_blocked(const T* __restrict__ p, long long tile0,
                                             long long L, T* buf, T (&x)[kItems], T& before) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = t + j * kThreads;
    buf[skew(e)] = tile0 + e < L ? p[tile0 + e] : T{};
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) x[k] = buf[skew(t * kItems + k)];
  before = t ? buf[skew(t * kItems - 1)] : (tile0 > 0 ? p[tile0 - 1] : T{});
  __syncthreads();
}

// The reverse: each thread's kItems consecutive outputs x to p[tile0 + ...]
// below L, written striped through `buf`.
template <typename T>
__device__ __forceinline__ void store_blocked(T* __restrict__ p, long long tile0, long long L,
                                              T* buf, const T (&x)[kItems]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) buf[skew(t * kItems + k)] = x[k];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = t + j * kThreads;
    if (tile0 + e < L) p[tile0 + e] = buf[skew(e)];
  }
  __syncthreads();
}

// The look-back's state, in scratch: the tile counter and each tile's
// state (zeroed before the launch), then each tile's aggregate and
// inclusive prefix. A tile stores its value, then its state with release
// semantics; a reader loads the state with acquire semantics, then the
// value, past L1 (which is not coherent): the value it reads is the one
// the state announced. (A 16-byte word holding both, stored and loaded
// whole, was read torn on the H100: a state with a stale value.)
enum : int { kNone = 0, kAggregate = 1, kPrefix = 2 };

struct Tiles {
  unsigned* next;
  int* state;
  Seg* agg;
  Seg* incl;
};

inline long long n_tiles(long long L) { return (L + kChunk - 1) / kChunk; }
inline long long round16(long long bytes) { return (bytes + 15) & ~15LL; }
// bytes of the state that must be zero before a launch, and of the values
inline long long state_bytes(long long L) { return round16(16 + 4 * n_tiles(L)); }
inline long long value_bytes(long long L) {
  return 2 * n_tiles(L) * static_cast<long long>(sizeof(Seg));
}
inline Tiles tiles_at(unsigned char* state, unsigned char* values, long long L) {
  Seg* agg = reinterpret_cast<Seg*>(values);
  return Tiles{reinterpret_cast<unsigned*>(state), reinterpret_cast<int*>(state + 16), agg,
               agg + n_tiles(L)};
}

__device__ __forceinline__ void publish(Seg* value, int* state, const Seg& v, int s) {
  *value = v;
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(state), "r"(s) : "memory");
#else
  __sync_synchronize();
  *reinterpret_cast<volatile int*>(state) = s;
#endif
}

__device__ __forceinline__ int acquire(const int* state) {
  int s;
#ifdef __CUDA_ARCH__
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(s) : "l"(state) : "memory");
#else
  s = *reinterpret_cast<const volatile int*>(state);
  __sync_synchronize();
#endif
  return s;
}

__device__ __forceinline__ Seg read(const Seg* value) {
#ifdef __CUDA_ARCH__
  return Seg{__ldcg(&value->start), __ldcg(&value->count), __ldcg(&value->sum)};
#else
  const volatile Seg* v = value;
  return Seg{v->start, v->count, v->sum};
#endif
}

// The exclusive prefix of `tile` (> 0), by the whole block, after the
// tile's aggregate is published; thread 0 returns it. A window is a tile a
// thread, kThreads tiles nearest first (warp 0 the nearest 32): each warp
// reduces its lanes up to its nearest inclusive prefix by shuffles down,
// farther lanes on the left, and thread 0 folds the warps' values up to
// the nearest warp that met one. A wide window lets a tile find a prefix
// while the tiles just before it, started at the same time, still hold
// only aggregates. Inline: two sources include this header, and a
// non-inline function would be defined in both.
__device__ inline Seg look_back(const Tiles& st, long long tile) {
  __shared__ Seg warp_value[kWarps];
  __shared__ int warp_met[kWarps];
  __shared__ int done;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  Seg prefix = Seg::identity();
  for (long long hi = tile - 1;; hi -= kThreads) {
    const long long j = hi - t;
    int state = kPrefix;
    Seg v = Seg::identity();
    if (j >= 0) {
      do {
        state = acquire(st.state + j);
      } while (state == kNone);
      v = read(state == kPrefix ? st.incl + j : st.agg + j);
    }
    const unsigned prefixes = __ballot_sync(0xFFFFFFFFu, state == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;  // the warp's nearest prefix
    if (lane > stop) v = Seg::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) v = Seg::combine(shfl_down(v, d), v);
    if (lane == 0) {
      warp_value[warp] = v;
      warp_met[warp] = prefixes != 0;
    }
    __syncthreads();
    if (t == 0) {
      int w = 0;
      while (w < kWarps - 1 && !warp_met[w]) ++w;
      Seg window = warp_value[w];
      for (int u = w - 1; u >= 0; --u) window = Seg::combine(window, warp_value[u]);
      prefix = Seg::combine(window, prefix);
      done = warp_met[w];
    }
    __syncthreads();
    if (done) return prefix;
  }
}

// At least two blocks an SM: without the bound the generic form took 149
// registers a thread, one block an SM, and nothing ran while its
// look-back waited (333 us at the wide stats shape against 259 with it).
template <class P>
__global__ void __launch_bounds__(kThreads, 2) scan_kernel(P p, long long L, Tiles st) {
  extern __shared__ __align__(16) unsigned char smem[];  // p.smem() bytes
  __shared__ unsigned tile_s;
  __shared__ Seg warp_total[kWarps];
  __shared__ Seg tile_prefix;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(st.next, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long i0 = tile * kChunk + static_cast<long long>(t) * kItems;
  typename P::Items it;
  p.load(it, tile * kChunk, L, smem);
  Seg own = Seg::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k < L) own = Seg::combine(own, p.element(it, k, i0 + k));
  }
  Seg incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg y = shfl_up(incl, d);
    if (lane >= d) incl = Seg::combine(y, incl);
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  Seg before = Seg::identity();  // this warp's exclusive prefix within the tile
  for (int w = 0; w < warp; ++w) before = Seg::combine(before, warp_total[w]);
  Seg total = Seg::identity();
  if (t == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = Seg::combine(total, warp_total[w]);
    if (tile == 0) {
      publish(st.incl, st.state, total, kPrefix);
      tile_prefix = Seg::identity();
    } else {
      publish(st.agg + tile, st.state + tile, total, kAggregate);
    }
  }
  if (tile > 0) {
    const Seg prefix = look_back(st, tile);
    if (t == 0) {
      publish(st.incl + tile, st.state + tile, Seg::combine(prefix, total), kPrefix);
      tile_prefix = prefix;
    }
  }
  __syncthreads();
  Seg excl = shfl_up(incl, 1);
  if (lane == 0) excl = Seg::identity();
  Seg run = Seg::combine(Seg::combine(tile_prefix, before), excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k < L) {
      run = Seg::combine(run, p.element(it, k, i0 + k));
      p.emit(it, k, i0 + k, run);
    }
  }
  p.finish(it, tile * kChunk, L, smem);
}

// One scan launch over a stream of L (0 < L < 2^31) elements; the look-back
// state (state_bytes) must be zero; the values take value_bytes.
template <class P>
int launch(const P& p, long long L, const Tiles& st, cudaStream_t stream) {
  const size_t smem = p.smem();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<P><<<static_cast<unsigned>(n_tiles(L)), kThreads, smem, stream>>>(p, L, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace seg_scan
