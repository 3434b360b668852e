// Merges: int32 or int64 keys carrying P int32 cargo planes (P = 0..3);
// each entry point has an _i32 and an _i64 build, but the last.
//
//  - ccve_merge_level_multi_i32: one ladder level. Each pair of ascending
//    runs of L = 2^run_log, [2pL, 2pL + L) and [2pL + L, 2pL + 2L),
//    becomes one ascending run of 2L; the last pair may have a short
//    second run, or none.
//  - ccve_merge_level_i32: the same level of keys with no planes (the
//    count side's ladder).
//  - ccve_sort_multi_i32: a whole ladder in one host call: the tile sort
//    of sort_tiles.cu, then n_levels merge levels back to back on
//    the stream, between the output and a scratch buffer.
//  - ccve_sort_runs_i32: the same ladder of keys with no planes, over
//    sort_tiles.cu's key-only tile sort.
//  - ccve_sort_runs_narrow_i32: the same ladder over sort_tiles.cu's
//    narrowing tile sort, which reads the count side's int64 or int32
//    probe column and narrows each key as it loads it.
//  - ccve_merge_two_multi_i32: the unequal merge of two ascending streams
//    A[0, na) and B[0, nb) into one of na + nb (either may be empty).
//  - ccve_merge_two_i32: the same merge of int32 keys with no planes.
//
// All are stable: at equal keys A's elements come first, and each stream
// keeps its own order, so a ladder over stably sorted tiles is a stable
// sort.
//
// Replaces: ccve_tpu/kernels/pairsort.py `_make_merge_kernel_multi` (the
// bitonic lower-half merge-path kernel with value planes, launched per
// ladder level by `_sort_padded_multi` and once by
// `_merge_two_padded_multi` with B stored reversed; its tile splits come
// precomputed from the XLA bisections `_merge_splits_alt` and
// `_merge_splits_two`); the int64 builds replace `_make_merge_kernel_multi64`
// (the same kernel on (hi, lo) int32 limb planes, launched by
// `_sort_padded_multi64` and `merge_sorted_multi_i64`, and with no cargo
// by `_sort_padded_multi64_capped`, the count side's int64 ladder). The
// key-only level ccve_merge_level_i32 replaces ccve_tpu/kernels/bigsort.py
// `_make_carried_merge_kernel` (one level of `_sort_padded_buf`'s ladder:
// per output tile, the bitonic lower half of an A window and a reversed B
// window, with the two read cursors carried in SMEM from one sequential
// grid step to the next). The key-only
// merge, ccve_merge_two_i32, replaces ccve_tpu/kernels/bigsort.py
// `_make_bitonic_merge_kernel` as `merge_sorted_i32` (:664) launches it
// through `_merge_two_padded` (:607), with `lax.sort` in its place below
// 2^17 elements or when a side is empty; here any length takes the kernel
// and values may be any int32: nothing is a sentinel.
//
// What bounds it on an H100: each merge reads and writes every key and
// every plane once, (1 + P) * 8 bytes an element for int32 keys and
// (2 + P) * 8 for int64, so device-memory bandwidth bounds it; the merge
// itself is a few compares an element. What kept earlier designs at 2-4x
// that bound was latency, not bytes: each block began with a binary
// search of its merge-path split in device memory (up to 31 dependent
// loads, by two threads, while the block waited), loaded its keys in 4- or
// 8-byte steps, and (with planes) gathered the cargo from device memory
// after the merge, a second dependent phase of reads.
//
// Design. A level is two launches. (1) A partition kernel finds every
// output tile's merge-path split at once, one warp a tile: a 32-way search
// whose lanes test 32 points of the diagonal per step, so a split takes
// ceil(log33(range)) dependent loads (5 at 2^24, not 24), into a scratch
// array the wrapper allocates. (2) The merge kernel: one block of 256
// threads a tile of kChunk = 4096 outputs (16 a thread), so about 32 KB
// (int32 keys, one plane) in flight a block. The block reads its two
// splits and stages its A and B key slices and plane slices together into
// shared memory with cp.async: 16-byte copies where the source allows
// (each slice is placed 16-byte congruent with its source), element
// copies for the misaligned head and tail, one wait. Each thread finds its
// 16 outputs by a merge-path search in shared memory and merges them
// serially into registers, keys and planes together, so no cargo is read
// from device memory after the merge. The block then spreads the outputs
// over shared memory (a skew of one slot in 32, so that neither the
// thread-blocked stores nor the row-wise loads conflict on banks) and
// writes them back coalesced. A tile is chunk = min(kChunk, 2L) outputs,
// which divides 2L, so a tile never straddles a run pair; B is ascending,
// nothing is stored reversed, and empty streams and the ragged last pair
// fall out of the split arithmetic. Shared memory grows with P and the key
// type, from 17 KB (int32, no planes) to 83 KB (int64, three planes);
// above 48 KB the launch opts in with cudaFuncSetAttribute. The key-only
// build (P = 0) is the same kernel with no plane staged or moved.
//
// The ladder entry runs the tile sort and every level from one host call:
// no Python, allocation or host sync between levels. The levels stay two
// launches each. At 1M keys (7 levels of 246 tiles) the host enqueues the
// 15 launches faster than the card runs them, so the launches hide behind
// the device's work; a variant that ran the levels in one cooperative
// launch (a grid barrier after each partition and each merge) saved the
// gaps between kernels but not the call, and at 16M its kernel, holding
// both steps' registers, ran fewer blocks an SM and was slower.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;  // outputs a block
constexpr int kMaxPlanes = 3;
constexpr int kWarp = 32;
constexpr int kSplitsPerBlock = kThreads / kWarp;  // partition: a warp a tile
// A staging region, in elements: a tile's A and B slices, each placed
// 16-byte congruent with its source (at most 2 * 7 slots of gaps), or its
// outputs spread by `skew`.
constexpr int kRegion = kChunk + kChunk / 32 + 16;
constexpr size_t kDefaultSmem = 48 * 1024;

struct InPlanes {
  const int* p[kMaxPlanes];
};
struct OutPlanes {
  int* p[kMaxPlanes];
};

// One output tile: outputs [d0, d1) of the merge of A = xa[a0, a0 + la)
// and B = xb[b0, b0 + lb), written from y[out0].
struct Span {
  long long a0, b0, la, lb, d0, d1, out0;
};

// One ladder level over x[0, n): pairs of runs of L = 2^run_log, tiles of
// chunk = min(kChunk, 2L) outputs.
struct Level {
  long long n;
  int run_log;
  long long chunk;

  __host__ __device__ long long tiles() const { return (n + chunk - 1) / chunk; }
  __device__ Span tile(long long t) const {
    const long long L = 1LL << run_log;
    const long long out0 = t * chunk;
    const long long base = (out0 >> (run_log + 1)) << (run_log + 1);
    const long long la = n - base < L ? n - base : L;
    const long long rest = n - base - L;
    const long long lb = rest < 0 ? 0 : rest < L ? rest : L;
    const long long d0 = out0 - base;
    const long long d1 = d0 + chunk < la + lb ? d0 + chunk : la + lb;
    return {base, base + la, la, lb, d0, d1, out0};
  }
};

Level level_of(long long n, int run_log) {
  const long long two_l = 2LL << run_log;
  return {n, run_log, kChunk < two_l ? kChunk : two_l};
}

// The merge of a[0, na) and b[0, nb), tiles of kChunk outputs.
struct Two {
  long long na, nb;

  __host__ __device__ long long tiles() const { return (na + nb + kChunk - 1) / kChunk; }
  __device__ Span tile(long long t) const {
    const long long d0 = t * kChunk;
    const long long d1 = d0 + kChunk < na + nb ? d0 + kChunk : na + nb;
    return {0, 0, na, nb, d0, d1, d0};
  }
};

// Every tile's split (A's elements before its first output), a warp a
// tile: each step, lane k tests the last point of the k-th of 32 equal
// parts of [lo, hi), and the first part whose last point lies past the
// split holds it; a point at or past hi counts as past.
template <typename K, typename G>
__global__ void __launch_bounds__(kThreads)
    partition_kernel(const K* __restrict__ xa, const K* __restrict__ xb, G g,
                     int* __restrict__ splits) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kSplitsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (t >= g.tiles()) return;  // the whole warp
  const Span s = g.tile(t);
  const K* a = xa + s.a0;
  const K* b = xb + s.b0;
  long long lo = s.d0 - s.lb > 0 ? s.d0 - s.lb : 0;
  long long hi = s.d0 < s.la ? s.d0 : s.la;
  while (lo < hi) {
    const long long step = (hi - lo + kWarp - 1) / kWarp;
    const long long e = lo + (lane + 1) * step - 1;
    const bool past = e >= hi || !(a[e] <= b[s.d0 - e - 1]);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, past);
    if (ballot == 0) {
      lo = hi;
    } else {
      const int f = __ffs(ballot) - 1;
      const long long e_f = lo + (f + 1) * step - 1;
      lo += f * step;
      hi = e_f < hi ? e_f : hi;
    }
  }
  if (lane == 0) splits[t] = static_cast<int>(lo);
}

__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// One tile a block.
template <typename K, int P, typename G>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const K* __restrict__ xa, InPlanes va, const K* __restrict__ xb,
                 InPlanes vb, G g, const int* __restrict__ splits, K* __restrict__ y,
                 OutPlanes yv) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* keys = reinterpret_cast<K*>(smem);
  int* planes = reinterpret_cast<int*>(keys + kRegion);
  const long long t = blockIdx.x;
  const Span s = g.tile(t);
  const int cnt = static_cast<int>(s.d1 - s.d0);
  const long long a_lo = splits[t];
  const long long a_hi = s.d1 == s.la + s.lb ? s.la : splits[t + 1];
  const int na = static_cast<int>(a_hi - a_lo);
  const int nb = cnt - na;
  const long long b_lo = s.d0 - a_lo;
  const K* sa = cp_async::stage<kThreads>(xa + s.a0 + a_lo, na, keys, 0);
  const K* sb =
      cp_async::stage<kThreads>(xb + s.b0 + b_lo, nb, keys, static_cast<int>(sa - keys) + na);
  const int* pa[P > 0 ? P : 1];
  const int* pb[P > 0 ? P : 1];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    int* region = planes + p * kRegion;
    pa[p] = cp_async::stage<kThreads>(va.p[p] + s.a0 + a_lo, na, region, 0);
    pb[p] = cp_async::stage<kThreads>(vb.p[p] + s.b0 + b_lo, nb, region,
                                      static_cast<int>(pa[p] - region) + na);
  }
  cp_async::wait_all();
  __syncthreads();

  const int first = static_cast<int>(threadIdx.x) * kPerThread;
  const int diag = first < cnt ? first : cnt;
  const auto load_a = [&](int i) { return sa[i]; };
  const auto load_b = [&](int j) { return sb[j]; };
  const auto le = [](K x, K z) { return x <= z; };
  const int ai = merge_path::split(na, nb, diag, load_a, load_b, le);
  K out_key[kPerThread];
  int out_val[P > 0 ? P : 1][kPerThread];
  merge_path::serial<kPerThread, K>(
      ai, na, diag - ai, nb, cnt - diag, load_a, load_b, le,
      [&](int k, K key, bool from_a, int i) {
        out_key[k] = key;
#pragma unroll
        for (int p = 0; p < P; ++p) out_val[p][k] = from_a ? pa[p][i] : pb[p][i];
      });
  __syncthreads();  // every thread is done with the staged slices
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (diag + k < cnt) {
      keys[skew(diag + k)] = out_key[k];
#pragma unroll
      for (int p = 0; p < P; ++p) planes[p * kRegion + skew(diag + k)] = out_val[p][k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = static_cast<int>(threadIdx.x) + k * kThreads;
    if (i < cnt) {
      y[s.out0 + i] = keys[skew(i)];
#pragma unroll
      for (int p = 0; p < P; ++p) yv.p[p][s.out0 + i] = planes[p * kRegion + skew(i)];
    }
  }
}

InPlanes in_planes(const void* v0, const void* v1, const void* v2) {
  return InPlanes{{static_cast<const int*>(v0), static_cast<const int*>(v1),
                   static_cast<const int*>(v2)}};
}

OutPlanes out_planes(void* v0, void* v1, void* v2) {
  return OutPlanes{
      {static_cast<int*>(v0), static_cast<int*>(v1), static_cast<int*>(v2)}};
}

// The partition, then the merge, of every tile of `g`.
template <typename K, int P, typename G>
int launch_merge(const K* xa, InPlanes va, const K* xb, InPlanes vb, G g, int* splits,
                 K* y, OutPlanes yv, cudaStream_t stream) {
  const long long tiles = g.tiles();
  const long long part_blocks = (tiles + kSplitsPerBlock - 1) / kSplitsPerBlock;
  partition_kernel<K, G><<<static_cast<unsigned>(part_blocks), kThreads, 0, stream>>>(
      xa, xb, g, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kRegion * (sizeof(K) + P * sizeof(int));
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(merge_kernel<K, P, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_kernel<K, P, G><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      xa, va, xb, vb, g, splits, y, yv);
  return static_cast<int>(cudaGetLastError());
}

template <typename K, typename G>
int merge_planes(const K* xa, InPlanes va, const K* xb, InPlanes vb, G g, int* splits, K* y,
                 OutPlanes yv, int n_planes, cudaStream_t stream) {
  switch (n_planes) {
    case 0:
      return launch_merge<K, 0>(xa, va, xb, vb, g, splits, y, yv, stream);
    case 1:
      return launch_merge<K, 1>(xa, va, xb, vb, g, splits, y, yv, stream);
    case 2:
      return launch_merge<K, 2>(xa, va, xb, vb, g, splits, y, yv, stream);
    default:
      return launch_merge<K, 3>(xa, va, xb, vb, g, splits, y, yv, stream);
  }
}

bool bad_level(int n_planes, long long n, int run_log) {
  return n < 0 || n > 0x7FFFFFFFLL || run_log < 0 || run_log > 30 || n_planes < 0 ||
         n_planes > kMaxPlanes;
}

template <typename K>
int level_planes(const void* xk, const void* xv0, const void* xv1, const void* xv2,
                 void* yk, void* yv0, void* yv1, void* yv2, void* splits, int n_planes,
                 long long n, int run_log, void* stream) {
  if (bad_level(n_planes, n, run_log)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const K* x = static_cast<const K*>(xk);
  const InPlanes xv = in_planes(xv0, xv1, xv2);
  return merge_planes(x, xv, x, xv, level_of(n, run_log), static_cast<int*>(splits),
                      static_cast<K*>(yk), out_planes(yv0, yv1, yv2), n_planes,
                      static_cast<cudaStream_t>(stream));
}

template <typename K>
int two_planes(const void* ak, const void* av0, const void* av1, const void* av2,
               long long na, const void* bk, const void* bv0, const void* bv1,
               const void* bv2, long long nb, void* yk, void* yv0, void* yv1, void* yv2,
               void* splits, int n_planes, void* stream) {
  if (na < 0 || nb < 0 || na + nb > 0x7FFFFFFFLL || n_planes < 1 ||
      n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (na + nb == 0) return 0;
  return merge_planes(static_cast<const K*>(ak), in_planes(av0, av1, av2),
                      static_cast<const K*>(bk), in_planes(bv0, bv1, bv2), Two{na, nb},
                      static_cast<int*>(splits), static_cast<K*>(yk),
                      out_planes(yv0, yv1, yv2), n_planes,
                      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int ccve_sort_tiles_multi_i32(const void*, const void*, const void*, const void*,
                                         void*, void*, void*, void*, int, long long, int,
                                         void*);
extern "C" int ccve_sort_tiles_multi_i64(const void*, const void*, const void*, const void*,
                                         void*, void*, void*, void*, int, long long, int,
                                         void*);
extern "C" int ccve_sort_tiles_i32(const void*, void*, long long, int, void*);
extern "C" int ccve_sort_tiles_i64(const void*, void*, long long, int, void*);
extern "C" int ccve_sort_tiles_narrow_i32(const void*, int, long long, long long, long long,
                                          long long, long long, void*, long long, int, void*);
extern "C" int ccve_sort_tiles_narrow_i64(const void*, int, long long, long long, long long,
                                          long long, long long, void*, long long, int, void*);

namespace {

using SortTiles = int (*)(const void*, const void*, const void*, const void*, void*, void*,
                          void*, void*, int, long long, int, void*);
using SortKeyTiles = int (*)(const void*, void*, long long, int, void*);
using SortNarrowTiles = int (*)(const void*, int, long long, long long, long long, long long,
                                long long, void*, long long, int, void*);

// The key-only tile sort as a SortTiles (n whole tiles, no planes).
template <SortKeyTiles kSort>
int sort_keys(const void* xk, const void*, const void*, const void*, void* yk, void*, void*,
              void*, int, long long n, int tile_log, void* stream) {
  return kSort(xk, yk, n >> tile_log, tile_log, stream);
}

// The n_levels merge levels of a ladder over n_pad elements whose tiles
// of 2^tile_log were sorted into buffer n_levels & 1 of (bk, bv): each
// level from one buffer into the other, so that the last ends in buffer 0.
template <typename K>
int levels(void* const (&bk)[2], void* const (&bv)[2][kMaxPlanes], void* splits, int n_planes,
           long long n_pad, int tile_log, int n_levels, void* stream) {
  int code = 0;
  for (int level = 0, cur = n_levels & 1; level < n_levels && code == 0; ++level, cur ^= 1) {
    code = level_planes<K>(bk[cur], bv[cur][0], bv[cur][1], bv[cur][2], bk[cur ^ 1],
                           bv[cur ^ 1][0], bv[cur ^ 1][1], bv[cur ^ 1][2], splits, n_planes,
                           n_pad, tile_log + level, stream);
  }
  return code;
}

// The tile sort (which pads x's n elements to whole tiles) into the
// buffer from which an even number of levels ends in y, then the levels.
template <typename K>
int ladder(SortTiles sort_tiles, const void* xk, const void* xv0, const void* xv1,
           const void* xv2, void* yk, void* yv0, void* yv1, void* yv2, void* tk, void* tv0,
           void* tv1, void* tv2, void* splits, int n_planes, long long n, int tile_log,
           int n_levels, void* stream) {
  if (tile_log < 1 || n_levels < 0 || tile_log + n_levels > 31 ||
      bad_level(n_planes, n, tile_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long n_pad = (((n - 1) >> tile_log) + 1) << tile_log;
  void* const bk[2] = {yk, tk};
  void* const bv[2][kMaxPlanes] = {{yv0, yv1, yv2}, {tv0, tv1, tv2}};
  const int cur = n_levels & 1;
  const int code = sort_tiles(xk, xv0, xv1, xv2, bk[cur], bv[cur][0], bv[cur][1], bv[cur][2],
                              n_planes, n, tile_log, stream);
  return code ? code : levels<K>(bk, bv, splits, n_planes, n_pad, tile_log, n_levels, stream);
}

// The key-only ladder: x, y, t: n keys, n a multiple of 2^tile_log.
template <typename K>
int sort_runs(SortTiles sort_tiles, const void* x, void* y, void* t, void* splits, long long n,
              int tile_log, int n_levels, void* stream) {
  if (tile_log < 1 || tile_log > 30 || n % (1LL << tile_log) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return ladder<K>(sort_tiles, x, nullptr, nullptr, nullptr, y, nullptr, nullptr, nullptr, t,
                   nullptr, nullptr, nullptr, splits, 0, n, tile_log, n_levels, stream);
}

// The key-only ladder over a probe column narrowed in the tile sort's
// load: the arguments of ccve_sort_runs_narrow_i32.
template <typename K>
int sort_runs_narrow(SortNarrowTiles sort_tiles, const void* col, int col_is_i64, long long n,
                     long long stride, long long lo, long long hi, long long kmin, void* y,
                     void* t, void* splits, long long n_pad, int tile_log, int n_levels,
                     void* stream) {
  if (tile_log < 1 || tile_log > 30 || n_pad % (1LL << tile_log) != 0 || n_levels < 0 ||
      tile_log + n_levels > 31 || bad_level(0, n_pad, tile_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad == 0) return 0;
  void* const bk[2] = {y, t};
  void* const bv[2][kMaxPlanes] = {};
  const int code = sort_tiles(col, col_is_i64, n, stride, lo, hi, kmin, bk[n_levels & 1],
                              n_pad >> tile_log, tile_log, stream);
  return code ? code : levels<K>(bk, bv, splits, 0, n_pad, tile_log, n_levels, stream);
}

}  // namespace

// Bytes of the split scratch that a merge of n outputs at run_log takes
// (run_log 30 for a merge of two; a ladder's first level for a ladder).
extern "C" long long ccve_merge_splits_bytes(long long n, int run_log) {
  if (n <= 0 || run_log < 0 || run_log > 30) return 0;
  return level_of(n, run_log).tiles() * static_cast<long long>(sizeof(int));
}

// Planes past n_planes may be null; splits: ccve_merge_splits_bytes(n,
// run_log) of scratch.
extern "C" int ccve_merge_level_multi_i32(const void* xk, const void* xv0, const void* xv1,
                                          const void* xv2, void* yk, void* yv0, void* yv1,
                                          void* yv2, void* splits, int n_planes, long long n,
                                          int run_log, void* stream) {
  return level_planes<int>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, splits, n_planes, n,
                           run_log, stream);
}

extern "C" int ccve_merge_level_multi_i64(const void* xk, const void* xv0, const void* xv1,
                                          const void* xv2, void* yk, void* yv0, void* yv1,
                                          void* yv2, void* splits, int n_planes, long long n,
                                          int run_log, void* stream) {
  return level_planes<long long>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, splits, n_planes, n,
                                 run_log, stream);
}

// x[0, n): padded to whole tiles of 2^tile_log (as the tile sort pads),
// tiles sorted, then n_levels merge levels, the result in y (n rounded up
// to a tile); t: scratch of y's shape; splits:
// ccve_merge_splits_bytes(y's length, tile_log) of scratch.
extern "C" int ccve_sort_multi_i32(const void* xk, const void* xv0, const void* xv1,
                                   const void* xv2, void* yk, void* yv0, void* yv1,
                                   void* yv2, void* tk, void* tv0, void* tv1, void* tv2,
                                   void* splits, int n_planes, long long n, int tile_log,
                                   int n_levels, void* stream) {
  return ladder<int>(ccve_sort_tiles_multi_i32, xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, tk,
                     tv0, tv1, tv2, splits, n_planes, n, tile_log, n_levels, stream);
}

extern "C" int ccve_sort_multi_i64(const void* xk, const void* xv0, const void* xv1,
                                   const void* xv2, void* yk, void* yv0, void* yv1,
                                   void* yv2, void* tk, void* tv0, void* tv1, void* tv2,
                                   void* splits, int n_planes, long long n, int tile_log,
                                   int n_levels, void* stream) {
  return ladder<long long>(ccve_sort_tiles_multi_i64, xk, xv0, xv1, xv2, yk, yv0, yv1, yv2,
                           tk, tv0, tv1, tv2, splits, n_planes, n, tile_log, n_levels,
                           stream);
}

// The key-only builds: x, y: n keys; splits: ccve_merge_splits_bytes(n,
// run_log) of scratch.
extern "C" int ccve_merge_level_i32(const void* x, void* y, void* splits, long long n,
                                    int run_log, void* stream) {
  return level_planes<int>(x, nullptr, nullptr, nullptr, y, nullptr, nullptr, nullptr, splits,
                           0, n, run_log, stream);
}

extern "C" int ccve_merge_level_i64(const void* x, void* y, void* splits, long long n,
                                    int run_log, void* stream) {
  return level_planes<long long>(x, nullptr, nullptr, nullptr, y, nullptr, nullptr, nullptr,
                                 splits, 0, n, run_log, stream);
}

// x, y, t: n keys, n a multiple of 2^tile_log: the tiles sorted, then
// n_levels merge levels, the result in y; t: scratch of y's shape;
// splits: ccve_merge_splits_bytes(n, tile_log) of scratch.
extern "C" int ccve_sort_runs_i32(const void* x, void* y, void* t, void* splits, long long n,
                                  int tile_log, int n_levels, void* stream) {
  return sort_runs<int>(sort_keys<ccve_sort_tiles_i32>, x, y, t, splits, n, tile_log, n_levels,
                        stream);
}

extern "C" int ccve_sort_runs_i64(const void* x, void* y, void* t, void* splits, long long n,
                                  int tile_log, int n_levels, void* stream) {
  return sort_runs<long long>(sort_keys<ccve_sort_tiles_i64>, x, y, t, splits, n, tile_log,
                              n_levels, stream);
}

// The count side's ladder over a probe column narrowed in the tile sort's
// load (sort_tiles.cu's ccve_sort_tiles_narrow_i32): col holds n keys,
// int64 (col_is_i64 1) or int32 (0), key i at col[i * stride] (in
// elements, stride >= 0), narrowed by (lo, hi, kmin) and padded with the
// key type's maximum to n_pad, a multiple of 2^tile_log at least n; then
// n_levels merge levels, the result in y. y, t: n_pad keys (int32, or
// int64 in the second build), t scratch; splits:
// ccve_merge_splits_bytes(n_pad, tile_log) of scratch.
extern "C" int ccve_sort_runs_narrow_i32(const void* col, int col_is_i64, long long n,
                                         long long stride, long long lo, long long hi,
                                         long long kmin, void* y, void* t, void* splits,
                                         long long n_pad, int tile_log, int n_levels,
                                         void* stream) {
  return sort_runs_narrow<int>(ccve_sort_tiles_narrow_i32, col, col_is_i64, n, stride, lo, hi,
                               kmin, y, t, splits, n_pad, tile_log, n_levels, stream);
}

extern "C" int ccve_sort_runs_narrow_i64(const void* col, int col_is_i64, long long n,
                                         long long stride, long long lo, long long hi,
                                         long long kmin, void* y, void* t, void* splits,
                                         long long n_pad, int tile_log, int n_levels,
                                         void* stream) {
  return sort_runs_narrow<long long>(ccve_sort_tiles_narrow_i64, col, col_is_i64, n, stride,
                                     lo, hi, kmin, y, t, splits, n_pad, tile_log, n_levels,
                                     stream);
}

// splits: ccve_merge_splits_bytes(na + nb, 30) of scratch.
extern "C" int ccve_merge_two_multi_i32(const void* ak, const void* av0, const void* av1,
                                        const void* av2, long long na, const void* bk,
                                        const void* bv0, const void* bv1, const void* bv2,
                                        long long nb, void* yk, void* yv0, void* yv1,
                                        void* yv2, void* splits, int n_planes,
                                        void* stream) {
  return two_planes<int>(ak, av0, av1, av2, na, bk, bv0, bv1, bv2, nb, yk, yv0, yv1, yv2,
                         splits, n_planes, stream);
}

extern "C" int ccve_merge_two_multi_i64(const void* ak, const void* av0, const void* av1,
                                        const void* av2, long long na, const void* bk,
                                        const void* bv0, const void* bv1, const void* bv2,
                                        long long nb, void* yk, void* yv0, void* yv1,
                                        void* yv2, void* splits, int n_planes,
                                        void* stream) {
  return two_planes<long long>(ak, av0, av1, av2, na, bk, bv0, bv1, bv2, nb, yk, yv0, yv1,
                               yv2, splits, n_planes, stream);
}

// a: int32[na], b: int32[nb] (either may be empty); y: int32[na + nb];
// splits: ccve_merge_splits_bytes(na + nb, 30) of scratch.
extern "C" int ccve_merge_two_i32(const void* a, long long na, const void* b, long long nb,
                                  void* y, void* splits, void* stream) {
  if (na < 0 || nb < 0 || na + nb > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (na + nb == 0) return 0;
  return launch_merge<int, 0>(static_cast<const int*>(a), InPlanes{},
                              static_cast<const int*>(b), InPlanes{}, Two{na, nb},
                              static_cast<int*>(splits), static_cast<int*>(y), OutPlanes{},
                              static_cast<cudaStream_t>(stream));
}
