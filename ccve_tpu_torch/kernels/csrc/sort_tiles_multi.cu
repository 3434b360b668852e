// Multi-plane tile sort: sorts every tile of T = 2^tile_log keys (int32,
// or int64 in a second build) ascending, stably, and moves P int32 cargo
// planes (P = 1..3) with their keys.
//
// Replaces: ccve_tpu/kernels/pairsort.py `_make_local_kernel_multi` (the
// in-VMEM Batcher network of `pallas_sort_multi_i32`, where every
// compare-exchange selects each cargo plane with the key plane's swap
// predicate, and odd tiles are stored descending for the bitonic merge
// levels). That sort is not stable; this one is, so the kernel and its
// plain version (a stable torch.sort plus a gather) agree exactly. The
// int64 build replaces ccve_tpu/kernels/pairsort.py
// `_make_local_kernel_multi64` (via `pallas_sort_multi_i64`), the same
// network on (hi, lo) int32 limb planes with a three-operation compare.
//
// What bounds it on an H100: device memory sees one read and one write of
// the key and of each plane, (1 + P) * 8 bytes an element for int32 keys,
// a few microseconds for a whole 2^24-key stream. An earlier design ran a
// full bitonic network over the tile in shared memory: 91 stages at
// T = 2^13, each a __syncthreads() over 1024 threads, about 11.6 MB of
// shared-memory traffic a tile. It ran at the SM's shared-memory rate and
// its barriers, 14-26 times the device-memory bound; at 1M keys, 123 tiles
// fill less than one wave of 132 SMs, so a call took one block's chain of
// 91 barriers.
//
// Design: a merge sort of the tile, most of it in registers. Each thread
// loads kItems = 16 elements, coalesced (element t + k * threads), as
// words, and sorts them with an unrolled bitonic network in registers: no
// shared memory and no barrier. Then log2(threads) merge-path rounds
// (9 at T = 2^13, 512 threads) merge the threads' sorted runs in shared
// memory: a round stores each thread's run, and each thread finds its 16
// outputs in the merged pair by a merge-path search (merge_path.cuh, the
// one the merge levels use) and merges them serially into registers. That
// is two barriers a round and about 1.2 MB of shared-memory traffic a
// tile. Slots are skewed by one in 16 64-bit words, so that a thread's 16
// consecutive stores do not fall in one bank. A block-local LSD radix sort
// of the key would also be stable, but needs a pass per digit over shared
// memory (4 or 8 passes of scatter at 8 bits, each with a block scan);
// the merge rounds reuse the merge levels' code and need no scan.
//
// Stability: the int32 build sorts one 64-bit word an element, (key << 32)
// | tile index, so no two words tie and ties of keys break on position.
// The int64 build cannot pack (key, index) into one word, since a packed
// 64-bit key uses every bit: it keeps (key, 16-bit tile index) pairs
// (T <= 2^13 fits 16 bits), compared lexicographically, in registers and
// in two shared arrays. A tile smaller than one thread's 16 elements is
// padded in registers with a word above every real one. The cargo never
// enters the sort: after it, each output reads its planes from the input
// row its index names (a gather within the tile's 32 KB, served by L1 and
// L2). Shared memory is 8.5 (int32) or 10.6 (int64) bytes an element,
// 68 KB or 85 KB at T = 2^13, above the 48 KB a block may take without
// opting in, so the launch raises the kernel's limit with
// cudaFuncSetAttribute.

#include <cuda_runtime.h>

#include <climits>

#include "merge_path.cuh"

namespace {

constexpr int kMaxTileLog = 13;
constexpr int kItems = 16;  // elements a thread
constexpr int kMaxThreads = (1 << kMaxTileLog) / kItems;
constexpr int kMaxPlanes = 3;
constexpr size_t kDefaultSmem = 48 * 1024;

struct InPlanes {
  const int* p[kMaxPlanes];
};
struct OutPlanes {
  int* p[kMaxPlanes];
};

// int32 keys: one 64-bit word (key << 32 | tile index) an element.
struct Words32 {
  using Key = int;
  struct Item {
    long long w;
  };
  struct Shared {
    long long* w;
    __device__ Item load(int i) const { return {w[i]}; }
    __device__ void store(int i, const Item& x) const { w[i] = x.w; }
  };
  static constexpr size_t kBytes = sizeof(long long);

  __device__ static Shared at(unsigned char* smem, int) {
    return {reinterpret_cast<long long*>(smem)};
  }
  __device__ static Item make(int key, int index) {
    const unsigned long long hi = static_cast<unsigned long long>(static_cast<long long>(key));
    return {static_cast<long long>((hi << 32) | static_cast<unsigned>(index))};
  }
  static constexpr int kMax = INT_MAX;
  __device__ static Item pad() { return {LLONG_MAX}; }  // index 2^32 - 1: above every word
  __device__ static bool le(const Item& a, const Item& b) { return a.w <= b.w; }
  __device__ static int key(const Item& x) { return static_cast<int>(x.w >> 32); }
  __device__ static int index(const Item& x) { return static_cast<int>(x.w & 0xFFFFFFFFLL); }
};

// int64 keys: (key, 16-bit tile index) pairs, compared lexicographically.
struct Pairs64 {
  using Key = long long;
  struct Item {
    long long k;
    int i;
  };
  struct Shared {
    long long* k;
    unsigned short* i;
    __device__ Item load(int j) const { return {k[j], i[j]}; }
    __device__ void store(int j, const Item& x) const {
      k[j] = x.k;
      i[j] = static_cast<unsigned short>(x.i);
    }
  };
  static constexpr size_t kBytes = sizeof(long long) + sizeof(unsigned short);

  __device__ static Shared at(unsigned char* smem, int slots) {
    long long* k = reinterpret_cast<long long*>(smem);
    return {k, reinterpret_cast<unsigned short*>(k + slots)};
  }
  __device__ static Item make(long long key, int index) { return {key, index}; }
  static constexpr long long kMax = LLONG_MAX;
  __device__ static Item pad() { return {LLONG_MAX, 0xFFFF}; }  // indices are below 2^13
  __device__ static bool le(const Item& a, const Item& b) {
    return a.k < b.k || (a.k == b.k && a.i <= b.i);
  }
  __device__ static long long key(const Item& x) { return x.k; }
  __device__ static int index(const Item& x) { return x.i; }
};

__host__ __device__ inline int threads_of(int tile_log) {
  const int T = 1 << tile_log;
  return T > kItems ? T / kItems : 1;
}

// Shared slots of a tile: its elements (at least one thread's), skewed.
__host__ __device__ inline int slots_of(int tile_log) {
  const int s = threads_of(tile_log) * kItems;
  return s + s / 16;
}

// One slot of padding after every 16 (a thread's run), so that the
// threads of a half-warp storing their runs (and lanes reading evenly
// spaced positions) fall in distinct banks. A shift: the same with a
// signed division cost the int64 build half its speed.
__device__ __forceinline__ int skew(int i) { return i + (i >> 4); }

// Ascending bitonic network over one thread's items, in registers.
template <typename Tr>
__device__ __forceinline__ void sort_items(typename Tr::Item (&it)[kItems]) {
#pragma unroll
  for (int k = 2; k <= kItems; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const bool swap = (i & k) == 0 ? !Tr::le(it[i], it[l]) : !Tr::le(it[l], it[i]);
          const typename Tr::Item a = it[i];
          const typename Tr::Item b = it[l];
          it[i] = swap ? b : a;
          it[l] = swap ? a : b;
        }
      }
    }
  }
}

template <typename Tr, int P>
__global__ void __launch_bounds__(kMaxThreads)
    sort_tiles_kernel(const typename Tr::Key* __restrict__ xk, InPlanes xv,
                      typename Tr::Key* __restrict__ yk, OutPlanes yv, long long n,
                      int tile_log) {
  using Item = typename Tr::Item;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = 1 << tile_log;
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) << tile_log;
  const long long real = n - base;  // the tile's elements below n; the rest are padding
  const typename Tr::Shared sh = Tr::at(smem, slots_of(tile_log));
  Item it[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = t + k * threads;
    it[k] = e < T ? Tr::make(e < real ? xk[base + e] : Tr::kMax, e) : Tr::pad();
  }
  sort_items<Tr>(it);
  // Round by round, pairs of runs of `width` threads' items become one.
  for (int width = 1; width < threads; width <<= 1) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) sh.store(skew(t * kItems + k), it[k]);
    __syncthreads();
    const int run = width * kItems;
    const int first = (t & ~(2 * width - 1)) * kItems;  // the pair's first run
    const int diag = (t & (2 * width - 1)) * kItems;
    const auto load_a = [&](int i) { return sh.load(skew(first + i)); };
    const auto load_b = [&](int j) { return sh.load(skew(first + run + j)); };
    const auto le = [](const Item& a, const Item& b) { return Tr::le(a, b); };
    const int ai = merge_path::split(run, run, diag, load_a, load_b, le);
    merge_path::serial<kItems, Item>(ai, run, diag - ai, run, kItems, load_a, load_b, le,
                                     [&](int k, const Item& x, bool, int) { it[k] = x; });
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) sh.store(skew(t * kItems + k), it[k]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = t + k * threads;
    if (e < T) {
      const Item x = sh.load(skew(e));
      yk[base + e] = Tr::key(x);
      const int index = Tr::index(x);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        yv.p[p][base + e] = index < real ? __ldg(xv.p[p] + base + index) : 0;
      }
    }
  }
}

template <typename Tr, int P>
int launch(const typename Tr::Key* xk, InPlanes xv, typename Tr::Key* yk, OutPlanes yv,
           long long n, int tile_log, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(slots_of(tile_log)) * Tr::kBytes;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(sort_tiles_kernel<Tr, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_tiles = ((n - 1) >> tile_log) + 1;
  sort_tiles_kernel<Tr, P><<<static_cast<unsigned>(n_tiles), threads_of(tile_log), smem,
                             stream>>>(xk, xv, yk, yv, n, tile_log);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr>
int launch_planes(const void* xk, const void* xv0, const void* xv1, const void* xv2,
                  void* yk, void* yv0, void* yv1, void* yv2, int n_planes, long long n,
                  int tile_log, void* stream) {
  if (tile_log < 1 || tile_log > kMaxTileLog || n < 0 || n > 0x7FFFFFFFLL || n_planes < 1 ||
      n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  using Key = typename Tr::Key;
  const InPlanes xv{{static_cast<const int*>(xv0), static_cast<const int*>(xv1),
                     static_cast<const int*>(xv2)}};
  const OutPlanes yv{
      {static_cast<int*>(yv0), static_cast<int*>(yv1), static_cast<int*>(yv2)}};
  const Key* k = static_cast<const Key*>(xk);
  Key* out = static_cast<Key*>(yk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 1:
      return launch<Tr, 1>(k, xv, out, yv, n, tile_log, st);
    case 2:
      return launch<Tr, 2>(k, xv, out, yv, n, tile_log, st);
    default:
      return launch<Tr, 3>(k, xv, out, yv, n, tile_log, st);
  }
}

}  // namespace

// x: n elements; y: n rounded up to a whole tile, the elements past n
// sorted as keys of the type's maximum with zero cargo (after every real
// key, the maximum included). Planes past n_planes may be null.
extern "C" int ccve_sort_tiles_multi_i32(const void* xk, const void* xv0, const void* xv1,
                                         const void* xv2, void* yk, void* yv0, void* yv1,
                                         void* yv2, int n_planes, long long n, int tile_log,
                                         void* stream) {
  return launch_planes<Words32>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, n_planes, n, tile_log,
                                stream);
}

extern "C" int ccve_sort_tiles_multi_i64(const void* xk, const void* xv0, const void* xv1,
                                         const void* xv2, void* yk, void* yv0, void* yv1,
                                         void* yv2, int n_planes, long long n, int tile_log,
                                         void* stream) {
  return launch_planes<Pairs64>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, n_planes, n, tile_log,
                                stream);
}
