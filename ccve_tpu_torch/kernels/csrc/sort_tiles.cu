// Tile sort: sorts every tile of T = 2^tile_log keys (int32, or int64 in a
// second build) ascending, in two forms on one template.
//
//  - ccve_sort_tiles_i32 / _i64 (the count side): keys alone, n a
//    multiple of the tile.
//  - ccve_sort_tiles_multi_i32 / _i64 (the stats side's probe sort):
//    stably, moving P int32 cargo planes (P = 1..3) with their keys; n any
//    length, padded to whole tiles in the kernel.
//  - ccve_sort_tiles_narrow_i32 / _i64 (the count side's probe stream,
//    int32 keys of a `pack32` table, int64 keys of a wide one): the
//    key-only sort, whose load reads the raw int64 or int32 probe column,
//    in place at any stride, and narrows each key in registers
//    (`Narrow`), padding the tiles past the column's n keys with the key
//    type's maximum. The narrowed and padded stream is never written: the
//    column is read once, by this load, where separate passes would write
//    it and read it back.
//
// Replaces: the key-only form, ccve_tpu/kernels/bigsort.py
// `_make_local_kernel` (the in-VMEM Batcher presort that `_sort_padded_buf`
// launches once per 2^17-element tile, odd tiles stored descending for its
// bitonic merge levels) and, for int64 keys, ccve_tpu/kernels/pairsort.py
// `_make_local_kernel_multi64` as `pallas_sort_i64_limbs` runs it with no
// cargo (the key held as (hi, lo) int32 limbs, a three-operation compare
// per exchange, because Mosaic has no 64-bit lanes). The multi-plane form,
// ccve_tpu/kernels/pairsort.py `_make_local_kernel_multi` (the network of
// `pallas_sort_multi_i32`, where every compare-exchange selects each cargo
// plane with the key plane's swap predicate) and, for int64 keys,
// `_make_local_kernel_multi64` (via `pallas_sort_multi_i64`, on (hi, lo)
// limb planes). That sort is not stable; this one is, so the kernel and its
// plain version (a stable torch.sort plus a gather) agree exactly. Every
// tile is stored ascending: the merge levels merge by merge path, so the
// TPU's alternating descending storage has no job here.
//
// What bounds it on an H100: device memory sees one read and one write of
// each key (and of each plane), 8 or 16 bytes an element key-only, a few
// microseconds for a whole 2^24-key stream. An earlier design ran a full
// bitonic network over the tile in shared memory: 91 stages at T = 2^13,
// each a __syncthreads() over 1024 threads, about 11.6 MB of shared-memory
// traffic a tile, for both forms. It ran at the SM's shared-memory rate
// and its barriers, 14-26 times the device-memory bound.
//
// Design: a merge sort of the tile, most of it in registers. Each thread
// loads kItems = 16 elements, coalesced (element t + k * threads), and
// sorts them with an unrolled bitonic network in registers: no shared
// memory and no barrier. Then log2(threads) merge-path rounds (9 at
// T = 2^13, 512 threads) merge the threads' sorted runs in shared memory:
// a round stores each thread's run, and each thread finds its 16 outputs
// in the merged pair by a merge-path search (merge_path.cuh, the one the
// merge levels use) and merges them serially into registers. That is two
// barriers a round and about 1.2 MB of shared-memory traffic a tile. Slots
// are skewed by one in 16, so that a thread's 16 consecutive stores do not
// fall in one bank (16 + 1 is odd in 4-byte words; in 8-byte ones the 16
// threads of a half-warp land on distinct bank pairs). A block-local LSD
// radix sort would also do, but needs a pass per digit over shared memory
// (4 or 8 passes of scatter at 8 bits, each with a block scan); the merge
// rounds reuse the merge levels' code and need no scan.
//
// An element is an Item of a trait. Key-only (`Keys`): the key itself, 4
// or 8 bytes, compared natively; ties need no order, so no index word,
// and the tile's shared memory is 34 KB (int32) or 68 KB (int64) at
// T = 2^13. Stable with cargo: the int32 build sorts one 64-bit word an
// element, (key << 32) | tile index, so no two words tie and ties of keys
// break on position (`Words32`). The int64 build cannot pack (key, index)
// into one word, since a packed 64-bit key uses every bit: it keeps (key,
// 16-bit tile index) pairs (T <= 2^13 fits 16 bits), compared
// lexicographically, in registers and in two shared arrays (`Pairs64`).
// The cargo never enters the sort: after it, each output reads its planes
// from the input row its index names (a gather within the tile's 32 KB,
// served by L1 and L2). A tile smaller than one thread's 16 elements is
// padded in registers with an item above every real one (key-only: the key
// type's maximum, which ties only real maxima). Shared memory above the
// 48 KB a block may take without opting in is granted by raising the
// kernel's limit with cudaFuncSetAttribute first, and a refusal reported.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

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

// Keys alone: a key is its own item (the count side needs no stability).
template <typename K>
struct Keys {
  using Key = K;
  using Item = K;
  struct Shared {
    K* k;
    __device__ Item load(int i) const { return k[i]; }
    __device__ void store(int i, const Item& x) const { k[i] = x; }
  };
  static constexpr size_t kBytes = sizeof(K);

  __device__ static Shared at(unsigned char* smem, int) { return {reinterpret_cast<K*>(smem)}; }
  __device__ static Item make(K key, int) { return key; }
  static constexpr K kMax = sizeof(K) == 4 ? static_cast<K>(INT_MAX) : static_cast<K>(LLONG_MAX);
  __device__ static Item pad() { return kMax; }
  __device__ static bool le(const Item& a, const Item& b) { return a <= b; }
  __device__ static K key(const Item& x) { return x; }
  __device__ static int index(const Item&) { return 0; }
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

// One tile a block: element i of the input (i below n) is
// f(x[i * stride]), a key of the trait's type; the kernels below differ
// only in that load (stride 1 and `Same` for the sorts of a key stream).
template <typename Tr, int P, typename C, typename F>
__device__ __forceinline__ void sort_tile(const C* __restrict__ x, long long stride, F f,
                                          InPlanes xv, typename Tr::Key* __restrict__ yk,
                                          OutPlanes yv, long long n, int tile_log) {
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
    it[k] = e < T ? Tr::make(e < real ? f(x[(base + e) * stride]) : Tr::kMax, e) : Tr::pad();
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

// The load of a key stream: each key as it is.
struct Same {
  template <typename K>
  __device__ __forceinline__ K operator()(K k) const {
    return k;
  }
};

template <typename Tr, int P>
__global__ void __launch_bounds__(kMaxThreads)
    sort_tiles_kernel(const typename Tr::Key* __restrict__ xk, InPlanes xv,
                      typename Tr::Key* __restrict__ yk, OutPlanes yv, long long n,
                      int tile_log) {
  sort_tile<Tr, P>(xk, 1, Same{}, xv, yk, yv, n, tile_log);
}

// The count side's probe key of type K, narrowed as
// ops.sort_merge._probe_key32 (K int) or _probe_key64 (K long long)
// narrows it in int64: K(((clamp(x, lo, hi) - kmin) + 1) << 1), here in
// wrapping 64-bit arithmetic, which is what the int64 tensor ops do. lo
// and hi are its clamp bounds, saturated at the int64 range: for int32
// keys kmin - 1 and kmin - 1 + 2^key_bits - 1, every result in [0, 2^31);
// for int64 keys kmin - 1 and kmax + 1, every result in [0, 2^63) when
// the span kmax - kmin + 2 is below 2^62.
template <typename K>
struct Narrow {
  long long lo, hi, kmin;

  __device__ K operator()(long long x) const {
    const long long c = x < lo ? lo : x > hi ? hi : x;
    const unsigned long long k =
        (static_cast<unsigned long long>(c) - static_cast<unsigned long long>(kmin) + 1ULL) << 1;
    return static_cast<K>(static_cast<std::make_unsigned_t<K>>(k));
  }
};

// The key-only tile sort of a probe column of type C (int32 or int64)
// narrowed on load into keys of type K: key i of the column is
// col[i * stride] (a column of a wider table is read in place), each read
// once, coalesced where stride is 1, and narrowed in registers; the tiles
// past n are padded with K's maximum. From the load on it is the key-only
// kernel of K.
template <typename K, typename C>
__global__ void __launch_bounds__(kMaxThreads)
    sort_tiles_narrow_kernel(const C* __restrict__ col, long long stride, Narrow<K> narrow,
                             K* __restrict__ yk, long long n, int tile_log) {
  sort_tile<Keys<K>, 0>(col, stride, narrow, InPlanes{}, yk, OutPlanes{}, n, tile_log);
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

template <typename K>
int launch_keys(const void* x, void* y, long long n_tiles, int tile_log, void* stream) {
  if (tile_log < 1 || tile_log > kMaxTileLog || n_tiles < 0 ||
      n_tiles > (0x7FFFFFFFLL >> tile_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  return launch<Keys<K>, 0>(static_cast<const K*>(x), InPlanes{}, static_cast<K*>(y),
                            OutPlanes{}, n_tiles << tile_log, tile_log,
                            static_cast<cudaStream_t>(stream));
}

// The int64 form's shared memory, 68 KB at the largest tile, is above the
// default limit: its launch opts in, as `launch` does.
template <typename K, typename C>
int launch_narrow(const void* col, long long stride, Narrow<K> narrow, void* y, long long n,
                  long long n_tiles, int tile_log, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(slots_of(tile_log)) * sizeof(K);
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(sort_tiles_narrow_kernel<K, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sort_tiles_narrow_kernel<K, C><<<static_cast<unsigned>(n_tiles), threads_of(tile_log), smem,
                                   stream>>>(static_cast<const C*>(col), stride, narrow,
                                             static_cast<K*>(y), n, tile_log);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int narrow_tiles(const void* col, int col_is_i64, long long n, long long stride, long long lo,
                 long long hi, long long kmin, void* y, long long n_tiles, int tile_log,
                 void* stream) {
  if (tile_log < 1 || tile_log > kMaxTileLog || n_tiles < 0 ||
      n_tiles > (0x7FFFFFFFLL >> tile_log) || n < 0 || n > (n_tiles << tile_log) || lo > hi ||
      stride < 0 || (col_is_i64 != 0 && col_is_i64 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const Narrow<K> narrow{lo, hi, kmin};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return col_is_i64
             ? launch_narrow<K, long long>(col, stride, narrow, y, n, n_tiles, tile_log, st)
             : launch_narrow<K, int>(col, stride, narrow, y, n, n_tiles, tile_log, st);
}

}  // namespace

// x, y: n_tiles whole tiles of 2^tile_log keys.
extern "C" int ccve_sort_tiles_i32(const void* x, void* y, long long n_tiles, int tile_log,
                                   void* stream) {
  return launch_keys<int>(x, y, n_tiles, tile_log, stream);
}

extern "C" int ccve_sort_tiles_i64(const void* x, void* y, long long n_tiles, int tile_log,
                                   void* stream) {
  return launch_keys<long long>(x, y, n_tiles, tile_log, stream);
}

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

// col: n probe keys, int64 (col_is_i64 1) or int32 (0), key i at
// col[i * stride] (stride >= 0, in elements); y: n_tiles whole tiles of
// 2^tile_log keys (int32, or int64 in the second build), n at most their
// length. Each tile of the column narrowed on load (`Narrow`; lo <= hi)
// and sorted; the keys past n are the key type's maximum.
extern "C" int ccve_sort_tiles_narrow_i32(const void* col, int col_is_i64, long long n,
                                          long long stride, long long lo, long long hi,
                                          long long kmin, void* y, long long n_tiles,
                                          int tile_log, void* stream) {
  return narrow_tiles<int>(col, col_is_i64, n, stride, lo, hi, kmin, y, n_tiles, tile_log,
                           stream);
}

extern "C" int ccve_sort_tiles_narrow_i64(const void* col, int col_is_i64, long long n,
                                          long long stride, long long lo, long long hi,
                                          long long kmin, void* y, long long n_tiles,
                                          int tile_log, void* stream) {
  return narrow_tiles<long long>(col, col_is_i64, n, stride, lo, hi, kmin, y, n_tiles,
                                 tile_log, stream);
}
