// The merge counts of the count side: ccve_merge_counts_i32 / _i64,
// bc[j] = the number of real probes p, over all sorted probe runs, with
// p == b[j] - 1. One build for int32 streams, one for int64. (The dense
// counts of one merged stream are in dense_counts.cu.)
//
// Input: a buffer of probe runs, each of run_len keys (the last one may be
// shorter) sorted ascending, whose first n_real keys are the real probes
// (packed key' << 1, even; the sort padding, the key type's maximum, sorts
// to the end of the last run); and the build stream b (key' << 1 | 1, odd,
// ascending, keys may repeat). Output: bc int32[m]. Every build row of a
// repeated key gets the full count of its key.
//
// Replaces: ccve_tpu/kernels/merge_scan.py `_make_merge_counts_kernel`
// with `_counts_scan_tile` (the `merge_counts_fused` entry, one launch per
// run: merges the run with the reversed build stream tile by tile, scans
// each merged tile for per-build probe counts, compacts them densely
// through a VMEM ring, and carries cursors, running counts and the ring
// fill in SMEM from one sequential grid step to the next); for int64 keys
// `_make_counts64_dense_kernel` (entry `merge_scan_build_counts64`), which
// scans each run after `merge_sorted_i64_limbs` has merged the build
// stream into it, on (hi, lo) limbs.
//
// What bounds it on an H100: device-memory bandwidth. The function reads
// the real probes and b once and writes bc once, 4·(n + 2m) bytes for
// int32 keys and 8·(n + m) + 4m for int64; the counting is a few compares
// a probe and a build row. The first design (one thread a build row, two
// binary searches of each whole run in device memory) read about those
// bytes, but in 2·log2(run_len) dependent 4- or 8-byte loads a row and a
// run: latency set its time, 8-15x the bound.
//
// Design. A block of kThreads owns a tile of kTile = kThreads * kRows
// consecutive build rows [j0, j1); each thread holds kRows consecutive
// rows' keys and counts in registers. In run r (the real probes
// [r·run_len, min((r+1)·run_len, n_real))) the probes that can match the
// tile lie in the slice [lower_bound(b[j0] - 1), lower_bound(b[j1 - 1])).
// The block finds the slices of up to kRunBatch runs at once: a group of g
// lanes searches each bound (g = kThreads / the searches, at most 32),
// testing g points a step, so a bound in a run of 2^21 takes 6 dependent
// loads at config 1's 8 runs (g = 16), not 21. A slice of at most
// kStage keys is copied into shared memory with cp.async, a key a lane
// from the buffer's 16-byte aligned start (cp_async.cuh), double
// buffered, so that the next run's slice loads while this one is counted.
// Each thread finds its first row's lower bound i in the slice by binary
// search. Its rows' probes then lie in the next few keys (about 2·kRows at
// config 1's density): when the kWindow<K> keys from i's 16-byte word on
// reach its last row's key (or the slice's end), it loads them into
// registers a word at a time and counts each row by kWindow compares, the
// same work in every lane, so no warp diverges. Otherwise it walks its
// rows, galloping to each row's two bounds from the last (a repeated key
// takes the count of the row before it). A key repeated across a tile
// boundary is counted in full by both tiles, since each tile's slice
// starts at the lower bound of its own first key. A slice longer than the
// stage (a heavy key, or a tile of one repeated key) is walked straight in
// device memory, inside the slice only. The counts go out through shared
// memory, coalesced. So each run key is read about once from device
// memory (tiles overlap only where a key straddles two), b once and bc
// written once; no atomics, no state carried between blocks, blocks in
// any order.
//
// What holds it back (bench/tile_sweep.py, PERF.md): the counting, not
// the bytes. The searches, staging and barriers alone take about 1.6
// times the bound; the window's compares and loads, instructions in every
// lane, about as much again, and a walk (divergent gallops) more.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // build rows a thread
constexpr int kTile = kThreads * kRows;  // build rows a block
// Probe keys a staging buffer holds (two a block): 1.375 times the
// 2·kTile keys a run's slice holds at config 1's 16 probes a build row in
// 8 runs (25 KB a block for int32 keys, 46 KB for int64).
constexpr int kStage = 11 * kTile / 4;
// Keys of a thread's window (a whole number of 16-byte words): about
// 2·kRows keys of its rows' own a run at config 1's density, its first key
// aligned down to a word, and room for more (config 1 wide's slices hold
// probes that match nothing too).
template <typename K>
constexpr int kWindow = sizeof(K) == 4 ? 24 : 32;
template <typename K>
constexpr int kVec = static_cast<int>(16 / sizeof(K));  // keys a 16-byte word
constexpr int kRunBatch = kThreads / 2;  // runs whose slices are searched at once
constexpr int kWarp = 32;
constexpr size_t kDefaultSmem = 48 * 1024;

constexpr int kBuffers = 2;  // staging buffers a block: kBuffers - 1 slices load ahead
// A buffer's slots: the slice from slot 0, then room for the last window
// that starts inside it.
template <typename K>
constexpr int kSlots = kStage + kWindow<K>;
template <typename K>
constexpr size_t kSmemBytes = kBuffers * kSlots<K> * sizeof(K);
static_assert(kWindow<int> % kVec<int> == 0 && kWindow<long long> % kVec<long long> == 0,
              "a window is a whole number of words");
static_assert(kSlots<int> % kVec<int> == 0 && kSlots<long long> % kVec<long long> == 0,
              "every buffer starts 16-byte aligned");
static_assert(kSmemBytes<int> >= (kTile + kTile / 32) * sizeof(int),
              "the buffers hold the tile's counts");

// Where the tile's i-th count waits to be written: one slot free after
// every 32, so that a warp's stores of its threads' kRows counts (kRows
// apart) fall in different banks.
__device__ __forceinline__ int out_slot(int i) { return i + (i >> 5); }

// First index in [lo, hi) of ascending a with a[i] >= v (hi if none);
// a(i) loads the i-th key.
template <typename K, typename Load>
__device__ __forceinline__ int lower_bound(Load a, int lo, int hi, K v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a(mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same bound in a[i, n) when a[i - 1] < v: steps of 1, 2, 4, ... from
// i, then a binary search inside the last step, so a bound d slots on
// costs about 2·log2(d) loads.
template <typename K, typename Load>
__device__ __forceinline__ int gallop(Load a, int i, int n, K v) {
  int lo = i, hi = i, step = 1;
  while (hi < n && a(hi) < v) {
    lo = hi + 1;
    hi = step < n - hi ? hi + step : n;
    step <<= 1;
  }
  return lower_bound(a, lo, hi, v);
}

// The lower bound of v in a[lo, hi), searched by a group of g lanes (g a
// power of two up to 32, groups aligned in the warp): each step the
// group's lanes test g points that cut [lo, hi) into g + 1 parts, and the
// first point at or above v bounds the answer. Every lane of the warp
// calls it (the ballot); a lane with lo == hi searches nothing.
template <typename K>
__device__ __forceinline__ int group_lower_bound(const K* __restrict__ a, int lo, int hi,
                                                 K v, int g) {
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int k = lane & (g - 1);
  const int base = lane - k;
  const unsigned group = (g == kWarp ? 0xFFFFFFFFu : (1u << g) - 1u) << base;
  while (__any_sync(0xFFFFFFFFu, lo < hi)) {
    const long long len = hi - lo;
    const bool past = lo < hi && !(a[lo + (k + 1) * len / (g + 1)] < v);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, past) & group;
    if (lo < hi) {
      const int f = ballot ? __ffs(ballot) - 1 - base : g;
      const int next_lo = f == 0 ? lo : lo + static_cast<int>(f * len / (g + 1)) + 1;
      if (f < g) hi = lo + static_cast<int>((f + 1) * len / (g + 1));
      lo = next_lo;
    }
  }
  return lo;
}

// Adds to cnt[q] the keys of a slice s(0), ..., s(n - 1) equal to
// key[q] - 1, for the thread's first `rows` rows (ascending keys), walking
// from i, the lower bound of key[0] - 1.
template <typename K, typename Load>
__device__ __forceinline__ void walk_slice(Load s, int i, int n, const K (&key)[kRows],
                                           int rows, int (&cnt)[kRows]) {
  int c = 0;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (q < rows) {
      if (q == 0 || key[q] != key[q - 1]) {
        i = gallop(s, i, n, static_cast<K>(key[q] - 1));
        const int e = gallop(s, i, n, key[q]);
        c = e - i;
        i = e;
      }
      cnt[q] += c;
    }
  }
}

// The same counts over a slice staged at buf[0, n) (16-byte aligned, with
// kWindow slots of room past n). The thread's matches start at the lower
// bound i of key[0] - 1; when the kWindow keys from i's word on hold them
// all (they reach key[rows - 1], or the slice's end), the thread loads
// them into registers a word at a time and counts each row by kWindow
// compares, the same work in every lane; else it walks.
template <typename K>
__device__ __forceinline__ void count_staged(const K* buf, int n, const K (&key)[kRows],
                                             int rows, int (&cnt)[kRows]) {
  if (rows == 0 || n == 0) return;
  const auto s = [buf](int e) { return buf[e]; };
  const int i = lower_bound(s, 0, n, static_cast<K>(key[0] - 1));
  const int a = i & ~(kVec<K> - 1);
  K last = key[0];  // key[rows - 1], with no dynamic index (which would put key in local memory)
#pragma unroll
  for (int q = 1; q < kRows; ++q) {
    if (q < rows) last = key[q];
  }
  if (a + kWindow<K> < n && buf[a + kWindow<K> - 1] < last) {
    walk_slice(s, i, n, key, rows, cnt);
    return;
  }
  K win[kWindow<K>];
#pragma unroll
  for (int w = 0; w < kWindow<K>; w += kVec<K>) {
    if constexpr (sizeof(K) == 4) {
      const int4 v = *reinterpret_cast<const int4*>(buf + a + w);
      win[w] = v.x;
      win[w + 1] = v.y;
      win[w + 2] = v.z;
      win[w + 3] = v.w;
    } else {
      const longlong2 v = *reinterpret_cast<const longlong2*>(buf + a + w);
      win[w] = v.x;
      win[w + 1] = v.y;
    }
  }
  // keys past the slice's end are stale: no row counts them
  const int live = n - a;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWindow<K>; ++w) c += (w < live) & (win[w] == key[q] - 1);
    if (q < rows) cnt[q] += c;
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    merge_counts_kernel(const K* __restrict__ runs, long long run_len, int n_real,
                        const K* __restrict__ b, int m, int* __restrict__ bc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int bounds[2 * kRunBatch];  // each run's slice [bounds[2i], bounds[2i + 1])
  K* const stage = reinterpret_cast<K*>(smem);  // kBuffers buffers of kSlots<K>
  const int j0 = static_cast<int>(blockIdx.x) * kTile;
  const int j1 = m - j0 < kTile ? m : j0 + kTile;
  const int first = static_cast<int>(threadIdx.x) * kRows;  // in the tile
  const int rows = j1 - j0 - first < 0 ? 0 : j1 - j0 - first < kRows ? j1 - j0 - first : kRows;
  K key[kRows];
  int cnt[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    key[q] = q < rows ? b[j0 + first + q] : K{};
    cnt[q] = 0;
  }
  const K lo_key = b[j0] - 1;
  const K hi_key = b[j1 - 1];
  const long long n_runs = (n_real + run_len - 1) / run_len;

  for (long long r0 = 0; r0 < n_runs; r0 += kRunBatch) {
    const int nb = static_cast<int>(n_runs - r0 < kRunBatch ? n_runs - r0 : kRunBatch);
    int g = kWarp;
    while (g > 1 && 2 * nb * g > kThreads) g >>= 1;
    const int q = static_cast<int>(threadIdx.x) / g;  // this lane's search
    int lo = 0, hi = 0;
    if (q < 2 * nb) {
      const long long start = (r0 + q / 2) * run_len;
      lo = static_cast<int>(start);
      hi = static_cast<int>(n_real - start < run_len ? n_real : start + run_len);
    }
    const int bound = group_lower_bound(runs, lo, hi, (q & 1) ? hi_key : lo_key, g);
    if (q < 2 * nb && static_cast<int>(threadIdx.x) % g == 0) bounds[q] = bound;
    __syncthreads();

    // Starts staging run i's slice, a key a lane, if the batch has a run i
    // and its slice fits a buffer, and closes a group of copies either
    // way, so that every iteration waits for the same count of newer groups.
    const auto load = [&](int i) {
      const int s = i < nb ? bounds[2 * i] : 0;
      const int n = i < nb ? bounds[2 * i + 1] - s : 0;
      if (n <= kStage) {
        K* const buf = stage + i % kBuffers * kSlots<K>;
        for (int e = static_cast<int>(threadIdx.x); e < n; e += kThreads) {
          cp_async::copy_small<sizeof(K)>(buf + e, runs + s + e);
        }
      }
      cp_async::commit();
    };
    for (int i = 0; i < kBuffers - 1; ++i) load(i);
    for (int i = 0; i < nb; ++i) {
      load(i + kBuffers - 1);
      cp_async::wait_group<kBuffers - 1>();
      __syncthreads();  // run i's slice is staged
      const int s = bounds[2 * i], n = bounds[2 * i + 1] - s;
      if (n <= kStage) {
        count_staged(stage + i % kBuffers * kSlots<K>, n, key, rows, cnt);
      } else if (rows > 0 && n > 0) {
        const K* const slice = runs + s;
        const auto load_key = [slice](int e) { return slice[e]; };
        walk_slice(load_key, lower_bound(load_key, 0, n, static_cast<K>(key[0] - 1)), n, key,
                   rows, cnt);
      }
      __syncthreads();  // every thread is done with run i's buffer and bounds
    }
  }

  int* out = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (q < rows) out[out_slot(first + q)] = cnt[q];
  }
  __syncthreads();
  for (int i = static_cast<int>(threadIdx.x); i < j1 - j0; i += kThreads) {
    bc[j0 + i] = out[out_slot(i)];
  }
}

template <typename K>
int launch(const void* runs, long long run_len, long long n_real, const void* b, long long m,
           void* bc, void* stream) {
  if (run_len < 1 || n_real < 0 || n_real > 0x7FFFFFFFLL || m < 0 || m > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  constexpr size_t smem = kSmemBytes<K>;
  // the run bounds' static shared memory counts against the same 48 KB
  if (smem + 2 * kRunBatch * sizeof(int) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_counts_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (m + kTile - 1) / kTile;
  merge_counts_kernel<K><<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(runs), run_len, static_cast<int>(n_real),
      static_cast<const K*>(b), static_cast<int>(m), static_cast<int*>(bc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ccve_merge_counts_i32(const void* runs, long long run_len,
                                     long long n_real, const void* b32,
                                     long long m, void* bc, void* stream) {
  return launch<int>(runs, run_len, n_real, b32, m, bc, stream);
}

extern "C" int ccve_merge_counts_i64(const void* runs, long long run_len,
                                     long long n_real, const void* b64,
                                     long long m, void* bc, void* stream) {
  return launch<long long>(runs, run_len, n_real, b64, m, bc, stream);
}
