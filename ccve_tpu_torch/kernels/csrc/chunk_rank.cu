// Per-chunk ranks against a sorted table: for each probe lane, the number
// of table rows equal to its key (mult, 0 on an invalid lane) and the first
// of them (start = the lower bound in the sorted table).
//
// Replaces: ccve_tpu/kernels/chunk_probe.py `_make_chunk_rank_kernel`
// (kernel :85, called by `chunk_rank` :245). The Pallas kernel packs keys
// into int32 (key' << 1 | 1, invalid lanes as I32_MAX sentinels), stages
// the table in VMEM, Batcher-sorts the chunk, merges it into the table a
// tile a grid step with SMEM cursors, and Batcher-unsorts the results: the
// TPU has no per-lane random access.
//
// What bounds it on an H100: latency. One chunk is `block` lanes (2048 at
// config 3) against a table of m rows (50,000 int64 at config 3, 400 KB,
// which stays in the 50 MB L2 from one launch to the next); the bytes are
// a few tens of KB, the work a few searches a lane. A binary search over
// the table in device memory is 2 log2(m) dependent loads a lane (32 at
// config 3, each an L1 or L2 round trip: 7.0 us a launch on an H100 for
// two such searches a thread), and the caller pays a launch a
// (chunk, level), so the host's enqueue sets the call's time as much as
// the device does.
//
// Design: a sampled index in shared memory and short searches in device
// memory.
//  - Each block stages every 2^stride_log-th table key (index[i] =
//    table[i << stride_log], at most kIndexMax = 4096 keys, 32 KB) in one
//    round of independent loads and one barrier. The caller picks the
//    smallest stride_log >= 6 whose index covers the table within the
//    budget (`chunk_probe.index_stride_log`), so a larger table only
//    widens the stride.
//  - The lower bound: a search of the index in shared memory names the
//    leaf of at most 2^stride_log rows that holds it; a binary search of
//    that leaf in device memory is stride_log dependent loads (6 at config
//    3), whose last steps fall in lines already in L1. (Narrowing the leaf
//    to 16 rows and counting them in one round of independent loads read
//    4.77-4.87 us a launch at config 3 on an H100, against this search's
//    4.28-4.32: the rounds it saves were L1 hits.)
//  - The upper bound gallops from the lower bound: one load when the key
//    is absent, two when it is unique (the common case for the executor's
//    distinct tables). A longer run takes the index's upper bound, then a
//    leaf search from the second row: stride_log more loads, whatever the
//    run's length.
//  - 128 threads a block, so a 2048-lane chunk spreads over 16 SMs.
//  - One output buffer: mult at out[0, n), start at out[n, 2n).
// int64 keys as they are: no packing, no clamping, no sentinels (INT64_MIN
// and INT64_MAX are keys like any other); an invalid lane keeps its lower
// bound and gets mult 0. m = 0 gives mult 0 and start 0 everywhere.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kIndexMax = 4096;  // index keys a block stages (32 KB)
constexpr int kMinStrideLog = 6;

// First i in [lo, hi) with a[i] >= k (kUpper: a[i] > k); hi if none.
template <bool kUpper>
__device__ __forceinline__ long long bound_in(const long long* __restrict__ a,
                                              long long lo, long long hi,
                                              long long k) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const long long v = a[mid];
    if (kUpper ? v <= k : v < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
chunk_rank_kernel(const long long* __restrict__ table, long long m, int stride_log,
                  const long long* __restrict__ keys,
                  const unsigned char* __restrict__ valid, long long n,
                  int* __restrict__ out) {
  __shared__ long long index[kIndexMax];
  const int n_index = static_cast<int>((m + (1LL << stride_log) - 1) >> stride_log);
  for (int i = threadIdx.x; i < n_index; i += kThreads) {
    index[i] = table[static_cast<long long>(i) << stride_log];
  }
  __syncthreads();
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= n) return;
  const long long k = keys[lane];

  // the index entries < k: the lower bound lies past entry j - 1's row and
  // at or before entry j's
  int lo = 0, hi = n_index;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (index[mid] < k) lo = mid + 1; else hi = mid;
  }
  const int j = lo;
  long long first = 0;
  if (j > 0) {
    const long long leaf_end = static_cast<long long>(j) << stride_log;
    first = bound_in<false>(table, (static_cast<long long>(j - 1) << stride_log) + 1,
                            leaf_end < m ? leaf_end : m, k);
  }

  int count = 0;
  if (valid[lane] && first < m && table[first] == k) {
    long long last = first + 1;  // the first row > k lies in [last, m]
    if (last < m && table[last] == k) {
      // the index entries <= k: at least j, and at least 1 (entry 0 is
      // table[0] <= k)
      int lo2 = j, hi2 = n_index;
      while (lo2 < hi2) {
        const int mid = (lo2 + hi2) >> 1;
        if (index[mid] <= k) lo2 = mid + 1; else hi2 = mid;
      }
      const long long leaf_lo = (static_cast<long long>(lo2 - 1) << stride_log) + 1;
      const long long leaf_end = static_cast<long long>(lo2) << stride_log;
      last = bound_in<true>(table, leaf_lo > last + 1 ? leaf_lo : last + 1,
                            leaf_end < m ? leaf_end : m, k);
    }
    count = static_cast<int>(last - first);
  }
  out[lane] = count;
  out[n + lane] = static_cast<int>(first);
}

}  // namespace

// table: int64[m] ascending; keys: int64[n]; valid: bool[n] (one byte a
// lane); out: int32[2, n], mult then start. stride_log: the index samples
// every 2^stride_log-th row; it must be >= 6 and leave at most 4096 index
// keys.
extern "C" int ccve_chunk_rank_i64(const void* table, long long m, int stride_log,
                                   const void* keys, const void* valid, long long n,
                                   void* out, void* stream) {
  if (m < 0 || n < 0 || m > 0x7FFFFFFFLL ||
      stride_log < kMinStrideLog || stride_log > 31 ||
      ((m + (1LL << stride_log) - 1) >> stride_log) > kIndexMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long grid = (n + kThreads - 1) / kThreads;
  chunk_rank_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), m, stride_log,
      static_cast<const long long*>(keys), static_cast<const unsigned char*>(valid), n,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
