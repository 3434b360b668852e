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
// What bounds it on an H100: one chunk is `block` lanes (2048 at config
// 3), so a launch is 8 thread blocks on 132 SMs and lasts about as long as
// a launch does. The work is 2 log2(m) dependent loads a lane; the table
// (50,000 int64 rows at config 3, 400 KB) stays in the 50 MB L2 from one
// launch to the next.
//
// Design: one thread a lane, two binary searches over the table in device
// memory (lower bound, then upper bound from it). int64 keys as they are:
// no packing, no clamping, no sentinels; an invalid lane's mult is masked
// to 0. m = 0 gives mult 0 and start 0 everywhere.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void chunk_rank_kernel(const long long* __restrict__ table, long long m,
                                  const long long* __restrict__ keys,
                                  const unsigned char* __restrict__ valid, long long n,
                                  int* __restrict__ mult, int* __restrict__ start) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = keys[i];
  long long lo = 0, hi = m;
  while (lo < hi) {  // first row >= k
    const long long mid = lo + ((hi - lo) >> 1);
    if (table[mid] < k) lo = mid + 1; else hi = mid;
  }
  const long long first = lo;
  hi = m;
  while (lo < hi) {  // first row > k
    const long long mid = lo + ((hi - lo) >> 1);
    if (table[mid] <= k) lo = mid + 1; else hi = mid;
  }
  mult[i] = valid[i] ? static_cast<int>(lo - first) : 0;
  start[i] = static_cast<int>(first);
}

}  // namespace

// table: int64[m] ascending; keys: int64[n]; valid: bool[n] (one byte a
// lane); mult, start: int32[n].
extern "C" int ccve_chunk_rank_i64(const void* table, long long m, const void* keys,
                                   const void* valid, long long n, void* mult, void* start,
                                   void* stream) {
  if (m < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long grid = (n + kThreads - 1) / kThreads;
  chunk_rank_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), m, static_cast<const long long*>(keys),
      static_cast<const unsigned char*>(valid), n, static_cast<int*>(mult),
      static_cast<int*>(start));
  return static_cast<int>(cudaGetLastError());
}
