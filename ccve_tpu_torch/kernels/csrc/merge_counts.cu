// Merge counts: bc[j] = the number of real probes p, over all sorted probe
// runs, with p == b32[j] - 1.
//
// Input: a buffer of probe runs, each of run_len int32 values (the last
// one may be shorter) sorted ascending, whose first n_real values are the
// real probes (packed key' << 1, even; the sort padding, INT32_MAX, sorts
// to the end of the last run); and the build stream b32 (key' << 1 | 1,
// odd, ascending, keys may repeat). Output: bc int32[m]. Every build row
// of a repeated key gets the full count of its key.
//
// Replaces: ccve_tpu/kernels/merge_scan.py `_make_merge_counts_kernel`
// with `_counts_scan_tile` (the `merge_counts_fused` entry, one launch per
// run: merges the run with the reversed build stream tile by tile, scans
// each merged tile for per-build probe counts, compacts them densely
// through a VMEM ring, and carries cursors, running counts and the ring
// fill in SMEM from one sequential grid step to the next).
//
// What bounds it on an H100: the binary searches' dependent loads. Each
// thread makes two searches of log2(run_len) steps per run; neighbouring
// build rows search neighbouring positions, so the upper steps of a warp's
// searches hit the same lines in L1/L2 and the bytes from device memory
// stay near one read of the probe buffer and of b32. Latency of the
// dependent loads, not bandwidth, sets the time.
//
// Design: one thread per build row. It binary-searches the lower bound of
// b32[j] - 1 and of b32[j] in each run, restricted to the real probes, and
// sums the differences over all runs in one launch, then writes bc[j]. No
// merge, no scan, no carried state, no atomics: each output is owned by
// one thread, so block order does not matter, and the dense output falls
// out of the indexing instead of a compaction ring.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// First index in [lo, hi) of ascending a with a[i] >= v (hi if none).
__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long lo, long long hi,
                                                 int v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void merge_counts_kernel(const int* __restrict__ runs,
                                    long long run_len, long long n_real,
                                    const int* __restrict__ b32, long long m,
                                    int* __restrict__ bc) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int b = b32[j];  // odd: b - 1 is the even probe value that matches
  int count = 0;
  for (long long lo = 0; lo < n_real; lo += run_len) {
    const long long hi = lo + run_len < n_real ? lo + run_len : n_real;
    const long long first = lower_bound(runs, lo, hi, b - 1);
    count += static_cast<int>(lower_bound(runs, first, hi, b) - first);
  }
  bc[j] = count;
}

}  // namespace

extern "C" int ccve_merge_counts_i32(const void* runs, long long run_len,
                                     long long n_real, const void* b32,
                                     long long m, void* bc, void* stream) {
  if (run_len < 1 || n_real < 0 || m < 0 || m > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const long long blocks = (m + kThreads - 1) / kThreads;
  merge_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(runs), run_len, n_real,
      static_cast<const int*>(b32), m, static_cast<int*>(bc));
  return static_cast<int>(cudaGetLastError());
}
