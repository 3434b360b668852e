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
// What bounds it on an H100: the binary searches' dependent loads. Each
// thread makes two searches of log2(run_len) steps per run; neighbouring
// build rows search neighbouring positions, so the upper steps of a warp's
// searches hit the same lines in L1/L2 and the bytes from device memory
// stay near one read of the probe buffer and of b. Latency of the
// dependent loads, not bandwidth, sets the time.
//
// Design: one thread per build row. It binary-searches the lower bound of
// b[j] - 1 and of b[j] in each run, restricted to the real probes, and
// sums the differences over all runs in one launch, then writes bc[j]. No
// merge, no scan, no carried state, no atomics: each output is owned by
// one thread, so block order does not matter, and the dense output falls
// out of the indexing instead of a compaction ring. The int64 build needs
// no merge with the build stream either, so JAX's per-run limb merge has
// no counterpart.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// First index in [lo, hi) of ascending a with a[i] >= v (hi if none).
template <typename K>
__device__ __forceinline__ long long lower_bound(const K* __restrict__ a,
                                                 long long lo, long long hi,
                                                 K v) {
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

template <typename K>
__global__ void merge_counts_kernel(const K* __restrict__ runs,
                                    long long run_len, long long n_real,
                                    const K* __restrict__ b, long long m,
                                    int* __restrict__ bc) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const K key = b[j];  // odd: key - 1 is the even probe value that matches
  int count = 0;
  for (long long lo = 0; lo < n_real; lo += run_len) {
    const long long hi = lo + run_len < n_real ? lo + run_len : n_real;
    const long long first = lower_bound<K>(runs, lo, hi, key - 1);
    count += static_cast<int>(lower_bound<K>(runs, first, hi, key) - first);
  }
  bc[j] = count;
}

template <typename K>
int launch(const void* runs, long long run_len, long long n_real,
           const void* b, long long m, void* bc, void* stream) {
  if (run_len < 1 || n_real < 0 || m < 0 || m > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const long long blocks = (m + kThreads - 1) / kThreads;
  merge_counts_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(runs), run_len, n_real, static_cast<const K*>(b),
      m, static_cast<int*>(bc));
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
