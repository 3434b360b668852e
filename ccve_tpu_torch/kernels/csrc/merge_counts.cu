// Build counts of the count side, two kernels.
//
//  - ccve_merge_counts_i32 / _i64, the merge counts: bc[j] = the number of
//    real probes p, over all sorted probe runs, with p == b[j] - 1. One
//    build for int32 streams, one for int64.
//  - ccve_merge_build_counts_i32, the dense counts of one merged stream
//    (below the merge counts' notes).
//
// The merge counts.
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

// The dense counts. Input: one merged, ascending int32 stream s[0, L) of
// `key' << 1 | tag`, builds odd (tag 1) and probes even, so a key's probes
// precede its builds; INT32_MAX entries are phantom builds, which sort
// last. Output: bc int32[m], bc[j] = the probes in the run of the j-th
// build entry of the stream (table row j, for a pre-sorted table); build
// entries past the m-th, the phantoms among them, are dropped.
//
// Replaces: ccve_tpu/kernels/merge_scan.py `_make_counts32_dense_kernel`
// (entry `merge_scan_build_counts` :491), which scans [256, 128] tiles in
// order, carrying the probe count and the run base in SMEM, and compacts
// each tile's build counts through an in-register butterfly and a VMEM
// ring flushed R rows at a time.
//
// What bounds it on an H100: device memory. Each of the two scan passes
// reads the stream once (4 bytes an element) and the second writes bc
// (4 bytes a build); a few operations an element.
//
// Design: seg_scan.cuh's two-pass block scan of (run start, probes since
// the run start, builds since the stream start): the first is segmented,
// the second is not and gives each build its rank. Pass 2 writes
// bc[rank] directly, so the ring buffer, the butterfly compaction and the
// carried cursor have no job: blocks run in any order and each output has
// one writer.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

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

// A segment of the dense counts' stream: whether it holds a run start, the
// probes since its last run start (or over all of it), and all its builds.
struct CountSeg {
  int start;
  int probes;
  int builds;

  static __device__ __forceinline__ CountSeg identity() {
    return CountSeg{0, 0, 0};
  }
  static __device__ __forceinline__ CountSeg combine(const CountSeg& a,
                                                     const CountSeg& b) {
    return CountSeg{a.start | b.start, b.start ? b.probes : a.probes + b.probes,
                    a.builds + b.builds};
  }
};

struct DenseCounts {
  using Seg = CountSeg;
  struct Shared {
    int s[seg_scan::kChunk];
    int prev;
  };
  const int* s;
  long long m;
  int* bc;

  __device__ int load(Shared& sh, long long base, long long L) const {
    const long long left = L - base;
    const int cnt = static_cast<int>(left < seg_scan::kChunk ? left : seg_scan::kChunk);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) sh.s[i] = s[base + i];
    if (threadIdx.x == 0) sh.prev = base > 0 ? s[base - 1] : 0;
    return cnt;
  }
  __device__ Seg element(const Shared& sh, int j, bool first) const {
    const int x = sh.s[j];
    const int prev = j ? sh.s[j - 1] : sh.prev;
    const int build = x & 1;
    return Seg{first || (x >> 1) != (prev >> 1), 1 - build, build};
  }
  __device__ void emit(const Shared& sh, int j, long long, const Seg& run) const {
    const long long rank = static_cast<long long>(run.builds) - 1;
    if ((sh.s[j] & 1) && rank < m) bc[rank] = run.probes;
  }
};

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

// Bytes of scratch the dense counts need for a stream of L elements.
extern "C" long long ccve_merge_build_counts_scratch_bytes(long long L) {
  return seg_scan::scratch_bytes<CountSeg>(L);
}

// s: int32[L]; bc: int32[m], zeroed by the caller (ranks the stream does
// not reach stay 0).
extern "C" int ccve_merge_build_counts_i32(const void* s, long long L,
                                           long long m, void* scratch,
                                           void* bc, void* stream) {
  if (m < 0 || m > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const DenseCounts p{static_cast<const int*>(s), m, static_cast<int*>(bc)};
  return seg_scan::run(p, L, scratch, static_cast<cudaStream_t>(stream));
}
