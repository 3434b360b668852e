// Merge level: merges each pair of ascending runs of L = 2^run_log keys,
// [2pL, 2pL + L) and [2pL + L, 2pL + 2L), into one ascending run of 2L. The
// last pair may have a short second run, or none. One build for int32
// keys, one for int64.
//
// Replaces: ccve_tpu/kernels/bigsort.py `_make_carried_merge_kernel` (one
// level of `_sort_padded_buf`'s merge ladder: per output tile, the bitonic
// lower half of an A window and a reversed B window, with the two read
// cursors carried in SMEM from one sequential grid step to the next), and
// for int64 keys ccve_tpu/kernels/pairsort.py `_make_merge_kernel_multi64`
// as `_sort_padded_multi64_capped` runs it with no cargo (limb keys).
//
// What bounds it on an H100: each level reads and writes every key once
// (8 or 16 bytes), so device-memory bandwidth bounds a level; the merge
// itself is a few compares per element.
//
// Design: CUDA blocks run in no order, so no cursor can be carried from
// one block to the next. Each block owns a fixed range of kChunk outputs
// and finds its own start and end by a binary search on the merge-path
// diagonal (as `bigsort._merge_splits_alt` does in XLA on the TPU side).
// It stages the two input slices it needs in shared memory (8 KB of int32
// or 16 KB of int64, static), with coalesced loads; each thread then finds
// its own kPerThread outputs by a second merge-path search in shared memory
// and merges them serially; the block writes its outputs back through
// shared memory, coalesced. Ties take the first run's value first, so the
// merge is stable. Every level writes ascending runs: the TPU's descending
// storage and force_asc have no job.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // outputs per block

// Number of a-values among the first d outputs of the stable merge of
// ascending a[0, na) and b[0, nb): the least i with a[i] > b[d - i - 1].
template <typename K>
__device__ long long merge_path(const K* a, long long na, const K* b,
                                long long nb, long long d) {
  long long lo = d - nb > 0 ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - mid - 1]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename K>
__global__ void merge_level_kernel(const K* __restrict__ x,
                                   K* __restrict__ y, long long n,
                                   int run_log) {
  __shared__ K s[kChunk];
  __shared__ long long split[2];
  const long long L = 1LL << run_log;
  const long long chunk = kChunk < 2 * L ? kChunk : 2 * L;  // divides 2L
  const long long out0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long a_base = (out0 >> (run_log + 1)) << (run_log + 1);
  const long long la = n - a_base < L ? n - a_base : L;
  long long lb = n - a_base - L < L ? n - a_base - L : L;
  if (lb < 0) lb = 0;
  const K* A = x + a_base;
  const K* B = A + la;  // B's data starts at a_base + L; la < L only if lb == 0
  const long long d0 = out0 - a_base;
  const long long d1 = d0 + chunk < la + lb ? d0 + chunk : la + lb;

  if (threadIdx.x < 2) {
    split[threadIdx.x] = merge_path(A, la, B, lb, threadIdx.x ? d1 : d0);
  }
  __syncthreads();
  const long long a0 = split[0];
  const long long b0 = d0 - a0;
  const int na = static_cast<int>(split[1] - a0);
  const int cnt = static_cast<int>(d1 - d0);
  const int nb = cnt - na;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    s[i] = i < na ? A[a0 + i] : B[b0 + i - na];
  }
  __syncthreads();

  const int first = static_cast<int>(threadIdx.x) * kPerThread;
  const int diag = first < cnt ? first : cnt;
  int ai = static_cast<int>(merge_path<K>(s, na, s + na, nb, diag));
  int bi = diag - ai;
  K out[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (diag + k < cnt) {
      const bool take_a = ai < na && (bi >= nb || s[ai] <= s[na + bi]);
      out[k] = take_a ? s[ai++] : s[na + bi++];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (diag + k < cnt) s[diag + k] = out[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) y[out0 + i] = s[i];
}

template <typename K>
int launch(const void* x, void* y, long long n, int run_log, void* stream) {
  if (n < 0 || n > 0x7FFFFFFFLL || run_log < 0 || run_log > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long two_l = 2LL << run_log;
  const long long chunk = kChunk < two_l ? kChunk : two_l;
  const long long blocks = (n + chunk - 1) / chunk;
  merge_level_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(x), static_cast<K*>(y), n, run_log);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ccve_merge_level_i32(const void* x, void* y, long long n,
                                    int run_log, void* stream) {
  return launch<int>(x, y, n, run_log, stream);
}

extern "C" int ccve_merge_level_i64(const void* x, void* y, long long n,
                                    int run_log, void* stream) {
  return launch<long long>(x, y, n, run_log, stream);
}
