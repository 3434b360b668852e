// Multi-plane merges: int32 or int64 keys carrying P int32 cargo planes
// (P = 1..3); each entry point has an _i32 and an _i64 build.
//
//  - ccve_merge_level_multi_i32: one ladder level. Each pair of ascending
//    runs of L = 2^run_log, [2pL, 2pL + L) and [2pL + L, 2pL + 2L),
//    becomes one ascending run of 2L; the last pair may have a short
//    second run, or none.
//  - ccve_merge_two_multi_i32: the unequal merge of two ascending streams
//    A[0, na) and B[0, nb) into one of na + nb (either may be empty).
//
// Both are stable: at equal keys A's elements come first, and each
// stream keeps its own order, so a ladder over stably sorted tiles is a
// stable sort.
//
// Replaces: ccve_tpu/kernels/pairsort.py `_make_merge_kernel_multi` (the
// bitonic lower-half merge-path kernel with value planes, launched per
// ladder level by `_sort_padded_multi` and once by
// `_merge_two_padded_multi` with B stored reversed; its tile splits come
// precomputed from the XLA bisections `_merge_splits_alt` and
// `_merge_splits_two`); the int64 builds replace `_make_merge_kernel_multi64`
// (the same kernel on (hi, lo) int32 limb planes, launched by
// `_sort_padded_multi64` and `merge_sorted_multi_i64`).
//
// What bounds it on an H100: each launch reads and writes every key and
// every plane once, (1 + P) * 8 bytes per element for int32 keys and
// (2 + P) * 8 for int64, so device-memory bandwidth bounds it; the merge
// itself is a few compares per element.
//
// Design: merge_level.cu's, with cargo. CUDA blocks run in no order, so
// each block owns a fixed range of kChunk outputs and finds its own start
// and end on the merge-path diagonal by binary search on the keys. It
// stages the two key slices in shared memory; each thread finds its
// kPerThread outputs by a second merge-path search there and merges them
// serially, recording for each output the slot it came from. The block
// then writes the keys back coalesced and, for each plane, copies the
// value from the recorded slot (two monotone streams of reads, so the
// loads stay near coalesced). B is ascending: nothing is stored
// reversed, and empty streams and the ragged last pair fall out of the
// split arithmetic. The int64 key is native (no limbs); the shared staging
// grows from 16 KB to 24 KB and stays static, under the 48 KB limit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // outputs per block
constexpr int kMaxPlanes = 3;

struct InPlanes {
  const int* p[kMaxPlanes];
};
struct OutPlanes {
  int* p[kMaxPlanes];
};

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
struct Shared {
  K key[kChunk];
  int src[kChunk];  // a-slot i as i, b-slot j as ~j
  long long split[2];
};

// Outputs [d0, d1) of the stable merge of (a, av)[0, la) and (b, bv)[0, lb)
// go to (y, yv)[out0, out0 + d1 - d0).
template <typename K, int P>
__device__ void merge_chunk(const K* a, const InPlanes& av, long long la,
                            const K* b, const InPlanes& bv, long long lb,
                            long long d0, long long d1, K* y,
                            const OutPlanes& yv, long long out0, Shared<K>& sh) {
  if (threadIdx.x < 2) {
    sh.split[threadIdx.x] = merge_path(a, la, b, lb, threadIdx.x ? d1 : d0);
  }
  __syncthreads();
  const long long a0 = sh.split[0];
  const long long b0 = d0 - a0;
  const int na = static_cast<int>(sh.split[1] - a0);
  const int cnt = static_cast<int>(d1 - d0);
  const int nb = cnt - na;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    sh.key[i] = i < na ? a[a0 + i] : b[b0 + i - na];
  }
  __syncthreads();

  const K* s = sh.key;
  const int first = static_cast<int>(threadIdx.x) * kPerThread;
  const int diag = first < cnt ? first : cnt;
  int ai = static_cast<int>(merge_path<K>(s, na, s + na, nb, diag));
  int bi = diag - ai;
  K out_key[kPerThread];
  int out_src[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (diag + k < cnt) {
      const bool take_a = ai < na && (bi >= nb || s[ai] <= s[na + bi]);
      if (take_a) {
        out_key[k] = s[ai];
        out_src[k] = ai++;
      } else {
        out_key[k] = s[na + bi];
        out_src[k] = ~(bi++);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (diag + k < cnt) {
      sh.key[diag + k] = out_key[k];
      sh.src[diag + k] = out_src[k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    y[out0 + i] = sh.key[i];
    const int e = sh.src[i];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      yv.p[p][out0 + i] = e >= 0 ? av.p[p][a0 + e] : bv.p[p][b0 + ~e];
    }
  }
}

template <typename K, int P>
__global__ void merge_level_multi_kernel(const K* __restrict__ x,
                                         InPlanes xv, K* __restrict__ y,
                                         OutPlanes yv, long long n,
                                         int run_log) {
  __shared__ Shared<K> sh;
  const long long L = 1LL << run_log;
  const long long chunk = kChunk < 2 * L ? kChunk : 2 * L;  // divides 2L
  const long long out0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long a_base = (out0 >> (run_log + 1)) << (run_log + 1);
  const long long la = n - a_base < L ? n - a_base : L;
  long long lb = n - a_base - L < L ? n - a_base - L : L;
  if (lb < 0) lb = 0;
  InPlanes av;
  InPlanes bv;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    av.p[p] = xv.p[p] + a_base;
    bv.p[p] = av.p[p] + la;  // la < L only if lb == 0
  }
  const K* a = x + a_base;
  const long long d0 = out0 - a_base;
  const long long d1 = d0 + chunk < la + lb ? d0 + chunk : la + lb;
  merge_chunk<K, P>(a, av, la, a + la, bv, lb, d0, d1, y, yv, out0, sh);
}

template <typename K, int P>
__global__ void merge_two_multi_kernel(const K* __restrict__ a,
                                       InPlanes av, long long na,
                                       const K* __restrict__ b,
                                       InPlanes bv, long long nb,
                                       K* __restrict__ y, OutPlanes yv) {
  __shared__ Shared<K> sh;
  const long long d0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long d1 = d0 + kChunk < na + nb ? d0 + kChunk : na + nb;
  merge_chunk<K, P>(a, av, na, b, bv, nb, d0, d1, y, yv, d0, sh);
}

InPlanes in_planes(const void* v0, const void* v1, const void* v2) {
  return InPlanes{{static_cast<const int*>(v0), static_cast<const int*>(v1),
                   static_cast<const int*>(v2)}};
}

OutPlanes out_planes(void* v0, void* v1, void* v2) {
  return OutPlanes{
      {static_cast<int*>(v0), static_cast<int*>(v1), static_cast<int*>(v2)}};
}

template <typename K, int P>
int launch_level(const K* x, InPlanes xv, K* y, OutPlanes yv, long long n,
                 int run_log, cudaStream_t stream) {
  const long long two_l = 2LL << run_log;
  const long long chunk = kChunk < two_l ? kChunk : two_l;
  const long long blocks = (n + chunk - 1) / chunk;
  merge_level_multi_kernel<K, P><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   stream>>>(x, xv, y, yv, n, run_log);
  return static_cast<int>(cudaGetLastError());
}

template <typename K, int P>
int launch_two(const K* a, InPlanes av, long long na, const K* b,
               InPlanes bv, long long nb, K* y, OutPlanes yv,
               cudaStream_t stream) {
  const long long blocks = (na + nb + kChunk - 1) / kChunk;
  merge_two_multi_kernel<K, P><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(a, av, na, b, bv, nb, y, yv);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int level_planes(const void* xk, const void* xv0, const void* xv1,
                 const void* xv2, void* yk, void* yv0, void* yv1, void* yv2,
                 int n_planes, long long n, int run_log, void* stream) {
  if (n < 0 || n > 0x7FFFFFFFLL || run_log < 0 || run_log > 30 ||
      n_planes < 1 || n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const K* x = static_cast<const K*>(xk);
  const InPlanes xv = in_planes(xv0, xv1, xv2);
  K* y = static_cast<K*>(yk);
  const OutPlanes yv = out_planes(yv0, yv1, yv2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 1:
      return launch_level<K, 1>(x, xv, y, yv, n, run_log, st);
    case 2:
      return launch_level<K, 2>(x, xv, y, yv, n, run_log, st);
    default:
      return launch_level<K, 3>(x, xv, y, yv, n, run_log, st);
  }
}

template <typename K>
int two_planes(const void* ak, const void* av0, const void* av1,
               const void* av2, long long na, const void* bk, const void* bv0,
               const void* bv1, const void* bv2, long long nb, void* yk,
               void* yv0, void* yv1, void* yv2, int n_planes, void* stream) {
  if (na < 0 || nb < 0 || na + nb > 0x7FFFFFFFLL || n_planes < 1 ||
      n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (na + nb == 0) return 0;
  const K* a = static_cast<const K*>(ak);
  const K* b = static_cast<const K*>(bk);
  const InPlanes av = in_planes(av0, av1, av2);
  const InPlanes bv = in_planes(bv0, bv1, bv2);
  K* y = static_cast<K*>(yk);
  const OutPlanes yv = out_planes(yv0, yv1, yv2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 1:
      return launch_two<K, 1>(a, av, na, b, bv, nb, y, yv, st);
    case 2:
      return launch_two<K, 2>(a, av, na, b, bv, nb, y, yv, st);
    default:
      return launch_two<K, 3>(a, av, na, b, bv, nb, y, yv, st);
  }
}

}  // namespace

// Planes past n_planes may be null.
extern "C" int ccve_merge_level_multi_i32(const void* xk, const void* xv0,
                                          const void* xv1, const void* xv2,
                                          void* yk, void* yv0, void* yv1,
                                          void* yv2, int n_planes,
                                          long long n, int run_log,
                                          void* stream) {
  return level_planes<int>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, n_planes, n,
                           run_log, stream);
}

extern "C" int ccve_merge_level_multi_i64(const void* xk, const void* xv0,
                                          const void* xv1, const void* xv2,
                                          void* yk, void* yv0, void* yv1,
                                          void* yv2, int n_planes,
                                          long long n, int run_log,
                                          void* stream) {
  return level_planes<long long>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2,
                                 n_planes, n, run_log, stream);
}

extern "C" int ccve_merge_two_multi_i32(const void* ak, const void* av0,
                                        const void* av1, const void* av2,
                                        long long na, const void* bk,
                                        const void* bv0, const void* bv1,
                                        const void* bv2, long long nb,
                                        void* yk, void* yv0, void* yv1,
                                        void* yv2, int n_planes,
                                        void* stream) {
  return two_planes<int>(ak, av0, av1, av2, na, bk, bv0, bv1, bv2, nb, yk,
                         yv0, yv1, yv2, n_planes, stream);
}

extern "C" int ccve_merge_two_multi_i64(const void* ak, const void* av0,
                                        const void* av1, const void* av2,
                                        long long na, const void* bk,
                                        const void* bv0, const void* bv1,
                                        const void* bv2, long long nb,
                                        void* yk, void* yv0, void* yv1,
                                        void* yv2, int n_planes,
                                        void* stream) {
  return two_planes<long long>(ak, av0, av1, av2, na, bk, bv0, bv1, bv2, nb,
                               yk, yv0, yv1, yv2, n_planes, stream);
}
