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
// What bounds it on an H100: the network's tile_log * (tile_log + 1) / 2
// stages, each a pass over shared memory and a block barrier. Device
// memory sees one read and one write of the key and of each plane.
//
// Design: the network sorts one 64-bit word per element, (key << 32) |
// tile-local index, so ties break on the original position (stable) and
// the cargo never enters the network: after the sort each output slot
// reads its planes from the input row that its index names (a gather
// within the tile's 32 KB, served by L1/L2). Shared memory therefore does
// not grow with P: 8 bytes per element, 64 KB for the 2^13 tile, above
// the 48 KB a block may take without opting in, so the entry point raises
// the kernel's dynamic shared-memory limit with cudaFuncSetAttribute
// before the launch (the alternative, a tile that shrinks with P, is not
// needed). Every tile is stored ascending: the merge levels
// (merge_multi.cu) merge by merge path.
//
// The int64 build cannot pack (key, index) into one word: a packed 64-bit
// key uses every bit. It keeps the key and a 16-bit tile index in two
// shared arrays (T <= 2^13 fits 16 bits) and compares the pairs
// lexicographically, so ties still break on position. That is 10 bytes an
// element, 80 KB for the 2^13 tile, so it opts in the same way. The
// cargo is gathered after the sort as in the int32 build.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxTileLog = 13;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPlanes = 3;

struct InPlanes {
  const int* p[kMaxPlanes];
};
struct OutPlanes {
  int* p[kMaxPlanes];
};

template <int P>
__global__ void sort_tiles_multi_kernel(const int* __restrict__ xk,
                                        InPlanes xv, int* __restrict__ yk,
                                        OutPlanes yv, int tile_log) {
  extern __shared__ long long s[];
  const int T = 1 << tile_log;
  const long long base = static_cast<long long>(blockIdx.x) << tile_log;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const unsigned long long hi =
        static_cast<unsigned long long>(static_cast<long long>(xk[base + i]))
        << 32;
    s[i] = static_cast<long long>(hi | static_cast<unsigned>(i));
  }
  __syncthreads();
  // Bitonic network, as in sort_tiles.cu, on the (key, index) words.
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (T >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const long long a = s[i];
        const long long b = s[i + j];
        const bool ascending = (i & k) == 0;
        if ((a > b) == ascending) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const long long w = s[i];
    yk[base + i] = static_cast<int>(w >> 32);
    const long long src = base + static_cast<int>(w & 0xFFFFFFFFLL);
#pragma unroll
    for (int p = 0; p < P; ++p) yv.p[p][base + i] = xv.p[p][src];
  }
}

// The int64 build: (key, tile index) pairs in two shared arrays.
template <int P>
__global__ void sort_tiles_multi64_kernel(const long long* __restrict__ xk,
                                          InPlanes xv,
                                          long long* __restrict__ yk,
                                          OutPlanes yv, int tile_log) {
  extern __shared__ __align__(16) unsigned char smem64[];
  const int T = 1 << tile_log;
  long long* sk = reinterpret_cast<long long*>(smem64);
  unsigned short* si = reinterpret_cast<unsigned short*>(sk + T);
  const long long base = static_cast<long long>(blockIdx.x) << tile_log;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    sk[i] = xk[base + i];
    si[i] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (T >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const long long a = sk[i];
        const long long b = sk[i + j];
        const unsigned short ia = si[i];
        const unsigned short ib = si[i + j];
        const bool ascending = (i & k) == 0;
        if ((a > b || (a == b && ia > ib)) == ascending) {
          sk[i] = b;
          sk[i + j] = a;
          si[i] = ib;
          si[i + j] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    yk[base + i] = sk[i];
    const long long src = base + si[i];
#pragma unroll
    for (int p = 0; p < P; ++p) yv.p[p][base + i] = xv.p[p][src];
  }
}

// One launch; dynamic shared memory per tile: one word per element for
// the int32 build, a key and a 16-bit index for the int64 build.
template <typename K, int P>
int launch(const K* xk, InPlanes xv, K* yk, OutPlanes yv, long long n_tiles,
           int tile_log, cudaStream_t stream) {
  const int T = 1 << tile_log;
  const int threads = (T >> 1) < kMaxThreads ? (T >> 1) : kMaxThreads;
  const unsigned blocks = static_cast<unsigned>(n_tiles);
  if constexpr (std::is_same_v<K, int>) {
    const size_t smem = static_cast<size_t>(T) * sizeof(long long);
    const cudaError_t err = cudaFuncSetAttribute(
        sort_tiles_multi_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sort_tiles_multi_kernel<P><<<blocks, threads, smem, stream>>>(
        xk, xv, yk, yv, tile_log);
  } else {
    const size_t smem =
        static_cast<size_t>(T) * (sizeof(long long) + sizeof(unsigned short));
    const cudaError_t err = cudaFuncSetAttribute(
        sort_tiles_multi64_kernel<P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sort_tiles_multi64_kernel<P><<<blocks, threads, smem, stream>>>(
        xk, xv, yk, yv, tile_log);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_planes(const void* xk, const void* xv0, const void* xv1,
                  const void* xv2, void* yk, void* yv0, void* yv1, void* yv2,
                  int n_planes, long long n_tiles, int tile_log,
                  void* stream) {
  if (tile_log < 1 || tile_log > kMaxTileLog || n_tiles < 0 ||
      n_tiles > 0x7FFFFFFFLL || n_planes < 1 || n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const InPlanes xv{{static_cast<const int*>(xv0), static_cast<const int*>(xv1),
                     static_cast<const int*>(xv2)}};
  const OutPlanes yv{
      {static_cast<int*>(yv0), static_cast<int*>(yv1), static_cast<int*>(yv2)}};
  const K* k = static_cast<const K*>(xk);
  K* out = static_cast<K*>(yk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 1:
      return launch<K, 1>(k, xv, out, yv, n_tiles, tile_log, st);
    case 2:
      return launch<K, 2>(k, xv, out, yv, n_tiles, tile_log, st);
    default:
      return launch<K, 3>(k, xv, out, yv, n_tiles, tile_log, st);
  }
}

}  // namespace

// Planes past n_planes may be null.
extern "C" int ccve_sort_tiles_multi_i32(const void* xk, const void* xv0,
                                         const void* xv1, const void* xv2,
                                         void* yk, void* yv0, void* yv1,
                                         void* yv2, int n_planes,
                                         long long n_tiles, int tile_log,
                                         void* stream) {
  return launch_planes<int>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, n_planes,
                            n_tiles, tile_log, stream);
}

extern "C" int ccve_sort_tiles_multi_i64(const void* xk, const void* xv0,
                                         const void* xv1, const void* xv2,
                                         void* yk, void* yv0, void* yv1,
                                         void* yv2, int n_planes,
                                         long long n_tiles, int tile_log,
                                         void* stream) {
  return launch_planes<long long>(xk, xv0, xv1, xv2, yk, yv0, yv1, yv2,
                                  n_planes, n_tiles, tile_log, stream);
}
