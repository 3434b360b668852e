// Tile sort: sorts every tile of T = 2^tile_log keys ascending; one build
// for int32 keys, one for int64.
//
// Replaces: ccve_tpu/kernels/bigsort.py `_make_local_kernel` (the in-VMEM
// Batcher presort that `_sort_padded_buf` launches once per 2^17-element
// tile, with odd tiles stored descending for its bitonic merge levels),
// and for int64 keys ccve_tpu/kernels/pairsort.py `_make_local_kernel_multi64`
// as `pallas_sort_i64_limbs` runs it with no cargo (the key held as
// (hi, lo) int32 limbs, a three-operation compare per exchange, because
// Mosaic has no 64-bit lanes).
//
// What bounds it on an H100: device memory sees one read and one write of
// each key (8 or 16 bytes), far below the card's bandwidth; the work is the
// tile_log * (tile_log + 1) / 2 compare-exchange stages of the network,
// each a pass over the tile in shared memory followed by a block barrier.
// So shared-memory bandwidth and barrier count bound it.
//
// Design: one block per tile, the whole tile in dynamic shared memory, a
// bitonic sorting network whose stages each thread walks in strides of the
// block size. The TPU tile of 2^17 (512 KB, sized for 100 MB of VMEM) does
// not fit a block's shared memory; the port's tile is at most 2^13 keys.
// For int32 that is 32 KB, under the 48 KB a block may take without opting
// in, so two blocks of 1024 threads fit on an SM. The int64 build keeps the
// same 2^13 tile, so the count side's ladder plan does not depend on the
// key type: 64 KB, above 48 KB, so its launch raises the kernel's
// dynamic shared-memory limit with cudaFuncSetAttribute first and reports
// a refusal. The 64-bit key is native here: no limbs. Every tile is stored
// ascending: the merge levels (merge_level.cu) merge by merge path, so the
// TPU's alternating descending storage has no job here.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTileLog = 13;
constexpr int kMaxThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename K>
__global__ void sort_tiles_kernel(const K* __restrict__ x, K* __restrict__ y,
                                  int tile_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* s = reinterpret_cast<K*>(smem);
  const int T = 1 << tile_log;
  const long long base = static_cast<long long>(blockIdx.x) << tile_log;
  for (int i = threadIdx.x; i < T; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  // Bitonic network: stage (k, j) compare-exchanges i with i + j for every
  // i with bit j clear, ascending where bit k of i is clear. Pair t's lower
  // index is t with a zero bit inserted at position log2(j).
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (T >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const K a = s[i];
        const K b = s[i + j];
        const bool ascending = (i & k) == 0;
        if ((a > b) == ascending) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) y[base + i] = s[i];
}

template <typename K>
int launch(const void* x, void* y, long long n_tiles, int tile_log,
           void* stream) {
  if (tile_log < 1 || tile_log > kMaxTileLog || n_tiles < 0 ||
      n_tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const int T = 1 << tile_log;
  const int threads = (T >> 1) < kMaxThreads ? (T >> 1) : kMaxThreads;
  const size_t smem = static_cast<size_t>(T) * sizeof(K);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_tiles_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sort_tiles_kernel<K><<<static_cast<unsigned>(n_tiles), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(x), static_cast<K*>(y), tile_log);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ccve_sort_tiles_i32(const void* x, void* y, long long n_tiles,
                                   int tile_log, void* stream) {
  return launch<int>(x, y, n_tiles, tile_log, stream);
}

extern "C" int ccve_sort_tiles_i64(const void* x, void* y, long long n_tiles,
                                   int tile_log, void* stream) {
  return launch<long long>(x, y, n_tiles, tile_log, stream);
}
