// Stream compaction: the rows j of C int32 planes (a [C, n] array) where
// mask[j] holds, packed to the front in their order, and their count.
//
// Replaces: ccve_tpu/kernels/compact.py `_make_ring_kernel` (entries
// `pallas_compact_i32`, `pallas_compact`): per (R, 128) tile a
// Hillis-Steele rank and a butterfly compaction in log2(tile) shift
// rounds (the VPU has no compress instruction and no scatter), then an
// append into a VMEM ring that flushes whole blocks to HBM, with the ring
// fill and the output row carried from one grid step to the next. The TPU
// path takes that kernel only when the candidate count is a multiple of
// 128 (a lane constraint); this one takes any n.
//
// What bounds it on an H100: device memory. The mask is read twice and
// each selected row's C planes are read and written once; the ranks are a
// warp vote and a popcount per element.
//
// Design: three launches, since blocks run in no order and nothing
// carries between them. (1) Each block counts the selected rows of its
// chunk (__syncthreads_count). (2) One block turns the per-block counts
// into exclusive offsets in place and writes the total. (3) Each block
// walks its chunk in rounds of one element per thread: a warp ballot and
// a popcount rank each selected element within its warp, the warps'
// counts in shared memory rank it within the round, and it is written to
// its block offset plus the rows before it, so the output keeps the input
// order. No atomics, so the output is the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

__global__ void compact_count_kernel(const unsigned char* __restrict__ mask,
                                     long long n,
                                     long long* __restrict__ block_count) {
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  int total = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long j = base + k * kThreads + threadIdx.x;
    total += __syncthreads_count(j < n && mask[j] != 0);
  }
  if (threadIdx.x == 0) block_count[blockIdx.x] = total;
}

// One block: block_count[b] becomes the rows selected before block b;
// *count gets the total.
__global__ void compact_scan_kernel(long long* __restrict__ block_count,
                                    long long n_blocks,
                                    long long* __restrict__ count) {
  __shared__ long long buf[2 * kScanThreads];
  __shared__ long long tile_total;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  long long carry = 0;
  for (long long off = 0; off < n_blocks; off += nt) {
    const long long i = off + t;
    int in = 0;
    buf[t] = i < n_blocks ? block_count[i] : 0;
    __syncthreads();
    for (int d = 1; d < nt; d <<= 1) {
      long long x = buf[in * nt + t];
      if (t >= d) x += buf[in * nt + t - d];
      buf[(in ^ 1) * nt + t] = x;
      __syncthreads();
      in ^= 1;
    }
    const long long incl = buf[in * nt + t];
    const long long excl = t ? buf[in * nt + t - 1] : 0;
    if (i < n_blocks) block_count[i] = carry + excl;
    if (t == nt - 1) tile_total = incl;
    __syncthreads();
    carry += tile_total;
    __syncthreads();
  }
  if (t == 0) *count = carry;
}

__global__ void compact_write_kernel(const int* __restrict__ planes,
                                     const unsigned char* __restrict__ mask,
                                     long long n, int n_planes,
                                     const long long* __restrict__ offset,
                                     int* __restrict__ out) {
  __shared__ int warp_count[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long pos = offset[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long j = base + k * kThreads + threadIdx.x;
    const bool keep = j < n && mask[j] != 0;
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) warp_count[warp] = __popc(votes);
    __syncthreads();
    int before = 0;
    int round = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_count[w] : 0;
      round += warp_count[w];
    }
    if (keep) {
      const long long dst = pos + before + __popc(votes & ((1u << lane) - 1u));
      for (int p = 0; p < n_planes; ++p) out[p * n + dst] = planes[p * n + j];
    }
    pos += round;
    __syncthreads();
  }
}

}  // namespace

// Bytes of scratch the wrapper allocates for n elements.
extern "C" long long ccve_compact_scratch_bytes(long long n) {
  return ((n + kChunk - 1) / kChunk) * static_cast<long long>(sizeof(long long));
}

// planes, out: int32[n_planes, n] (out rows past the count are left as
// they are); mask: bool[n]; count: one int64; scratch: as sized above.
extern "C" int ccve_compact_i32(const void* planes, const void* mask,
                                long long n, int n_planes, void* scratch,
                                void* out, void* count, void* stream) {
  if (n < 0 || n > 0x7FFFFFFFLL || n_planes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* counts = static_cast<long long*>(scratch);
  if (n == 0) {
    return static_cast<int>(
        cudaMemsetAsync(count, 0, sizeof(long long), st));
  }
  const long long blocks = (n + kChunk - 1) / kChunk;
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  compact_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      m, n, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scan_kernel<<<1, kScanThreads, 0, st>>>(
      counts, blocks, static_cast<long long*>(count));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_write_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int*>(planes), m, n, n_planes, counts,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
