// Compare-exchange stages: the STAGE_COST calibration of the roofline model
// (ccve_tpu_torch/bench/roofline.py), int32 keys.
//
// Computes: for each stage s = 0..K-1, with k = 1 << (s % 3) (strides 1, 2,
// 4, 1, 2, 4, ... as in a sorting network's last stages), element i and its
// partner i ^ k are compared and exchanged: the one with bit k clear takes
// the min, the other the max. Every pair lies inside an aligned group of 8,
// so the result does not depend on the tile once the tile holds 8 or more
// elements: it equals the TPU kernel's exactly.
//
// Replaces: ccve_tpu/bench/roofline.py `make_ce_kernel` (:208), the Pallas
// kernel that `measure_anchors` runs over [1024, 128] tiles in VMEM, each
// stage two flat shifts (`flatvec.shift_flat_left`, `shift_flat_right`) and
// a select of min and max.
//
// What it is for: its K-slope, (t(64) - t(16)) / 48 stages / n, prices one
// pass over a tile in shared memory (a compare-exchange stage; the
// roofline prices each merge-path round of the port's tile sort,
// csrc/sort_tiles.cu, as one) with a kernel that is not the engine's, so
// the roofline's STAGE_COST is graded by something other than the kernels
// it grades.
//
// What bounds it on an H100: per launch, device memory sees one read and one
// write of each key (8 bytes an element); per stage, the block makes a pass
// over its tile in shared memory (one load and one store of each key) and a
// block barrier. At K = 16 and more, the shared-memory passes and barriers
// dominate.
//
// Design: the shape of the shared-memory bitonic tile sort the port first
// ran. One block per tile of 2^13 keys (the port's sort tile,
// kernels/bigsort.py TILE_LOG; 32 KB of shared memory), min(T / 2, 1024)
// threads, each walking its pairs in strides of the block size with that
// sort's pair indexing (i = 2t - (t & (k - 1)), partner i + k), and
// __syncthreads() after every stage, so each stage is a round trip through
// shared memory. K is a runtime argument: the stage loop is a
// runtime loop, so the compiler cannot unroll stages into one another or
// elide any (the partner of a pair changes from stage to stage, and the
// barrier orders the shared-memory stores). A variant in which each thread
// holds 8 neighbours in registers would let the compiler fuse all K stages
// into register operations between one load and one store; that would price
// register work, not the shared-memory pass it is here to price, so this
// kernel does not do it.
// Both keys of a pair are stored every stage, swapped or not: one round of
// strides 1, 2, 4 reaches a fixed point (no later stage swaps anything), so
// a store only on a swap, as that sort made, would price every stage
// past the third as a pass that only reads. With both stores the stage cost
// does not depend on the data.

#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 13;
constexpr int kTile = 1 << kTileLog;
constexpr int kThreads = 1024;  // 4 of the tile's 4096 pairs a thread a stage

__global__ void ce_stages_kernel(const int* __restrict__ x, int* __restrict__ y,
                                 int n_stages) {
  __shared__ int s[kTile];
  const long long base = static_cast<long long>(blockIdx.x) << kTileLog;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  for (int stage = 0; stage < n_stages; ++stage) {
    const int k = 1 << (stage % 3);
    for (int t = threadIdx.x; t < (kTile >> 1); t += blockDim.x) {
      const int i = 2 * t - (t & (k - 1));
      const int a = s[i];
      const int b = s[i + k];
      s[i] = a < b ? a : b;
      s[i + k] = a < b ? b : a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) y[base + i] = s[i];
}

}  // namespace

// x, y: int32[n_tiles * 2^13] on the device; n_stages >= 0.
extern "C" int ccve_ce_stages_i32(const void* x, void* y, long long n_tiles,
                                  int n_stages, void* stream) {
  if (n_tiles < 0 || n_tiles > 0x7FFFFFFFLL || n_stages < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  ce_stages_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(y), n_stages);
  return static_cast<int>(cudaGetLastError());
}
