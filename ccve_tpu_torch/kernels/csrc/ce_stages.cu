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
// over its tile in shared memory (one load and one store of each key, 8
// bytes an element) and a block barrier. The SM's shared memory moves 128
// bytes a clock, so at K = 16 and more the passes bind: 2^24 keys take
// 2^27 bytes a stage over 132 SMs x 128 B x 1.98 GHz, 4.0 us a stage.
//
// Design: one block of 256 threads a tile of 2^13 keys (the port's sort tile,
// kernels/bigsort.py TILE_LOG; 32 KB of shared memory), six blocks an SM, so
// one block's device-memory copies run while the others run their stages. The
// tile is kept as its 1024 aligned groups of 8 keys, each group as two
// 16-byte halves in two shared arrays, `tile[0]` (keys 0-3) and `tile[1]`
// (keys 4-7): every pair of every stride lies inside one group, the stride-1
// and stride-2 pairs inside one half, the stride-4 pairs the two halves'
// matching lanes. A stage is: each thread loads both halves of 4 groups,
// compare-exchanges them in registers and stores both back; a barrier. Lane l
// of a warp takes group 32c + l of its chunk c, so the 8 threads of a
// quarter-warp load and store 128 contiguous bytes of one array: no shared-
// memory access of any stage is bank-conflicted (the first design, pairs i =
// 2t - (t & (k - 1)) and i + k read as 32-bit words, put two threads on each
// bank in every access). Warp w takes chunks 8j + ((w + s) & 7) at stage s (j
// = 0..3), so each stage's chunks move to another warp: every thread reads
// keys that another warp stored in the stage before (or, at stage 0, in the
// load, which takes the chunks as stage -1), so the stages cannot become
// register work between one load and one store.
// Both keys of a pair are stored every stage, swapped or not: one round of
// strides 1, 2, 4 reaches a fixed point (no later stage swaps anything), so a
// store only on a swap would price every stage past the third as a pass that
// only reads. With both stores the stage cost does not depend on the data. K
// is a runtime argument and the stage loop a runtime loop.
// The copies between device and shared memory move 16-byte halves (cp.async
// in, plain stores out): a warp's 32 halves of a copy are 512 contiguous
// bytes of the tile, and each quarter-warp's 8 lanes take 8 neighbouring
// groups' halves of one shared array. Where x or y is not 16-byte aligned,
// the copies move one key a thread instead; the stages are the same.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kTileLog = 13;
constexpr int kTile = 1 << kTileLog;
constexpr int kGroups = kTile / 8;  // aligned groups of 8 keys: 1024
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunksPerWarp = kGroups / 32 / kWarps;  // chunks of 32 groups: 4
constexpr int kBlocksPerSm = 6;                         // 6 x 32 KB of shared memory

__device__ __forceinline__ void ce(int& a, int& b) {
  const int lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Stride k's compare-exchanges of one group: lo holds keys 0-3, hi 4-7.
__device__ __forceinline__ void ce_group(int4& lo, int4& hi, int k) {
  if (k == 1) {
    ce(lo.x, lo.y);
    ce(lo.z, lo.w);
    ce(hi.x, hi.y);
    ce(hi.z, hi.w);
  } else if (k == 2) {
    ce(lo.x, lo.z);
    ce(lo.y, lo.w);
    ce(hi.x, hi.z);
    ce(hi.y, hi.w);
  } else {
    ce(lo.x, hi.x);
    ce(lo.y, hi.y);
    ce(lo.z, hi.z);
    ce(lo.w, hi.w);
  }
}

// The group of this thread's j-th chunk when the chunks are rotated by `rot`.
__device__ __forceinline__ int group_of(int warp, int lane, int rot, int j) {
  return 32 * (kWarps * j + ((warp + rot) & (kWarps - 1))) + lane;
}

// The copies between the tile in device memory (as 16-byte halves: half 2g
// + h is group g's lo (h = 0) or hi (h = 1)) and `tile[h][g]`: the chunks
// rotated by `rot`, two copies of 16 groups a chunk; lane l takes half h =
// (l >> 3) & 1 of group 16 * (2c + b) + 8 * (l >> 4) + (l & 7).
template <bool kIn>
__device__ __forceinline__ void copy_tile(int4 (*tile)[kGroups], const int4* x, int4* y,
                                          int warp, int lane, int rot) {
  const int h = (lane >> 3) & 1;
  const int in_span = 8 * (lane >> 4) + (lane & 7);
#pragma unroll
  for (int j = 0; j < kChunksPerWarp; ++j) {
    const int c = kWarps * j + ((warp + rot) & (kWarps - 1));
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int g = 32 * c + 16 * b + in_span;
      if (kIn) {
        cp_async::copy16(&tile[h][g], x + 2 * g + h);
      } else {
        y[2 * g + h] = tile[h][g];
      }
    }
  }
}

// Key i of the tile as an int in `tile`: group i >> 3, half (i >> 2) & 1.
__device__ __forceinline__ int& key_at(int4 (*tile)[kGroups], int i) {
  return reinterpret_cast<int*>(&tile[(i >> 2) & 1][i >> 3])[i & 3];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    ce_stages_kernel(const int* __restrict__ x, int* __restrict__ y, int n_stages) {
  __shared__ int4 tile[2][kGroups];
  const long long base = static_cast<long long>(blockIdx.x) << kTileLog;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (kVec) {
    copy_tile<true>(tile, reinterpret_cast<const int4*>(x + base), nullptr, warp, lane, -1);
    cp_async::wait_all();
  } else {
    for (int i = threadIdx.x; i < kTile; i += kThreads) key_at(tile, i) = x[base + i];
  }
  __syncthreads();
  int k = 1;
  for (int stage = 0; stage < n_stages; ++stage) {
#pragma unroll
    for (int j = 0; j < kChunksPerWarp; ++j) {
      const int g = group_of(warp, lane, stage & (kWarps - 1), j);
      int4 lo = tile[0][g];
      int4 hi = tile[1][g];
      ce_group(lo, hi, k);
      tile[0][g] = lo;
      tile[1][g] = hi;
    }
    k = k == 4 ? 1 : 2 * k;
    __syncthreads();
  }
  if (kVec) {
    copy_tile<false>(tile, nullptr, reinterpret_cast<int4*>(y + base), warp, lane,
                     n_stages & (kWarps - 1));
  } else {
    for (int i = threadIdx.x; i < kTile; i += kThreads) y[base + i] = key_at(tile, i);
  }
}

template <bool kVec>
int launch(const void* x, void* y, long long n_tiles, int n_stages, cudaStream_t stream) {
  // six 32 KB tiles an SM need the largest shared-memory carveout
  const cudaError_t err = cudaFuncSetAttribute(
      ce_stages_kernel<kVec>, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_stages_kernel<kVec><<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(y), n_stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: int32[n_tiles * 2^13] on the device; n_stages >= 0.
extern "C" int ccve_ce_stages_i32(const void* x, void* y, long long n_tiles,
                                  int n_stages, void* stream) {
  if (n_tiles < 0 || n_tiles > 0x7FFFFFFFLL || n_stages < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const bool vec = (reinterpret_cast<unsigned long long>(x) % 16 == 0) &&
                   (reinterpret_cast<unsigned long long>(y) % 16 == 0);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, y, n_tiles, n_stages, s)
             : launch<false>(x, y, n_tiles, n_stages, s);
}
