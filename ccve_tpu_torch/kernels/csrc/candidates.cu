// The expansion's candidates: the copy-last expansion of the sort-merge
// join's merged stream, on one segmented scan (seg_scan.cuh).
//
//  - ccve_expand_candidates_i32: the merged ascending stream s[0, L) of
//    `key' << 1 | tag` (int32), builds even (tag 0, so a run's builds come
//    before its probes) and probes odd, with its int32 cargo plane v (a
//    build's payload, any sign, or a probe's row), and the fan-out F >= 1.
//    Outputs over F·L candidate slots, f-major: at slot f·L + i
//    (f = 0 .. F-1), planes[0] = v[i], planes[1] = s[i] >> 1,
//    planes[2] = the payload of the (f+1)-th build of i's key run (0 where
//    the slot is not valid), and valid = i is a probe whose run holds more
//    than f builds; total (int64) = the sum over the probes of their run's
//    builds.
//
// Replaces no Pallas kernel: the JAX package computes the step with
// lax.associative_scan (ccve_tpu/ops/sort_merge.py:151 `_segment_base`),
// and the port's plain version (kernels/merge_scan.py
// `expand_candidates_plain`) with int64 cumsums, a copy-last scan of a
// scatter and a gather for each f, and a stack.
//
// What bounds it on an H100: device memory. It reads 8 bytes an element
// and writes 13 a slot (three int32 planes and a byte of mask): at config
// 1's 17M elements and F = 1, 357 MB, 0.107 ms at 3.35 TB/s; its few
// integer operations an element are far below the card's rate.
//
// Design: builds come before the probes of their run, so a probe's f-th
// build sits at its run's start + f - 1, and all a probe needs is its
// run's start and build count. Both come from seg_scan.cuh's segment
// (run start, build count since it, sum), with the position of each run
// start in place of a payload and 0 elsewhere: the segmented sum is the
// latest run start's position. One scan, one read of the stream, serves
// any F. The warps read the tile striped and write the row and key
// planes, the same at every f, straight from those loads, whole sectors;
// the tile's cargo stays in shared memory, where a probe finds its
// builds' payloads unless its run started in an earlier tile (then device
// memory, which that tile has just read). The payload plane and the mask
// need the scan: they go out a fan-out at a time, striped through shared
// memory. The total is a block's sum, one 64-bit atomic add a block into a
// word zeroed with the look-back's state; the last block to finish (a
// counter beside it) writes the sum to the output, so the caller holds
// 8 bytes, not the scratch.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::kItems;
using seg_scan::kSlots;
using seg_scan::kThreads;
using seg_scan::Seg;
using seg_scan::skew;

// Scratch, from its start: the running total (8 bytes) and the blocks
// done (4, then 4 spare), the look-back's state (all zeroed before the
// scan), then its values.
constexpr long long kStateAt = 16;

struct Candidates {
  // the tile's cargo (kept from the load to the end), then the exchange
  size_t smem() const { return 2 * kSlots * sizeof(int); }
  struct Items {
    int s[kItems];
    int prev;            // the element before the thread's first
    int count[kItems];   // after emit: a probe's run's builds, 0 at a build
    int start[kItems];   // after emit: the position of the element's run start
  };
  const int* s;
  const int* v;
  int fan_out;
  int* planes;               // int32[3, F·L]
  unsigned char* valid;      // bool[F·L]
  unsigned long long* sum;   // in the scratch
  unsigned* done;            // in the scratch
  long long* total;

  __device__ void load(Items& it, long long tile0, long long L, unsigned char* smem) const {
    int* cargo = reinterpret_cast<int*>(smem);
    int* buf = cargo + kSlots;
    const int t = threadIdx.x;
    const long long FL = static_cast<long long>(fan_out) * L;
    int key[kItems];
    int val[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = tile0 + t + j * kThreads;
      key[j] = i < L ? s[i] : 0;
      val[j] = i < L ? v[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = t + j * kThreads;
      const long long i = tile0 + e;
      if (i < L) {
        for (int f = 0; f < fan_out; ++f) {
          planes[f * L + i] = val[j];
          planes[FL + f * L + i] = key[j] >> 1;
        }
      }
      buf[skew(e)] = key[j];
      cargo[skew(e)] = val[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) it.s[k] = buf[skew(t * kItems + k)];
    it.prev = t ? buf[skew(t * kItems - 1)] : (tile0 > 0 ? s[tile0 - 1] : 0);
    __syncthreads();
  }
  __device__ Seg element(const Items& it, int k, long long i) const {
    const int x = it.s[k];
    const int prev = k ? it.s[k - 1] : it.prev;
    const int start = i == 0 || (x >> 1) != (prev >> 1);
    return Seg{start, (x & 1) == 0, start ? i : 0LL};
  }
  __device__ void emit(Items& it, int k, long long, const Seg& run) const {
    it.count[k] = (it.s[k] & 1) ? run.count : 0;
    it.start[k] = static_cast<int>(run.sum);
  }
  __device__ void finish(const Items& it, long long tile0, long long L,
                         unsigned char* smem) const {
    __shared__ unsigned long long warp_sum[seg_scan::kWarps];
    const int* cargo = reinterpret_cast<const int*>(smem);
    int* buf = reinterpret_cast<int*>(smem) + kSlots;
    const int t = threadIdx.x;
    const long long i0 = tile0 + static_cast<long long>(t) * kItems;
    int live = 0;  // the thread's elements below L
    unsigned long long mine = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (i0 + k < L) {
        live = k + 1;
        mine += static_cast<unsigned>(it.count[k]);
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mine += __shfl_down_sync(0xFFFFFFFFu, mine, d);
    if ((t & 31) == 0) warp_sum[t >> 5] = mine;
    __syncthreads();
    if (t == 0) {
      unsigned long long block = 0;
#pragma unroll
      for (int w = 0; w < seg_scan::kWarps; ++w) block += warp_sum[w];
      if (block) atomicAdd(sum, block);
      __threadfence();
      if (atomicAdd(done, 1u) == gridDim.x - 1) *total = atomicAdd(sum, 0ULL);
    }
    const long long FL = static_cast<long long>(fan_out) * L;
    for (int f = 0; f < fan_out; ++f) {
      int pay[kItems];
      unsigned char ok[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const bool hit = k < live && it.count[k] > f;
        pay[k] = 0;
        if (hit) {
          const long long at = static_cast<long long>(it.start[k]) + f;
          pay[k] = at >= tile0 ? cargo[skew(static_cast<int>(at - tile0))] : __ldg(v + at);
        }
        ok[k] = hit;
      }
      seg_scan::store_blocked(planes + 2 * FL + f * L, tile0, L, buf, pay);
      seg_scan::store_blocked(valid + f * L, tile0, L, reinterpret_cast<unsigned char*>(buf), ok);
    }
  }
};

}  // namespace

// Bytes of scratch the wrapper allocates for a stream of L elements.
extern "C" long long ccve_expand_candidates_scratch_bytes(long long L) {
  return kStateAt + seg_scan::state_bytes(L) + seg_scan::value_bytes(L);
}

// s, v: int32[L], 0 < L, 1 <= fan_out, fan_out * L < 2^31; planes:
// int32[3, fan_out * L]; valid: bool[fan_out * L]; total: int64[1];
// scratch: as sized above.
extern "C" int ccve_expand_candidates_i32(const void* s, const void* v, long long L, int fan_out,
                                          void* scratch, void* planes, void* valid, void* total,
                                          void* stream) {
  if (L < 1 || fan_out < 1 || fan_out * L > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* base = static_cast<unsigned char*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long zeroed = kStateAt + seg_scan::state_bytes(L);
  const cudaError_t err = cudaMemsetAsync(base, 0, static_cast<size_t>(zeroed), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Candidates p{static_cast<const int*>(s), static_cast<const int*>(v), fan_out,
                     static_cast<int*>(planes), static_cast<unsigned char*>(valid),
                     reinterpret_cast<unsigned long long*>(base),
                     reinterpret_cast<unsigned*>(base + 8), static_cast<long long*>(total)};
  return seg_scan::launch(p, L, seg_scan::tiles_at(base + kStateAt, base + zeroed, L), st);
}
