// Fused drain of one segment of the sorted-chunk executor (count only):
// S chunks, in order, through the whole level recursion (drain over match
// ranks, NaiveCompactor with per-level thresholds, descend, final-level
// count collapse), with the compactor caches carried from chunk to chunk.
//
// Replaces: ccve_tpu/kernels/drain.py `drain_segment` (kernel :94, without
// its record_occupancy histograms). The Pallas kernel runs one grid step
// per chunk and carries the caches in VMEM scratch, unrolls the level
// recursion at trace time, compacts with a Hillis-Steele rank and a
// butterfly shift over [R, 128] planes padded to at least 1024 lanes, and
// sums in int32 (Mosaic has no 64-bit types).
//
// What bounds it on an H100: the chunk-to-chunk dependency through the
// caches is the compactor's own semantics, so one thread block walks the
// segment's chunks in order on one SM of 132. Device memory sees one read
// of each mult plane and of the caches and one write of the caches, far
// below the card's bandwidth; the time goes to the block barriers of the
// serial walk (three a scan, one a compaction step).
//
// Design: one block, min(block, 1024) threads, each owning up to four
// contiguous lanes. A depth-first walk over (level, drain rank) keeps the
// scalars (drain rank, count, cache counts, thresholds, counters) in every
// thread's registers: each thread takes the same decisions from the same
// values, so they need no shared copy. At level l < L-1 and rank t the
// kept lanes (lane < count, mult > t) get their ranks from a block
// exclusive scan (warp shuffles, then one warp over the warp totals);
// planes l+1..L-1 of the kept lanes move to the emission buffer of depth
// l+1 (pass-through), behind level l's cache (absorb), or, when the cache
// fills, the cache's rows and the first block - ccnt kept rows go to the
// emission buffer, a barrier, and then the overflow to the cache's front.
// The planes of depth 0 are read from device memory; level l's cache and
// the depth-l emission buffer (planes l2 > l) live in dynamic shared
// memory, L·(L-1) planes. The last level adds Σ mult over its live lanes
// (a block reduction in int64). An empty emission's subtree only bumps the
// work counters, as the JAX kernel's unrolled recursion does.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxBlock = 4096;
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448 - 1024;  // the block's total, less the static scratch

struct Params {
  int L;
  int block;
  int fan[kMaxLevels];
};

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive scan of v over the block; *total gets the sum in every thread.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
    w = warp_inclusive_scan(w, lane);
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // the next scan may overwrite warp_sums
  return before + incl - v;
}

// Sum of v over the block, valid in thread 0.
__device__ long long block_sum(long long v, long long* warp_ll) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, d);
  if (lane == 0) warp_ll[warp] = v;
  __syncthreads();
  long long s = 0;
  if (warp == 0) {
    s = lane < n_warps ? warp_ll[lane] : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, d);
  }
  __syncthreads();
  return s;
}

__global__ void drain_kernel(const int* __restrict__ mults,
                             const int* __restrict__ counts,
                             const int* __restrict__ thresholds,
                             const int* __restrict__ cache_in,
                             const int* __restrict__ ccnt_in, long long S,
                             Params p, long long* __restrict__ total_out,
                             int* __restrict__ cache_out,
                             int* __restrict__ ccnt_out,
                             int* __restrict__ work_out,
                             int* __restrict__ rows_out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int warp_sums[32];
  __shared__ long long warp_ll[32];
  const int L = p.L;
  const int B = p.block;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int K = (B + nt - 1) / nt;  // lanes a thread, contiguous
  const int lane0 = tid * K;
  const int n_cache = L * (L - 1) / 2;

  // level l's cache, plane l2 > l
  auto cache_plane = [&](int l, int l2) -> int* {
    return smem + static_cast<size_t>(l * (2 * L - l - 1) / 2 + (l2 - l - 1)) * B;
  };
  // the emission buffer of depth d >= 1, plane l2 >= d
  auto emit_plane = [&](int d, int l2) -> int* {
    return smem + static_cast<size_t>(n_cache + (d - 1) * L - (d - 1) * d / 2 + (l2 - d)) * B;
  };

  int ccnt[kMaxLevels], thr[kMaxLevels], work[kMaxLevels], rows[kMaxLevels];
  int cnt[kMaxLevels], rank[kMaxLevels];
  for (int l = 0; l < L; ++l) {
    thr[l] = thresholds[l];
    ccnt[l] = l < L - 1 ? ccnt_in[l] : 0;
    work[l] = 0;
    rows[l] = 0;
  }
  for (int l = 0; l + 1 < L; ++l) {
    for (int l2 = l + 1; l2 < L; ++l2) {
      const int* src = cache_in + (static_cast<size_t>(l) * L + l2) * B;
      int* dst = cache_plane(l, l2);
      for (int j = tid; j < B; j += nt) dst[j] = src[j];
    }
  }
  __syncthreads();
  long long total = 0;

  for (long long i = 0; i < S; ++i) {
    const int* chunk = mults + i * L * B;
    // plane l2 of the chunk at depth d
    auto plane = [&](int d, int l2) -> const int* {
      return d == 0 ? chunk + static_cast<size_t>(l2) * B : emit_plane(d, l2);
    };
    cnt[0] = counts[i];
    rank[0] = 0;
    work[0] += 1;
    rows[0] += cnt[0];
    int d = 0;
    while (d >= 0) {
      if (d == L - 1) {  // the count collapse: Σ_t |{mult > t}| = Σ mult
        if (cnt[d] > 0) {
          const int* m = plane(d, d);
          long long s = 0;
          for (int k = 0; k < K; ++k) {
            const int lane = lane0 + k;
            if (lane < B && lane < cnt[d]) s += m[lane];
          }
          s = block_sum(s, warp_ll);
          if (tid == 0) total += s;
        }
        --d;
        continue;
      }
      if (cnt[d] == 0) {
        // an empty chunk's subtree emits nothing; each compaction in it
        // at a level with a positive threshold still counts as work
        int visits = 1;
        for (int l = d; l < L - 1; ++l) {
          if (thr[l] > 0) work[l] += visits * p.fan[l];
          visits *= p.fan[l];
        }
        --d;
        continue;
      }
      if (rank[d] >= p.fan[d]) {
        --d;
        continue;
      }
      const int t = rank[d];
      const int* mult = plane(d, d);
      int keep = 0;
      int local = 0;
      for (int k = 0; k < K; ++k) {
        const int lane = lane0 + k;
        if (lane < B && lane < cnt[d] && mult[lane] > t) {
          keep |= 1 << k;
          ++local;
        }
      }
      int ecnt;
      const int before = block_exclusive_scan(local, warp_sums, &ecnt);
      const int cc = ccnt[d];
      const bool passthrough = ecnt >= thr[d] || ecnt >= B;
      const int new_count = cc + ecnt;
      int emitted;
      if (passthrough) {
        for (int l2 = d + 1; l2 < L; ++l2) {
          const int* src = plane(d, l2);
          int* dst = emit_plane(d + 1, l2);
          int r = before;
          for (int k = 0; k < K; ++k) {
            if (keep >> k & 1) dst[r++] = src[lane0 + k];
          }
        }
        emitted = ecnt;
      } else if (new_count < B) {  // absorbed behind the cache's rows
        for (int l2 = d + 1; l2 < L; ++l2) {
          const int* src = plane(d, l2);
          int* dst = cache_plane(d, l2) + cc;
          int r = before;
          for (int k = 0; k < K; ++k) {
            if (keep >> k & 1) dst[r++] = src[lane0 + k];
          }
        }
        ccnt[d] = new_count;
        emitted = 0;
      } else {  // the cache fills: emit it, then keep the overflow
        const int room = B - cc;
        for (int l2 = d + 1; l2 < L; ++l2) {
          const int* src = plane(d, l2);
          const int* cached = cache_plane(d, l2);
          int* dst = emit_plane(d + 1, l2);
          for (int j = tid; j < cc; j += nt) dst[j] = cached[j];
          int r = before;
          for (int k = 0; k < K; ++k) {
            if (keep >> k & 1) {
              if (r < room) dst[cc + r] = src[lane0 + k];
              ++r;
            }
          }
        }
        __syncthreads();  // every cached row is read before the overflow lands
        for (int l2 = d + 1; l2 < L; ++l2) {
          const int* src = plane(d, l2);
          int* cached = cache_plane(d, l2);
          int r = before;
          for (int k = 0; k < K; ++k) {
            if (keep >> k & 1) {
              if (r >= room) cached[r - room] = src[lane0 + k];
              ++r;
            }
          }
        }
        ccnt[d] = new_count - B;
        emitted = B;
      }
      if (!passthrough) work[d] += 1;
      if (emitted > 0) work[d + 1] += 1;
      rows[d + 1] += emitted;
      __syncthreads();  // the emission is written before depth d + 1 reads it
      rank[d] = t + 1;
      cnt[d + 1] = emitted;
      rank[d + 1] = 0;
      ++d;
    }
  }

  for (int l = 0; l + 1 < L; ++l) {
    for (int l2 = l + 1; l2 < L; ++l2) {
      const int* src = cache_plane(l, l2);
      int* dst = cache_out + (static_cast<size_t>(l) * L + l2) * B;
      for (int j = tid; j < B; j += nt) dst[j] = src[j];
    }
  }
  if (tid == 0) {
    total_out[0] = total;
    const int CL = L > 1 ? L - 1 : 1;
    for (int l = 0; l < CL; ++l) ccnt_out[l] = l < L - 1 ? ccnt[l] : ccnt_in[l];
    for (int l = 0; l < L; ++l) {
      work_out[l] = work[l];
      rows_out[l] = rows[l];
    }
  }
}

}  // namespace

// mults: int32[S, L, block]; counts: int32[S]; thresholds: int32[L];
// cache_in, cache_out: int32[CL, L, block] (CL = max(L - 1, 1); the
// wrapper fills cache_out with cache_in, and the kernel writes level l's
// planes l2 > l); ccnt_in, ccnt_out: int32[CL]; fanouts: a host int[L];
// total: one int64; work, rows: int32[L].
extern "C" int ccve_drain_segment_i32(const void* mults, const void* counts,
                                      const void* thresholds,
                                      const void* cache_in,
                                      const void* ccnt_in, long long S, int L,
                                      int block, const void* fanouts,
                                      void* total, void* cache_out,
                                      void* ccnt_out, void* work, void* rows,
                                      void* stream) {
  if (L < 1 || L > kMaxLevels || block < 1 || block > kMaxBlock || S < 0 ||
      fanouts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.L = L;
  p.block = block;
  const int* fan = static_cast<const int*>(fanouts);
  for (int l = 0; l < kMaxLevels; ++l) p.fan[l] = l < L ? fan[l] : 1;
  for (int l = 0; l < L; ++l) {
    if (p.fan[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(L) * (L - 1) * block * sizeof(int);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      drain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (block + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  drain_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mults), static_cast<const int*>(counts),
      static_cast<const int*>(thresholds), static_cast<const int*>(cache_in),
      static_cast<const int*>(ccnt_in), S, p, static_cast<long long*>(total),
      static_cast<int*>(cache_out), static_cast<int*>(ccnt_out),
      static_cast<int*>(work), static_cast<int*>(rows));
  return static_cast<int>(cudaGetLastError());
}
