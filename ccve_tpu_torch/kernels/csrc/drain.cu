// Fused drain of one segment of the sorted-chunk executor (count only):
// S chunks, in order, through the whole level recursion (drain over match
// ranks, NaiveCompactor with per-level thresholds, descend, final-level
// count collapse), with the compactor caches carried from chunk to chunk.
// Its occupancy variant also keeps the Zebra histograms: every emission
// after a compaction decision at level l adds one at its live-row count.
//
// Replaces: ccve_tpu/kernels/drain.py `drain_segment` (kernel :94; the
// occupancy variant is its record_occupancy mode, :95-101, :131-180,
// :265-268). The Pallas kernel runs one grid step per chunk and carries the
// caches in VMEM scratch, unrolls the level recursion at trace time,
// compacts with a Hillis-Steele rank and a butterfly shift over [R, 128]
// planes padded to at least 1024 lanes, and sums in int32 (Mosaic has no
// 64-bit types).
//
// What bounds it on an H100: the chunk-to-chunk dependency through the
// caches is the compactor's own semantics, so one thread block walks the
// segment's chunks in order on one SM of 132. Device memory sees one read
// of each mult plane and of the caches and one write of the caches, far
// below the card's bandwidth; the time goes to the block barriers of the
// serial walk (three a scan, one a compaction step, one a chunk).
//
// Design: one block, min(block, 1024) threads, each owning ceil(block /
// threads) contiguous lanes. A depth-first walk over (level, drain rank)
// keeps its per-level scalars (count, drain rank, cache count, threshold,
// fanout, live flag) in one shared array that every thread reads at the
// top of a step, before the step's first barrier; the new values are
// written after the step's last barrier, by every thread alike (the same
// value), so no thread reads a value another thread is changing. The work
// and row counters and the total are thread 0's alone. At level l < L-1
// and rank t the kept lanes (lane < count, mult > t) get their ranks from a
// block exclusive scan (warp shuffles, then one warp over the warp totals);
// planes l+1..L-1 of the kept lanes move to the emission buffer of depth
// l+1 (pass-through), behind level l's cache (absorb), or, when the cache
// fills, the cache's rows and the first block - ccnt kept rows go to the
// emission buffer, a barrier, and then the overflow to the cache's front.
// The planes of depth 0 are read from device memory; level l's cache and
// the depth-l emission buffer (planes l2 > l) take L·(L-1) planes, in
// dynamic shared memory when they fit beside the scalars and in a device
// memory scratch (allocated by the wrapper) otherwise. The last level adds
// Σ mult over its live lanes (a block reduction in int64); in the
// occupancy variant it runs the compactor's count algebra on a count-only
// cache instead, since the collapse has no emissions to record. An empty
// chunk's subtree only bumps the work counters (and, unless `branchy`
// cuts it, the zero bins of the histograms), as the JAX kernel's unrolled
// recursion does. Thread 0 adds each histogram entry into the output with
// a device-memory reduction (red.global.add): one per emission, never
// waited on.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448 - 1024;  // the block's total, less the static scratch
constexpr int kScalars = 8;                // per-level scalar arrays

struct Args {
  const int* mults;
  const int* counts;
  const int* thresholds;
  const int* fanouts;
  const int* cache_in;
  const int* ccnt_in;
  long long S;
  int L;
  int block;
  int branchy;
  int scalars_in_smem;
  int planes_in_smem;
  int* g_scalars;  // device scratch, when not in shared memory
  int* g_planes;
  long long* total_out;
  int* cache_out;
  int* ccnt_out;
  int* work_out;
  int* rows_out;
  int* occ_out;  // int32[L, block + 1], zeroed by the wrapper (variant only)
};

struct Layout {
  size_t smem;         // dynamic shared memory bytes
  size_t scratch;      // device scratch bytes
  bool scalars_smem;
  bool planes_smem;
};

Layout layout(int L, int block) {
  const size_t sc = static_cast<size_t>(kScalars) * L * sizeof(int);
  const size_t pl = static_cast<size_t>(L) * (L - 1) * block * sizeof(int);
  const size_t limit = static_cast<size_t>(kSmemLimit);
  if (sc + pl <= limit) return {sc + pl, 0, true, true};
  if (sc <= limit) return {sc, pl, true, false};
  return {0, sc + pl, false, false};
}

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

// Up to 1024 threads, so at most 64 registers a thread: without the bound
// ptxas gives the occupancy variant 92, too many for a 1024-thread block.
// kSmem: the scalars and planes all in shared memory (the common case), so
// their accesses compile to shared-memory instructions.
template <bool kOcc, bool kSmem>
__global__ void __launch_bounds__(kMaxThreads) drain_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int warp_sums[32];
  __shared__ long long warp_ll[32];
  const int L = a.L;
  const int B = a.block;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int K = (B + nt - 1) / nt;  // lanes a thread, contiguous
  const int lane0 = tid * K;
  const int CC = kOcc ? L : (L > 1 ? L - 1 : 1);  // cache counts
  const int n_cache = L * (L - 1) / 2;

  int* sc = kSmem || a.scalars_in_smem ? smem : a.g_scalars;
  int* cnt = sc;            // rows of the chunk at each depth
  int* rnk = sc + L;        // next drain rank at each depth
  int* thr = sc + 2 * L;
  int* fan = sc + 3 * L;
  int* work = sc + 4 * L;   // thread 0's
  int* rows = sc + 5 * L;   // thread 0's
  int* live = sc + 6 * L;   // the variant's: records below this depth
  int* ccnt = sc + 7 * L;   // CC <= L entries
  int* planes = kSmem ? smem + kScalars * L
                      : a.planes_in_smem ? smem + (a.scalars_in_smem ? kScalars * L : 0)
                                         : a.g_planes;

  // level l's cache, plane l2 > l
  auto cache_plane = [&](int l, int l2) -> int* {
    return planes + static_cast<size_t>(l * (2 * L - l - 1) / 2 + (l2 - l - 1)) * B;
  };
  // the emission buffer of depth d >= 1, plane l2 >= d
  auto emit_plane = [&](int d, int l2) -> int* {
    return planes + static_cast<size_t>(n_cache + (d - 1) * L - (d - 1) * d / 2 + (l2 - d)) * B;
  };
  auto record = [&](int l, int c, int n) {  // thread 0: occ[l, c] += n
    atomicAdd(a.occ_out + static_cast<size_t>(l) * (B + 1) + c, n);
  };

  for (int l = tid; l < L; l += nt) {
    thr[l] = a.thresholds[l];
    fan[l] = a.fanouts[l];
    work[l] = 0;
    rows[l] = 0;
    ccnt[l] = l < CC ? a.ccnt_in[l] : 0;
  }
  for (int l = 0; l + 1 < L; ++l) {
    for (int l2 = l + 1; l2 < L; ++l2) {
      const int* src = a.cache_in + (static_cast<size_t>(l) * L + l2) * B;
      int* dst = cache_plane(l, l2);
      for (int j = tid; j < B; j += nt) dst[j] = src[j];
    }
  }
  long long total = 0;

  for (long long i = 0; i < a.S; ++i) {
    __syncthreads();  // every thread is past the previous chunk's reads
    const int* chunk = a.mults + i * L * B;
    // plane l2 of the chunk at depth d
    auto plane = [&](int d, int l2) -> const int* {
      return d == 0 ? chunk + static_cast<size_t>(l2) * B : emit_plane(d, l2);
    };
    const int c0 = a.counts[i];
    if (tid == 0) {
      work[0] += 1;
      rows[0] += c0;
    }
    cnt[0] = c0;
    rnk[0] = 0;
    if (kOcc) live[0] = 1;
    int d = 0;
    while (d >= 0) {
      if (d == L - 1 && !kOcc) {  // the count collapse: Σ_t |{mult > t}| = Σ mult
        const int c = cnt[d];
        if (c > 0) {
          const int* m = plane(d, d);
          long long s = 0;
          for (int k = 0; k < K; ++k) {
            const int lane = lane0 + k;
            if (lane < B && lane < c) s += m[lane];
          }
          s = block_sum(s, warp_ll);
          if (tid == 0) total += s;
        }
        --d;
        continue;
      }
      if (d == L - 1) {  // the variant's last level: count algebra, count-only cache
        const int c = cnt[d];
        const int th = thr[d];
        const int lv = live[d];
        const int* m = plane(d, d);
        for (int t = 0; t < fan[d]; ++t) {
          const int cc = ccnt[d];
          int ecnt = 0;
          if (c > 0) {
            int local = 0;
            for (int k = 0; k < K; ++k) {
              const int lane = lane0 + k;
              if (lane < B && lane < c && m[lane] > t) ++local;
            }
            block_exclusive_scan(local, warp_sums, &ecnt);
          }
          const bool pt = ecnt >= th || ecnt >= B;
          const int nc = cc + ecnt;
          const int emitted = pt ? ecnt : (nc >= B ? B : 0);
          if (!pt) ccnt[d] = nc >= B ? nc - B : nc;
          if (tid == 0) {
            if (!pt) work[d] += 1;
            if (lv) record(d, emitted, 1);
            total += emitted;
          }
        }
        --d;
        continue;
      }
      if (cnt[d] == 0) {
        // an empty chunk's subtree emits nothing; each compaction in it at a
        // level with a positive threshold still counts as work, and each
        // emission in it is recorded at 0 until `branchy` cuts the subtree
        if (tid == 0) {
          int visits = 1;
          int lv = kOcc ? live[d] : 0;
          for (int l = d; l < (kOcc ? L : L - 1); ++l) {
            if (thr[l] > 0) work[l] += visits * fan[l];
            if (kOcc && lv) record(l, 0, visits * fan[l]);
            lv = lv && !a.branchy;
            visits *= fan[l];
          }
        }
        --d;
        continue;
      }
      if (rnk[d] >= fan[d]) {
        --d;
        continue;
      }
      // every scalar of the step is read before its first barrier
      const int t = rnk[d];
      const int c = cnt[d];
      const int cc = ccnt[d];
      const int th = thr[d];
      const int lv = kOcc ? live[d] : 0;
      const int* mult = plane(d, d);
      // the thread's kept lanes: a bit each for its first 32, recomputed past
      // them (more than 32 lanes a thread only for blocks over 32768)
      unsigned bits = 0;
      int local = 0;
      for (int k = 0; k < K; ++k) {
        const int lane = lane0 + k;
        const bool kp = lane < B && lane < c && mult[lane] > t;
        if (k < 32) bits |= static_cast<unsigned>(kp) << k;
        local += kp;
      }
      auto kept = [&](int lane) {
        const int k = lane - lane0;
        return k < 32 ? (bits >> k & 1u) != 0 : (lane < B && lane < c && mult[lane] > t);
      };
      int ecnt;
      const int before = block_exclusive_scan(local, warp_sums, &ecnt);
      const bool passthrough = ecnt >= th || ecnt >= B;
      const int new_count = cc + ecnt;
      int emitted;
      if (passthrough) {
        for (int l2 = d + 1; l2 < L; ++l2) {
          const int* src = plane(d, l2);
          int* dst = emit_plane(d + 1, l2);
          int r = before;
          for (int k = 0; k < K; ++k) {
            if (kept(lane0 + k)) dst[r++] = src[lane0 + k];
          }
        }
        emitted = ecnt;
      } else if (new_count < B) {  // absorbed behind the cache's rows
        for (int l2 = d + 1; l2 < L; ++l2) {
          const int* src = plane(d, l2);
          int* dst = cache_plane(d, l2) + cc;
          int r = before;
          for (int k = 0; k < K; ++k) {
            if (kept(lane0 + k)) dst[r++] = src[lane0 + k];
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
            if (kept(lane0 + k)) {
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
            if (kept(lane0 + k)) {
              if (r >= room) cached[r - room] = src[lane0 + k];
              ++r;
            }
          }
        }
        ccnt[d] = new_count - B;
        emitted = B;
      }
      if (tid == 0) {
        if (!passthrough) work[d] += 1;
        if (emitted > 0) work[d + 1] += 1;
        rows[d + 1] += emitted;
        if (kOcc && lv) record(d, emitted, 1);
      }
      __syncthreads();  // the emission is written, and every read of this step done
      rnk[d] = t + 1;
      cnt[d + 1] = emitted;
      rnk[d + 1] = 0;
      if (kOcc) live[d + 1] = lv && (emitted > 0 || !a.branchy);
      ++d;
    }
  }
  __syncthreads();

  for (int l = 0; l + 1 < L; ++l) {
    for (int l2 = l + 1; l2 < L; ++l2) {
      const int* src = cache_plane(l, l2);
      int* dst = a.cache_out + (static_cast<size_t>(l) * L + l2) * B;
      for (int j = tid; j < B; j += nt) dst[j] = src[j];
    }
  }
  if (tid == 0) {
    a.total_out[0] = total;
    for (int l = 0; l < CC; ++l) a.ccnt_out[l] = ccnt[l];
    for (int l = 0; l < L; ++l) {
      a.work_out[l] = work[l];
      a.rows_out[l] = rows[l];
    }
  }
}

template <bool kOcc, bool kSmem>
int launch(Args a, const Layout& lay, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(drain_kernel<kOcc, kSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (a.block + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  drain_kernel<kOcc, kSmem><<<1, threads, lay.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of device scratch the drain needs at (L, block): its caches and
// emission buffers when they do not fit in shared memory, 0 when they do.
extern "C" long long ccve_drain_scratch_bytes(int L, int block) {
  if (L < 1 || block < 1) return 0;
  return static_cast<long long>(layout(L, block).scratch);
}

// mults: int32[S, L, block]; counts: int32[S]; thresholds, fanouts: int32[L]
// on the device; cache_in, cache_out: int32[CL, L, block] (CL = max(L - 1,
// 1); the wrapper fills cache_out with cache_in, and the kernel writes
// level l's planes l2 > l); ccnt_in, ccnt_out: int32[CC] (CC = L with
// occupancy, else CL); scratch: ccve_drain_scratch_bytes(L, block) bytes;
// total: one int64; work, rows: int32[L]; occ: int32[L, block + 1], zeroed
// (occupancy only; null otherwise).
extern "C" int ccve_drain_segment_i32(const void* mults, const void* counts,
                                      const void* thresholds, const void* fanouts,
                                      const void* cache_in, const void* ccnt_in, long long S,
                                      int L, int block, int occupancy, int branchy,
                                      void* scratch, void* total, void* cache_out,
                                      void* ccnt_out, void* work, void* rows, void* occ,
                                      void* stream) {
  if (L < 1 || block < 1 || S < 0 || (occupancy && occ == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay = layout(L, block);
  if (lay.scratch > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.mults = static_cast<const int*>(mults);
  a.counts = static_cast<const int*>(counts);
  a.thresholds = static_cast<const int*>(thresholds);
  a.fanouts = static_cast<const int*>(fanouts);
  a.cache_in = static_cast<const int*>(cache_in);
  a.ccnt_in = static_cast<const int*>(ccnt_in);
  a.S = S;
  a.L = L;
  a.block = block;
  a.branchy = branchy != 0;
  a.scalars_in_smem = lay.scalars_smem;
  a.planes_in_smem = lay.planes_smem;
  int* g = static_cast<int*>(scratch);
  a.g_scalars = lay.scalars_smem ? nullptr : g;
  a.g_planes = lay.planes_smem ? nullptr : (lay.scalars_smem ? g : g + kScalars * L);
  a.total_out = static_cast<long long*>(total);
  a.cache_out = static_cast<int*>(cache_out);
  a.ccnt_out = static_cast<int*>(ccnt_out);
  a.work_out = static_cast<int*>(work);
  a.rows_out = static_cast<int*>(rows);
  a.occ_out = static_cast<int*>(occ);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool all_smem = lay.scalars_smem && lay.planes_smem;
  if (occupancy) return all_smem ? launch<true, true>(a, lay, s) : launch<true, false>(a, lay, s);
  return all_smem ? launch<false, true>(a, lay, s) : launch<false, false>(a, lay, s);
}
