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
// What bounds it on an H100: device memory sees one read of each mult
// plane and of the caches and one write of the caches, 4.8 us at the card's
// bandwidth for config 3's 489-chunk segment. A depth-first walk of the
// recursion is a chain of dependent steps through the cache counts (about
// 900 there), so it ran on one SM at the pace of its barriers: 3.2 ms. This
// design takes the recursion level by level, across the whole card; its
// grid-wide barriers and each phase's dependent loads then bound it: 51.6
// us there (bench/kernel_split.py; NVIDIA H100 80GB HBM3 at 700 W).
//
// - A cache at level d changes only in steps at level d, and those steps
//   see the emissions of level d-1 in the order (input, drain rank t), in a
//   level-by-level pass as in the depth-first walk. So the levels run one
//   after another, each over all of a window's inputs at once.
// - At one level the compactor is a prefix sum. A step passes through when
//   its kept count e >= threshold or e >= block; otherwise its e rows go
//   behind the cache. Line up the incoming cache's rows, then each absorbing
//   step's kept rows in step order: row p of the line goes to batch p /
//   block at slot p % block, batch k is emitted by the step holding
//   position (k+1)·block - 1, and the last, unfinished batch is the outgoing
//   cache. One exclusive scan over the level's steps gives every position.
// - Every row at every depth is an original row, of a chunk or of an
//   incoming cache, so a row travels as one int32 id (j·L·block + lane for
//   a chunk row, ~(l·L·block + p) for cache row p of level l) and its mult
//   at each level is gathered when needed. The outgoing caches' planes are
//   gathered from the ids once, at the end of a window.
// - Each step's emission is one input of the next level, in step order.
//   A pass-through emission's rows go to `block` slots of its own (s·block
//   + rank); an emitted batch's rows are the line's positions k·block on,
//   so a row lands at its position and no step needs to know the emitter.
//   An input is its count and where its rows start. An empty input takes
//   the same algebra (e = 0) and costs one step of the scan.
//
// Design: one persistent cooperative launch (cudaLaunchCooperativeKernel)
// of kThreads threads a block, every block resident: one block an SM, or up
// to kBlocksPerSM as the occupancy API allows where the chunks pass two an
// SM (grid_blocks). A level is
// two phases between grid.sync() calls. (A) Each block takes a contiguous
// share of the level's inputs, counts each step's kept rows (a block
// reduction) and adds up the rows its absorbing steps put behind the cache.
// (B) Each block adds the shares of the blocks before it and scans its
// steps (a block scan a tile of kThreads steps): each step's line position
// and emission (the next level's inputs), the work and row counters (one
// atomic a block a counter) and the histogram (a block's bins in shared
// memory, added once into `occ`); then it ranks each step's kept rows (a
// block scan, each thread owning contiguous lanes, so the ranks keep lane
// order) and writes their ids: to the step's own slots (pass-through), to
// the line (a batch) or to the outgoing cache. The last level sums Σ mult
// over its rows (the count collapse), or, in the occupancy variant, runs
// the scan of (A) and (B) on a count-only cache. A 4-level segment takes 6
// grid-wide barriers. Scratch (row ids, counts, steps, positions) is sized
// on the host from S, the block and the fanouts; where a window's inputs
// times the block would pass kRowsCap, the segment is walked in windows of
// chunks, in order, the caches carried in device memory from window to
// window.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;           // the most blocks an SM the grid takes
constexpr int kMaxGrid = 2048;            // block sums in the scratch
constexpr int kHistMax = 8193;            // bins of the shared histogram: blocks up to 8192
constexpr long long kRowsCap = 1LL << 23; // a window's inputs times the block, at most
constexpr long long kPosCap = 1LL << 30;  // a level's line positions stay below this
constexpr size_t kSmemBase = kWarps * sizeof(long long) + 4 * kWarps * sizeof(int);
constexpr int kMaxPaths = 64;  // the JAX gate: Π fanouts[:-1]
constexpr int kMaxSplits = 6;  // so at most 6 levels above the last fan out past 1

// The fanouts, passed with the launch: the levels above the last whose
// fanout is past 1, and the last level's.
struct Fanouts {
  int n_split;
  int split_level[kMaxSplits];
  int split_fanout[kMaxSplits];
  int last;
};

// (paths, steps_per_chunk, fanouts of the launch) from the host's fanouts:
// paths = Π fanouts[:-1] (0 when L = 1), the inputs a chunk gives a level
// below the first, at most; steps_per_chunk, the steps a chunk gives the
// deepest level that compacts (the last with occupancy, else the one above
// it; 0 when none does). False past kMaxPaths paths or for a fanout < 1.
bool read_fanouts(const int* fanouts, int L, bool occ, long long* paths,
                  long long* steps_per_chunk, Fanouts* fan) {
  long long p = 1;
  Fanouts f{};
  for (int l = 0; l < L; ++l) {
    if (fanouts[l] < 1) return false;
    if (l + 1 == L) break;
    p *= fanouts[l];
    if (p > kMaxPaths) return false;
    if (fanouts[l] > 1) {
      f.split_level[f.n_split] = l;
      f.split_fanout[f.n_split] = fanouts[l];
      ++f.n_split;
    }
  }
  f.last = fanouts[L - 1];
  *paths = L > 1 ? p : 0;
  *steps_per_chunk = occ ? p * f.last : (L > 1 ? p : 0);
  *fan = f;
  return true;
}

struct Layout {
  long long W;          // chunks a window
  long long n_windows;
  long long inputs;     // inputs of a level >= 1 in a window, at most
  long long steps;      // steps of a level in a window, at most
  long long rows0, rows1, src0, src1, cnt0, cnt1, live0, live1, ecnt, pos, cid, bsum, ccnt, ping;
  long long ints;       // the scratch's size in ints
};

// The window and the scratch of a call; false where no window fits the
// int32 ids and positions.
bool make_layout(long long S, int L, int B, bool occ, long long paths, long long steps_per_chunk,
                 Layout* out) {
  if (L < 1 || B < 1 || S < 0 || paths < 0 || steps_per_chunk < 0) return false;
  const long long LB = static_cast<long long>(L) * B;
  const long long CL = L > 1 ? L - 1 : 1;
  if (CL * LB >= (1LL << 31)) return false;  // cache row ids
  const long long inputs_per_chunk = L > 1 ? paths : 0;
  long long W = S > 0 ? S : 1;
  if (inputs_per_chunk > 0) W = std::min(W, kRowsCap / (inputs_per_chunk * B));
  if (steps_per_chunk > 0) W = std::min(W, (kPosCap - B) / (steps_per_chunk * B));
  W = std::min(W, ((1LL << 31) - 1) / LB);  // chunk row ids
  if (W < 1) return false;
  Layout lay;
  lay.W = W;
  lay.n_windows = (S + W - 1) / W;
  lay.inputs = W * inputs_per_chunk;
  lay.steps = W * steps_per_chunk;
  long long at = 0;
  auto take = [&](long long n) {
    const long long here = at;
    at += (n + 15) / 16 * 16;  // 64-byte aligned
    return here;
  };
  // a level's row ids: `block` slots an input (pass-through emissions),
  // then the line (emitted batches), block more than the inputs' slots
  const long long rows = lay.inputs > 0 ? 2 * lay.inputs * B + B : 0;
  lay.rows0 = take(rows);
  lay.rows1 = take(rows);
  lay.src0 = take(lay.inputs);
  lay.src1 = take(lay.inputs);
  lay.cnt0 = take(lay.inputs);
  lay.cnt1 = take(lay.inputs);
  lay.live0 = take(occ ? lay.inputs : 0);
  lay.live1 = take(occ ? lay.inputs : 0);
  lay.ecnt = take(lay.steps);
  lay.pos = take(lay.steps);
  lay.cid = take(LB);
  lay.bsum = take(kMaxGrid);
  lay.ccnt = take(2LL * L);
  lay.ping = take(lay.n_windows > 1 ? CL * LB : 0);
  lay.ints = at;
  *out = lay;
  return true;
}

struct Args {
  const int* mults;
  const int* counts;
  const int* thresholds;
  Fanouts fan;
  const int* cache_in;
  const int* ccnt_in;
  long long S;
  long long W;
  long long n_windows;
  long long line;  // where the line starts in a row-id buffer
  int L;
  int block;
  int branchy;
  int hist_smem;  // the variant's histogram bins in shared memory
  int* rows[2];   // row ids of the inputs of the levels of each parity
  int* src[2];    // where each input's rows start in them
  int* cnt[2];    // each input's rows
  int* live[2];   // the variant's: each input's emissions are recorded
  int* ecnt;      // each step's kept rows
  int* pos;       // each step's line position
  int* cid;       // row ids of the outgoing caches, block a level
  int* bsum;      // each block's absorbed rows
  int* ccnt;      // the cache counts, two parities of L
  int* ping;      // the caches between windows
  long long* total_out;
  int* cache_out;
  int* ccnt_out;
  int* work_out;
  int* rows_out;
  int* occ_out;   // int32[L, block + 1]
};

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive scan of v over the block; *total gets the sum, in every thread.
__device__ int block_exclusive_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? red[lane] : 0;
    w = warp_inclusive_scan(w, lane);
    if (lane < kWarps) red[lane] = w;
  }
  __syncthreads();
  const int before = warp ? red[warp - 1] : 0;
  *total = red[kWarps - 1];
  __syncthreads();  // the next call may overwrite red
  return before + incl - v;
}

// The sums of v[0..N) over the block, in every thread (red: N·kWarps).
template <int N, typename T>
__device__ void block_sums(T (&v)[N], T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[i] += __shfl_xor_sync(0xFFFFFFFFu, v[i], d);
    if (lane == 0) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[i * kWarps + w];
    v[i] = s;
  }
  __syncthreads();
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  T one[1] = {v};
  block_sums(one, red);
  return one[0];
}

template <bool kOcc>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) drain_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ long long smem[];
  long long* red_ll = smem;                          // kWarps
  int* red = reinterpret_cast<int*>(smem + kWarps);  // 4·kWarps
  int* hist = red + 4 * kWarps;                      // the variant's bins
  const int L = a.L;
  const int B = a.block;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const long long LB = static_cast<long long>(L) * B;
  const int CC = kOcc ? L : (L > 1 ? L - 1 : 1);

  // the outputs and the cache counts: first read or added to after a
  // grid.sync()
  if (b == 0) {
    for (int l = tid; l < L; l += nt) {
      a.work_out[l] = 0;
      a.rows_out[l] = 0;
      a.ccnt[l] = l < CC ? a.ccnt_in[l] : 0;
    }
    if (tid == 0) a.total_out[0] = 0;
  }
  const long long stride = static_cast<long long>(G) * nt;
  if (kOcc) {
    for (long long k = static_cast<long long>(b) * nt + tid; k < LB + L; k += stride) {
      a.occ_out[k] = 0;
    }
  }
  // the caches past their live prefixes keep cache_in's
  for (long long k = static_cast<long long>(b) * nt + tid; k < (L > 1 ? L - 1 : 1) * LB;
       k += stride) {
    a.cache_out[k] = a.cache_in[k];
  }

  for (long long w = 0; w < a.n_windows; ++w) {
    const long long i0 = w * a.W;
    const long long n0 = a.S - i0 < a.W ? a.S - i0 : a.W;
    const int* wm = a.mults + i0 * LB;
    const int* csrc = w == 0 ? a.cache_in : ((a.n_windows - w) % 2 == 0 ? a.cache_out : a.ping);
    int* cdst = (a.n_windows - 1 - w) % 2 == 0 ? a.cache_out : a.ping;
    const int* ccur = a.ccnt + (w & 1) * L;
    int* cnext = a.ccnt + ((w + 1) & 1) * L;
    long long N = n0;  // inputs at the level

    for (int d = 0; d < L; ++d) {
      const bool last = d == L - 1;
      const int* in_rows = d ? a.rows[d & 1] : nullptr;
      const int* in_src = d ? a.src[d & 1] : nullptr;
      const int* in_cnt = d ? a.cnt[d & 1] : a.counts + i0;
      const int* in_live = kOcc && d ? a.live[d & 1] : nullptr;
      const long long lo = N * b / G;
      const long long hi = N * (b + 1) / G;
      // the row ids of input j start at rows_of(j); plane l2 of a row
      auto rows_of = [&](long long j) -> long long { return d ? in_src[j] : j * LB; };
      auto row_id = [&](long long at, int k) -> int {
        return d ? in_rows[at + k] : static_cast<int>(at + k);
      };
      auto plane = [&](int id, int l2) -> int {
        return id >= 0 ? wm[id + static_cast<long long>(l2) * B]
                       : csrc[static_cast<long long>(~id) + static_cast<long long>(l2) * B];
      };
      // level 0: the chunks and rows that arrive (after the first
      // grid.sync(), which orders them after the zeroing)
      auto arrivals = [&]() {
        if (d == 0 && tid == 0 && hi > lo) {
          int arrived = 0;
          for (long long j = lo; j < hi; ++j) arrived += in_cnt[j];
          atomicAdd(a.work_out, static_cast<int>(hi - lo));
          atomicAdd(a.rows_out, arrived);
        }
      };

      if (last && !kOcc) {  // the count collapse: Σ_t |{mult > t}| = Σ mult
        if (d == 0) grid.sync();
        arrivals();
        long long s = 0;
        for (long long j = lo; j < hi; ++j) {
          const int c = in_cnt[j];
          const long long at = c > 0 ? rows_of(j) : 0;
          for (int k = tid; k < c; k += nt) s += plane(row_id(at, k), d);
        }
        s = block_sum(s, red_ll);
        if (tid == 0 && s != 0) {
          atomicAdd(reinterpret_cast<unsigned long long*>(a.total_out),
                    static_cast<unsigned long long>(s));
        }
        break;
      }

      int f = last ? a.fan.last : 1;
      for (int i = 0; i < a.fan.n_split; ++i) {
        if (a.fan.split_level[i] == d) f = a.fan.split_fanout[i];
      }
      const int th = a.thresholds[d];

      // (A) each step's kept rows; the rows the block's absorbing steps
      // put behind the cache
      int absorbed = 0;  // thread 0's
      for (long long j = lo; j < hi; ++j) {
        const int c = in_cnt[j];
        const int K = (c + nt - 1) / nt;
        const int k0 = tid * K;
        const int k1 = c < k0 + K ? c : k0 + K;
        const long long at = c > 0 ? rows_of(j) : 0;
        for (int t = 0; t < f; ++t) {
          int e = 0;
          if (c > 0) {
            int local = 0;
            for (int k = k0; k < k1; ++k) local += plane(row_id(at, k), d) > t;
            e = block_sum(local, red);
          }
          if (tid == 0) {
            a.ecnt[j * f + t] = e;
            if (e < th && e < B) absorbed += e;
          }
        }
      }
      if (tid == 0) a.bsum[b] = absorbed;
      grid.sync();
      arrivals();

      // (B) the block's steps: line positions, emissions, counters and
      // histogram
      int sums[2] = {0, 0};  // the blocks before this one, all blocks
      for (int q = tid; q < G; q += nt) {
        const int v = a.bsum[q];
        sums[1] += v;
        if (q < b) sums[0] += v;
      }
      block_sums(sums, red);
      const int c_old = ccur[d];
      const int end = c_old + sums[1];
      const int full = end / B;  // batches emitted at this level
      if (b == 0 && tid == 0) cnext[d] = end % B;
      const bool hist_here = kOcc && a.hist_smem;
      if (hist_here) {
        for (int k = tid; k <= B; k += nt) hist[k] = 0;
        __syncthreads();
      }
      const int p = (d + 1) & 1;
      int* out_rows = a.rows[p];
      int counters[3] = {0, 0, 0};  // compactions, emissions, rows emitted
      int run = c_old + sums[0];
      for (long long s0 = lo * f; s0 < hi * f; s0 += nt) {
        const long long s = s0 + tid;
        const bool valid = s < hi * f;
        const int e = valid ? a.ecnt[s] : 0;
        const bool pass = e >= th || e >= B;
        int tile;
        const int P = run + block_exclusive_scan(valid && !pass ? e : 0, red, &tile);
        run += tile;
        if (!valid) continue;
        const int out = pass ? e : (P % B + e >= B ? B : 0);
        a.pos[s] = P;
        counters[0] += !pass;
        counters[1] += out > 0;
        counters[2] += out;
        if (!last) {
          a.cnt[p][s] = out;
          a.src[p][s] = static_cast<int>(pass ? s * B : a.line + P / B * B);
        }
        if (kOcc) {
          const bool lv = d == 0 || in_live[s / f] != 0;
          if (!last) a.live[p][s] = lv && (out > 0 || !a.branchy);
          if (lv) {
            if (hist_here) {
              atomicAdd(hist + out, 1);
            } else {
              atomicAdd(a.occ_out + static_cast<long long>(d) * (B + 1) + out, 1);
            }
          }
        }
      }
      block_sums(counters, red);
      if (tid == 0) {
        if (counters[0]) atomicAdd(a.work_out + d, counters[0]);
        if (last) {
          if (counters[2]) {
            atomicAdd(reinterpret_cast<unsigned long long*>(a.total_out),
                      static_cast<unsigned long long>(counters[2]));
          }
        } else {
          if (counters[1]) atomicAdd(a.work_out + d + 1, counters[1]);
          if (counters[2]) atomicAdd(a.rows_out + d + 1, counters[2]);
        }
      }
      if (hist_here) {  // block_sums' barrier: every bin is in
        int* occ_d = a.occ_out + static_cast<long long>(d) * (B + 1);
        for (int k = tid; k <= B; k += nt) {
          if (hist[k]) atomicAdd(occ_d + k, hist[k]);
        }
      }
      if (last) break;  // the variant's last level keeps counts only

      // (C) each kept row's id to its slot: the step's own emission
      // (pass-through), the line at its position (an emitted batch), or the
      // outgoing cache; the block's positions are in (block_sums' barrier)
      int* line = out_rows + a.line;
      int* cid = a.cid + static_cast<long long>(d) * B;
      for (long long j = lo; j < hi; ++j) {
        const int c = in_cnt[j];
        if (c == 0) continue;
        const int K = (c + nt - 1) / nt;
        const int k0 = tid * K;
        const int k1 = c < k0 + K ? c : k0 + K;
        const long long at = rows_of(j);
        for (int t = 0; t < f; ++t) {
          const long long s = j * f + t;
          const int e = a.ecnt[s];
          if (e == 0) continue;
          const bool pass = e >= th || e >= B;
          const int P = a.pos[s];
          int local = 0;
          for (int k = k0; k < k1; ++k) local += plane(row_id(at, k), d) > t;
          int tile;
          int r = block_exclusive_scan(local, red, &tile);
          for (int k = k0; k < k1; ++k) {
            const int id = row_id(at, k);
            if (plane(id, d) <= t) continue;
            if (pass) {
              out_rows[s * B + r] = id;
            } else if (P + r < full * B) {
              line[P + r] = id;
            } else {
              cid[P + r - full * B] = id;
            }
            ++r;
          }
        }
      }
      if (b == G - 1) {  // the incoming cache's rows lead the line
        for (int q = tid; q < c_old; q += nt) {
          const int id = ~static_cast<int>(d * LB + q);
          if (full) {
            line[q] = id;
          } else {
            cid[q] = id;
          }
        }
      }
      grid.sync();
      N *= f;
    }

    // the outgoing caches' planes, gathered from their row ids
    for (int l = 0; l + 1 < L; ++l) {
      const int cnt = cnext[l];
      const long long n = static_cast<long long>(cnt) * (L - 1 - l);
      const int* cid = a.cid + static_cast<long long>(l) * B;
      for (long long k = static_cast<long long>(b) * nt + tid; k < n; k += stride) {
        const int q = static_cast<int>(k % cnt);
        const int l2 = l + 1 + static_cast<int>(k / cnt);
        const int id = cid[q];
        cdst[(static_cast<long long>(l) * L + l2) * B + q] =
            id >= 0 ? wm[id + static_cast<long long>(l2) * B]
                    : csrc[static_cast<long long>(~id) + static_cast<long long>(l2) * B];
      }
    }
    if (w + 1 < a.n_windows) grid.sync();
  }

  if (b == 0) {  // block 0 wrote the last window's counts (thread 0)
    __syncthreads();
    const int* final_ccnt = a.ccnt + (a.n_windows & 1) * L;
    for (int l = tid; l < CC; l += nt) {
      a.ccnt_out[l] = l + 1 < L || kOcc ? final_ccnt[l] : a.ccnt_in[l];
    }
  }
}

size_t smem_bytes(bool occ) { return kSmemBase + (occ ? kHistMax * sizeof(int) : 0); }

// The blocks an SM the occupancy API lets stay resident, at most
// kBlocksPerSM, and the SMs of the current device (kept a device and
// variant).
template <bool kOcc>
int resident(int* per_sm, int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> cached[kDevices];  // per_sm << 16 | sms
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int v = dev < kDevices ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    int n = 0, per = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, drain_kernel<kOcc>, kThreads,
                                                        smem_bytes(kOcc));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    v = (per < kBlocksPerSM ? per : kBlocksPerSM) << 16 | n;
    if (dev < kDevices) cached[dev].store(v, std::memory_order_relaxed);
  }
  *per_sm = v >> 16;
  *sms = v & 0xFFFF;
  return 0;
}

// The cooperative grid of a call whose widest level has `inputs` inputs:
// one block an SM up to two inputs an SM, else as many as stay resident
// (bench/drain_sweep.py on an H100 at 700 W: one block an SM drains 64
// chunks in 31.8 us against two's 38.6, and 977 in 88.8 against 77.6).
// Every block is resident, as grid.sync() needs.
template <bool kOcc>
int grid_blocks(long long inputs, int* grid) {
  int per_sm = 0, sms = 0;
  const int err = resident<kOcc>(&per_sm, &sms);
  if (err != 0) return err;
  const long long want = (inputs + 2LL * sms - 1) / (2LL * sms);
  const int per = want < 1 ? 1 : (want < per_sm ? static_cast<int>(want) : per_sm);
  *grid = std::min(per * sms, kMaxGrid);
  return 0;
}

template <bool kOcc>
int launch(Args a, long long inputs, cudaStream_t stream) {
  int grid = 0;
  const int err = grid_blocks<kOcc>(inputs, &grid);
  if (err != 0) return err;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(drain_kernel<kOcc>), dim3(grid), dim3(kThreads), args,
      smem_bytes(kOcc), stream));
}

}  // namespace

// Bytes of device scratch of a call: S chunks of L levels of `block`
// lanes, fanouts int32[L] on the host. -1 where the fanouts pass the
// 64-path gate or no window of chunks fits the int32 ids.
extern "C" long long ccve_drain_scratch_bytes(long long S, int L, int block, int occupancy,
                                              const int* fanouts) {
  long long paths = 0, steps = 0;
  Fanouts fan;
  Layout lay;
  if (L < 1 || fanouts == nullptr ||
      !read_fanouts(fanouts, L, occupancy != 0, &paths, &steps, &fan) ||
      !make_layout(S, L, block, occupancy != 0, paths, steps, &lay)) {
    return -1;
  }
  return lay.ints * static_cast<long long>(sizeof(int));
}

// The blocks of a call's cooperative launch on the current device (<= 0:
// minus a CUDA error, or an invalid value's).
extern "C" int ccve_drain_grid(long long S, int L, int occupancy, const int* fanouts) {
  long long paths = 0, steps = 0;
  Fanouts fan;
  if (L < 1 || S < 0 || fanouts == nullptr ||
      !read_fanouts(fanouts, L, occupancy != 0, &paths, &steps, &fan)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  const long long inputs = S * std::max(paths, 1LL);
  const int err = occupancy ? grid_blocks<true>(inputs, &grid) : grid_blocks<false>(inputs, &grid);
  return err ? -err : grid;
}

// mults: int32[S, L, block]; counts: int32[S]; thresholds: int32[L] on the
// device; fanouts: int32[L] on the host; cache_in, cache_out: int32[CL, L,
// block] (CL = max(L - 1, 1): the kernel copies cache_in, then writes level
// l's live prefix of planes l2 > l); ccnt_in, ccnt_out: int32[CC] (CC = L
// with occupancy, else CL); scratch: ccve_drain_scratch_bytes bytes, any
// contents; total: one int64; work, rows: int32[L]; occ: int32[L, block +
// 1] (occupancy only; null otherwise). Every output is written by the
// kernel: none needs zeroing.
extern "C" int ccve_drain_segment_i32(const void* mults, const void* counts,
                                      const void* thresholds, const int* fanouts,
                                      const void* cache_in, const void* ccnt_in, long long S,
                                      int L, int block, int occupancy, int branchy,
                                      void* scratch, void* total, void* cache_out,
                                      void* ccnt_out, void* work, void* rows, void* occ,
                                      void* stream) {
  long long paths = 0, steps = 0;
  Fanouts fan;
  Layout lay;
  if (L < 1 || fanouts == nullptr ||
      !read_fanouts(fanouts, L, occupancy != 0, &paths, &steps, &fan) ||
      !make_layout(S, L, block, occupancy != 0, paths, steps, &lay) || scratch == nullptr ||
      (occupancy && occ == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* g = static_cast<int*>(scratch);
  Args a;
  a.mults = static_cast<const int*>(mults);
  a.counts = static_cast<const int*>(counts);
  a.thresholds = static_cast<const int*>(thresholds);
  a.fan = fan;
  a.cache_in = static_cast<const int*>(cache_in);
  a.ccnt_in = static_cast<const int*>(ccnt_in);
  a.S = S;
  a.W = lay.W;
  a.n_windows = lay.n_windows;
  a.L = L;
  a.block = block;
  a.branchy = branchy != 0;
  a.hist_smem = block + 1 <= kHistMax;
  a.line = lay.inputs * block;
  a.rows[0] = g + lay.rows0;
  a.rows[1] = g + lay.rows1;
  a.src[0] = g + lay.src0;
  a.src[1] = g + lay.src1;
  a.cnt[0] = g + lay.cnt0;
  a.cnt[1] = g + lay.cnt1;
  a.live[0] = g + lay.live0;
  a.live[1] = g + lay.live1;
  a.ecnt = g + lay.ecnt;
  a.pos = g + lay.pos;
  a.cid = g + lay.cid;
  a.bsum = g + lay.bsum;
  a.ccnt = g + lay.ccnt;
  a.ping = g + lay.ping;
  a.total_out = static_cast<long long*>(total);
  a.cache_out = static_cast<int*>(cache_out);
  a.ccnt_out = static_cast<int*>(ccnt_out);
  a.work_out = static_cast<int*>(work);
  a.rows_out = static_cast<int*>(rows);
  a.occ_out = static_cast<int*>(occ);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long inputs = S * std::max(paths, 1LL);
  return occupancy ? launch<true>(a, inputs, s) : launch<false>(a, inputs, s);
}
