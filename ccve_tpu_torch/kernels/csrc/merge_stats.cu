// Merge stats: per-probe match count and matched-payload sum over the
// merged sort-merge stream, written straight into probe-row order.
//
// Input: the merged, ascending stream s[0, L) of `key' << 1 | tag` (int32,
// or int64 in a second build), builds even (tag 0, so they precede the
// probes of their key) and probes odd, with an int32 cargo plane v: a
// build's payload (any sign) or a probe's row id in [0, n). The key type's
// maximum is sort padding, never counted as a probe.
// Output: mult int32[n] and psum int64[n]: for probe row r, the number of
// builds with its key and the sum of their payloads.
//
// Replaces: ccve_tpu/kernels/merge_scan.py `_make_stats32_kernel` (entry
// `merge_scan_stats32`), which scans the stream tile by tile in order,
// carrying the running build count, a 64-bit payload prefix in (hi, lo)
// limbs and the run bases (a cummax, so payloads must be non-negative)
// from one grid step to the next, and emits per-position planes plus an
// unsort key that a second multi-plane sort turns into row order. The
// int64 build replaces `_kernel` (merge_scan.py:47, through `_call` and
// `merge_scan_stats`) on the wide stats path (ops/sort_merge.py:504): the
// same scan over (hi, lo) int32 limbs of the untagged key and of a tagged
// int64 payload (pay * 2 + 1 for builds), with the same cummax base.
//
// What bounds it on an H100: device memory. Each of the two scan passes
// reads the stream (8 bytes per element for int32 keys, 12 for int64) and
// the last one scatters 12 bytes per probe; the scans themselves are a few
// operations per element.
//
// Design: a segmented sum, (count, payload sum) restarting at each key
// run, taken with a two-pass block scan, because CUDA blocks run in no
// order and nothing carries from one block to the next. Pass 1 reduces
// each block's chunk to its segment aggregate; a single block then scans
// the aggregates in place into each block's exclusive prefix; pass 2
// rescans each chunk from its prefix. A segmented scan is exact for
// payloads of any sign, so the cummax trick and its non-negative
// restriction are gone. Every probe's row id is unique, so pass 2
// scatters mult and psum to out[row id] without atomics, and the TPU's
// unsort sort, its unsort-key plane, the packed psum << mult_bits | mult
// plane and the 64-bit limbs have no job (psum is native int64). The
// int64 build widens the staged keys: 24 KB of static shared memory for
// the chunk plus 8 KB for the scan buffer, under the 48 KB limit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // stream elements per block
constexpr int kScanThreads = 1024;

// Sort padding: the key type's maximum.
template <typename K>
struct Pad;
template <>
struct Pad<int> {
  static constexpr int value = 0x7FFFFFFF;
};
template <>
struct Pad<long long> {
  static constexpr long long value = 0x7FFFFFFFFFFFFFFFLL;
};

// A segment of the stream: whether it holds a run start, and the build
// count and payload sum since its last run start (or over all of it).
struct Seg {
  int start;
  int count;
  long long sum;
};

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  Seg r;
  r.start = a.start | b.start;
  r.count = b.start ? b.count : a.count + b.count;
  r.sum = b.start ? b.sum : a.sum + b.sum;
  return r;
}

__device__ __forceinline__ Seg identity() { return Seg{0, 0, 0}; }

// Inclusive and exclusive scans of one Seg per thread across the block.
// `buf` holds 2 * blockDim.x entries; the scan ends with a barrier, so the
// caller may reuse it.
__device__ void block_scan(Seg x, Seg* buf, Seg& incl, Seg& excl) {
  const int t = threadIdx.x;
  const int n = blockDim.x;
  int in = 0;
  buf[t] = x;
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    Seg v = buf[in * n + t];
    if (t >= off) v = combine(buf[in * n + t - off], v);
    buf[(in ^ 1) * n + t] = v;
    __syncthreads();
    in ^= 1;
  }
  incl = buf[in * n + t];
  excl = t ? buf[in * n + t - 1] : identity();
  __syncthreads();
}

template <typename K>
struct Chunk {
  K key[kChunk];
  int val[kChunk];
  K prev;  // packed value just before the chunk (unused for chunk 0)
};

// Stage the block's chunk of (s, v) in shared memory; returns its length.
template <typename K>
__device__ int load_chunk(const K* s, const int* v, long long L, Chunk<K>& c) {
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const int cnt = static_cast<int>(L - base < kChunk ? L - base : kChunk);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    c.key[i] = s[base + i];
    c.val[i] = v[base + i];
  }
  if (threadIdx.x == 0) c.prev = base > 0 ? s[base - 1] : 0;
  __syncthreads();
  return cnt;
}

// Element j of the chunk as a one-element segment.
template <typename K>
__device__ __forceinline__ Seg element(const Chunk<K>& c, int j) {
  const K s = c.key[j];
  const K prev = j ? c.key[j - 1] : c.prev;
  const bool first = j == 0 && blockIdx.x == 0;
  const bool build = (s & 1) == 0;
  return Seg{first || (s >> 1) != (prev >> 1), build ? 1 : 0,
             build ? static_cast<long long>(c.val[j]) : 0LL};
}

// The segment of this thread's kItems elements.
template <typename K>
__device__ Seg thread_segment(const Chunk<K>& c, int cnt) {
  Seg a = identity();
  const int j0 = static_cast<int>(threadIdx.x) * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (j0 + k < cnt) a = combine(a, element(c, j0 + k));
  }
  return a;
}

template <typename K>
__global__ void stats_reduce_kernel(const K* __restrict__ s,
                                    const int* __restrict__ v, long long L,
                                    Seg* __restrict__ agg) {
  __shared__ Chunk<K> c;
  __shared__ Seg buf[2 * kThreads];
  const int cnt = load_chunk(s, v, L, c);
  Seg incl, excl;
  block_scan(thread_segment(c, cnt), buf, incl, excl);
  if (threadIdx.x == blockDim.x - 1) agg[blockIdx.x] = incl;
}

// One block: agg[b] becomes the exclusive prefix of blocks [0, b).
__global__ void stats_scan_blocks_kernel(Seg* __restrict__ agg,
                                         long long n_blocks) {
  __shared__ Seg buf[2 * kScanThreads];
  __shared__ Seg tile_total;
  Seg carry = identity();
  for (long long off = 0; off < n_blocks; off += blockDim.x) {
    const long long i = off + threadIdx.x;
    const Seg x = i < n_blocks ? agg[i] : identity();
    Seg incl, excl;
    block_scan(x, buf, incl, excl);
    if (i < n_blocks) agg[i] = combine(carry, excl);
    if (threadIdx.x == blockDim.x - 1) tile_total = incl;
    __syncthreads();
    carry = combine(carry, tile_total);
    __syncthreads();
  }
}

template <typename K>
__global__ void stats_apply_kernel(const K* __restrict__ s,
                                   const int* __restrict__ v, long long L,
                                   const Seg* __restrict__ prefix,
                                   int* __restrict__ mult,
                                   long long* __restrict__ psum, long long n) {
  __shared__ Chunk<K> c;
  __shared__ Seg buf[2 * kThreads];
  const int cnt = load_chunk(s, v, L, c);
  Seg incl, excl;
  block_scan(thread_segment(c, cnt), buf, incl, excl);
  Seg run = combine(prefix[blockIdx.x], excl);
  const int j0 = static_cast<int>(threadIdx.x) * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = j0 + k;
    if (j < cnt) {
      run = combine(run, element(c, j));
      const K key = c.key[j];
      const int row = c.val[j];
      if ((key & 1) && key != Pad<K>::value && row >= 0 && row < n) {
        mult[row] = run.count;
        psum[row] = run.sum;
      }
    }
  }
}

template <typename K>
int launch(const void* s, const void* v, long long L, long long n,
           void* scratch, void* mult, void* psum, void* stream) {
  if (L < 0 || L > 0x7FFFFFFFLL || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L == 0) return 0;
  const long long blocks = (L + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const K* sp = static_cast<const K*>(s);
  const int* vp = static_cast<const int*>(v);
  Seg* agg = static_cast<Seg*>(scratch);
  stats_reduce_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      sp, vp, L, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_scan_blocks_kernel<<<1, kScanThreads, 0, st>>>(agg, blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_apply_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      sp, vp, L, agg, static_cast<int*>(mult), static_cast<long long*>(psum),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch the wrapper allocates for a stream of L elements.
extern "C" long long ccve_merge_stats_scratch_bytes(long long L) {
  return ((L + kChunk - 1) / kChunk) * static_cast<long long>(sizeof(Seg));
}

// s: int32[L] or int64[L]; v: int32[L]; mult: int32[n], psum: int64[n]
// (rows that no probe of the stream names are left as they are); scratch:
// as sized above.
extern "C" int ccve_merge_stats_i32(const void* s, const void* v, long long L,
                                    long long n, void* scratch, void* mult,
                                    void* psum, void* stream) {
  return launch<int>(s, v, L, n, scratch, mult, psum, stream);
}

extern "C" int ccve_merge_stats_i64(const void* s, const void* v, long long L,
                                    long long n, void* scratch, void* mult,
                                    void* psum, void* stream) {
  return launch<long long>(s, v, L, n, scratch, mult, psum, stream);
}
