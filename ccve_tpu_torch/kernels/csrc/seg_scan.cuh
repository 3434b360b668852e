// A two-pass segmented block scan over one sorted stream, shared by the
// stats scans (merge_stats.cu) and the dense build counts
// (merge_counts.cu).
//
// CUDA blocks run in no order and nothing carries from one block to the
// next, so the TPU kernels' carried cursors and running sums become two
// passes. Pass 1 (`seg_reduce_kernel`) reduces each block's chunk of
// kChunk elements to its segment aggregate; one block
// (`seg_scan_blocks_kernel`) then scans the aggregates in place into each
// block's exclusive prefix; pass 2 (`seg_apply_kernel`) rescans each chunk
// from its prefix and hands every element its inclusive segment value.
//
// A stream policy P says what an element is and what is written:
//   using Seg = ...;     // POD: static Seg identity(), static Seg
//                        // combine(const Seg&, const Seg&), associative
//   using Shared = ...;  // the staged chunk, in static shared memory
//   int load(Shared&, long long base, long long L) const;
//                        // stage elements [base, base + cnt) (and the one
//                        // before base); return cnt. The kernel
//                        // synchronises after it.
//   Seg element(const Shared&, int j, bool first) const;
//                        // element j of the chunk; `first` marks the
//                        // stream's element 0
//   void emit(const Shared&, int j, long long i, const Seg& run) const;
//                        // element j (stream position i) with its
//                        // inclusive scan value
#pragma once

#include <cuda_runtime.h>

namespace seg_scan {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // stream elements per block
constexpr int kScanThreads = 1024;

// Inclusive and exclusive scans of one S per thread across the block.
// `buf` holds 2 * blockDim.x entries; the scan ends with a barrier, so the
// caller may reuse it.
template <class S>
__device__ void block_scan(S x, S* buf, S& incl, S& excl) {
  const int t = threadIdx.x;
  const int n = blockDim.x;
  int in = 0;
  buf[t] = x;
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    S v = buf[in * n + t];
    if (t >= off) v = S::combine(buf[in * n + t - off], v);
    buf[(in ^ 1) * n + t] = v;
    __syncthreads();
    in ^= 1;
  }
  incl = buf[in * n + t];
  excl = t ? buf[in * n + t - 1] : S::identity();
  __syncthreads();
}

// The segment of this thread's kItems elements of the staged chunk.
template <class P>
__device__ typename P::Seg thread_segment(const P& p,
                                          const typename P::Shared& sh,
                                          int cnt) {
  using Seg = typename P::Seg;
  Seg a = Seg::identity();
  const int j0 = static_cast<int>(threadIdx.x) * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = j0 + k;
    if (j < cnt) a = Seg::combine(a, p.element(sh, j, j == 0 && blockIdx.x == 0));
  }
  return a;
}

template <class P>
__global__ void seg_reduce_kernel(P p, long long L, typename P::Seg* agg) {
  using Seg = typename P::Seg;
  __shared__ typename P::Shared sh;
  __shared__ Seg buf[2 * kThreads];
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const int cnt = p.load(sh, base, L);
  __syncthreads();
  Seg incl, excl;
  block_scan(thread_segment(p, sh, cnt), buf, incl, excl);
  if (threadIdx.x == blockDim.x - 1) agg[blockIdx.x] = incl;
}

// One block: agg[b] becomes the exclusive prefix of blocks [0, b).
template <class S>
__global__ void seg_scan_blocks_kernel(S* agg, long long n_blocks) {
  __shared__ S buf[2 * kScanThreads];
  __shared__ S tile_total;
  S carry = S::identity();
  for (long long off = 0; off < n_blocks; off += blockDim.x) {
    const long long i = off + threadIdx.x;
    const S x = i < n_blocks ? agg[i] : S::identity();
    S incl, excl;
    block_scan(x, buf, incl, excl);
    if (i < n_blocks) agg[i] = S::combine(carry, excl);
    if (threadIdx.x == blockDim.x - 1) tile_total = incl;
    __syncthreads();
    carry = S::combine(carry, tile_total);
    __syncthreads();
  }
}

template <class P>
__global__ void seg_apply_kernel(P p, long long L,
                                 const typename P::Seg* prefix) {
  using Seg = typename P::Seg;
  __shared__ typename P::Shared sh;
  __shared__ Seg buf[2 * kThreads];
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const int cnt = p.load(sh, base, L);
  __syncthreads();
  Seg incl, excl;
  block_scan(thread_segment(p, sh, cnt), buf, incl, excl);
  Seg run = Seg::combine(prefix[blockIdx.x], excl);
  const int j0 = static_cast<int>(threadIdx.x) * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = j0 + k;
    if (j < cnt) {
      run = Seg::combine(run, p.element(sh, j, j == 0 && blockIdx.x == 0));
      p.emit(sh, j, base + j, run);
    }
  }
}

inline long long n_blocks(long long L) { return (L + kChunk - 1) / kChunk; }

// Bytes of scratch a stream of L elements needs: one Seg a block.
template <class S>
long long scratch_bytes(long long L) {
  return n_blocks(L) * static_cast<long long>(sizeof(S));
}

// The three launches over a stream of L (0 <= L < 2^31) elements.
template <class P>
int run(const P& p, long long L, void* scratch, cudaStream_t st) {
  using Seg = typename P::Seg;
  if (L < 0 || L > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  const long long blocks = n_blocks(L);
  Seg* agg = static_cast<Seg*>(scratch);
  seg_reduce_kernel<P><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      p, L, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_scan_blocks_kernel<Seg><<<1, kScanThreads, 0, st>>>(agg, blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_apply_kernel<P><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      p, L, agg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace seg_scan
