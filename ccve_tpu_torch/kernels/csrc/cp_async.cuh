// Asynchronous copies from device memory into shared memory (cp.async),
// shared by the staged merge (merge_multi.cu), the compaction (compact.cu)
// and the merge counts (merge_counts.cu). The copies are PTX under __CUDA_ARCH__, with a memcpy in
// their place elsewhere, so that a host emulation of a kernel runs the same
// staging arithmetic.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace cp_async {

__device__ __forceinline__ void copy16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

template <int kBytes>
__device__ __forceinline__ void copy_small(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
               : "memory");
#else
  memcpy(dst, src, kBytes);
#endif
}

// This thread's copies are complete (then a barrier makes every thread's
// visible to the block).
__device__ __forceinline__ void wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Closes this thread's copies issued since the last commit into a group.
__device__ __forceinline__ void commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// This thread's committed groups are complete but the newest kPending
// (then a barrier makes every thread's visible to the block).
template <int kPending>
__device__ __forceinline__ void wait_group() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
#endif
}

// Where `stage` places a copy of src in `region` from slot `start` on:
// 16-byte congruent with src.
template <typename T>
__device__ __forceinline__ T* staged_at(const T* src, T* region, int start) {
  constexpr int V = 16 / sizeof(T);
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(T)) % V);
  return region + start + ((phase - start) % V + V) % V;
}

// Starts copying src[0, n) into `region` (16-byte aligned) from slot
// `start` on, by the block's kThreads threads, and returns the copy, placed
// 16-byte congruent with src: the body moves in 16-byte copies, the head
// and tail element by element. Uses slots up to start + n + 16 /
// sizeof(T) - 1. Complete after wait_all() and a barrier.
template <int kThreads, typename T>
__device__ __forceinline__ T* stage(const T* src, int n, T* region, int start) {
  constexpr int V = 16 / sizeof(T);
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(T)) % V);
  T* dst = staged_at(src, region, start);
  int head = (V - phase) % V;
  if (head > n) head = n;
  const int body = (n - head) / V;
  const int tail = head + body * V;
  for (int v = threadIdx.x; v < body; v += kThreads) {
    copy16(dst + head + v * V, src + head + v * V);
  }
  for (int i = threadIdx.x; i < head + n - tail; i += kThreads) {
    const int e = i < head ? i : tail + i - head;
    copy_small<sizeof(T)>(dst + e, src + e);
  }
  return dst;
}

}  // namespace cp_async
