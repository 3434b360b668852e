// murmur64 hash finalizer of int64 keys: three rounds of x ^= x >> 32 with
// a wrapping multiply by 0xD6E8FEB86659FD93 between them, on uint64
// (the reference's murmurhash64, hash_functions.h:8-16).
//
// Replaces: ccve_tpu/kernels/murmur.py `_kernel` (entry
// `murmurhash64_pallas`, `_call`): the TPU's lanes are 32-bit, so that
// kernel splits each key into (hi, lo) u32 limbs in a [rows, 128] layout
// padded to whole grid blocks and emulates the 64-bit multiply with 16-bit
// digits. Hopper has 64-bit integer registers: this kernel hashes one key
// per thread on uint64_t, grid-stride, any n, no padding and no limbs.
//
// What bounds it on an H100: device memory. 16 bytes a key (read 8, write
// 8) over 3.35 TB/s is 0.0764 ms at 16M keys; the about ten integer
// operations a key are far below the card's rate.

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kMultiplier = 0xD6E8FEB86659FD93ull;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // a few waves of the 132 SMs

__global__ void murmur_kernel(const unsigned long long* __restrict__ x,
                              unsigned long long* __restrict__ y,
                              long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    unsigned long long v = x[i];
    v ^= v >> 32;
    v *= kMultiplier;
    v ^= v >> 32;
    v *= kMultiplier;
    v ^= v >> 32;
    y[i] = v;
  }
}

}  // namespace

// x, y: int64[n] (the uint64 bits); y may not alias x.
extern "C" int ccve_murmurhash64_i64(const void* x, void* y, long long n,
                                     void* stream) {
  if (n < 0 || n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  murmur_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(x),
      static_cast<unsigned long long*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
