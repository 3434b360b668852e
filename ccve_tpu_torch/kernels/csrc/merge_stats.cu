// Merge stats: per-probe match count and matched-payload sum over a
// sorted sort-merge stream, three stream forms on one segmented scan
// (seg_scan.cuh).
//
//  - ccve_merge_stats_i32 / _i64: the merged stream s[0, L) of
//    `key' << 1 | tag` (int32, or int64), builds even (tag 0, so they
//    precede the probes of their key) and probes odd, with an int32 cargo
//    plane v: a build's payload (any sign) or a probe's row id in [0, n).
//    The key type's maximum is sort padding, never counted as a probe.
//    Output mult int32[n] and psum int64[n], written straight into probe
//    row order: for probe row r, the number of builds with its key and the
//    sum of their payloads.
//  - ccve_merge_scan_stats_i64: the generic form, a sorted stream of
//    untagged int64 keys sk[0, L) (any value, INT64_MIN and INT64_MAX
//    included) with the tagged int64 payload st: a build's payload as
//    pay * 2 + 1, a probe 0. A probe counts the builds of its key that
//    precede it, so the sort puts builds first at equal keys. Output per
//    element, in stream order: mult int32[L] and psum int64[L], zero at
//    builds.
//  - ccve_merge_scan_stats_packed_i64: the packed form, one sorted int64
//    stream s[0, L) of `key' << pay_bits | field` (2 <= pay_bits <= 31):
//    a build's field is even, pay * 2, a probe's the all-ones tag, so a
//    key's builds sort before its probes. Output per element as above.
//
// Replaces: ccve_tpu/kernels/merge_scan.py `_make_stats32_kernel` (entry
// `merge_scan_stats32`), which scans the stream tile by tile in order,
// carrying the running build count, a 64-bit payload prefix in (hi, lo)
// limbs and the run bases (a cummax, so payloads must be non-negative)
// from one grid step to the next, and emits per-position planes plus an
// unsort key that a second multi-plane sort turns into row order. The
// int64 builds replace `_kernel` (merge_scan.py:47, through `_call`): on
// the wide stats path (ops/sort_merge.py:504) as the row-order form, and
// through its generic entry `merge_scan_stats(sk, st)` (merge_scan.py:166,
// the totals of a key span of 2^62 or more) as the generic form: the same
// scan over (hi, lo) int32 limbs of the untagged key and of the tagged
// payload, with the same cummax base. The packed form replaces
// `_make_packed_kernel` (merge_scan.py:62, entry `merge_scan_stats_packed`
// :736), which decodes key' and field from (hi, lo) limbs in-kernel.
//
// What bounds it on an H100: device memory. Each of the two scan passes
// reads the stream (8 bytes an element for int32 keys with their plane,
// 12 for int64 keys, 16 for the generic form, 8 for the packed one); the
// last pass scatters 12 bytes a probe (row form) or writes 12 bytes an
// element (the per-element forms). The scans are a few operations an
// element.
//
// Design: a segmented sum, (count, payload sum) restarting at each key
// run, by seg_scan.cuh's two-pass block scan. A segmented scan is exact
// for payloads of any sign, so the cummax trick and its non-negative
// restriction are gone, and psum is native int64: the (hi, lo) limbs have
// no job. The row form scatters to out[row id] without atomics (each probe
// row id is unique), so the TPU's unsort sort, its unsort-key plane and
// the packed psum << mult_bits | mult plane have no job either. The
// generic form takes any length and no padding: INT64_MAX is a real key
// there, and a probe on it counts. The packed form's pay_bits is a kernel
// argument. Static shared memory: the staged chunk (16 KB for int32 keys
// with their plane, 24 KB for int64 ones, 32 KB for the generic form's
// two int64 planes, 16 KB for the packed form) plus 8 KB for the scan
// buffer, under the 48 KB limit.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::kChunk;

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
struct StatSeg {
  int start;
  int count;
  long long sum;

  static __device__ __forceinline__ StatSeg identity() {
    return StatSeg{0, 0, 0};
  }
  static __device__ __forceinline__ StatSeg combine(const StatSeg& a,
                                                    const StatSeg& b) {
    return StatSeg{a.start | b.start, b.start ? b.count : a.count + b.count,
                   b.start ? b.sum : a.sum + b.sum};
  }
};

// The row form: `key' << 1 | tag` keys with an int32 cargo plane.
template <typename K>
struct RowStats {
  using Seg = StatSeg;
  struct Shared {
    K key[kChunk];
    int val[kChunk];
    K prev;  // the key just before the chunk (unused for chunk 0)
  };
  const K* s;
  const int* v;
  long long n;
  int* mult;
  long long* psum;

  __device__ int load(Shared& sh, long long base, long long L) const {
    const int cnt = static_cast<int>(L - base < kChunk ? L - base : kChunk);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      sh.key[i] = s[base + i];
      sh.val[i] = v[base + i];
    }
    if (threadIdx.x == 0) sh.prev = base > 0 ? s[base - 1] : 0;
    return cnt;
  }
  __device__ Seg element(const Shared& sh, int j, bool first) const {
    const K key = sh.key[j];
    const K prev = j ? sh.key[j - 1] : sh.prev;
    const bool build = (key & 1) == 0;
    return Seg{first || (key >> 1) != (prev >> 1), build ? 1 : 0,
               build ? static_cast<long long>(sh.val[j]) : 0LL};
  }
  __device__ void emit(const Shared& sh, int j, long long, const Seg& run) const {
    const K key = sh.key[j];
    const int row = sh.val[j];
    if ((key & 1) && key != Pad<K>::value && row >= 0 && row < n) {
      mult[row] = run.count;
      psum[row] = run.sum;
    }
  }
};

// The generic form: untagged int64 keys, tagged int64 payloads.
struct GenericStats {
  using Seg = StatSeg;
  struct Shared {
    long long key[kChunk];
    long long tag[kChunk];
    long long prev;
  };
  const long long* sk;
  const long long* st;
  int* mult;
  long long* psum;

  __device__ int load(Shared& sh, long long base, long long L) const {
    const int cnt = static_cast<int>(L - base < kChunk ? L - base : kChunk);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      sh.key[i] = sk[base + i];
      sh.tag[i] = st[base + i];
    }
    if (threadIdx.x == 0) sh.prev = base > 0 ? sk[base - 1] : 0;
    return cnt;
  }
  __device__ Seg element(const Shared& sh, int j, bool first) const {
    const long long prev = j ? sh.key[j - 1] : sh.prev;
    const long long tag = sh.tag[j];
    const bool build = (tag & 1) != 0;
    return Seg{first || sh.key[j] != prev, build ? 1 : 0,
               build ? (tag >> 1) : 0LL};  // arithmetic: payloads of any sign
  }
  __device__ void emit(const Shared& sh, int j, long long i, const Seg& run) const {
    const bool build = (sh.tag[j] & 1) != 0;
    mult[i] = build ? 0 : run.count;
    psum[i] = build ? 0 : run.sum;
  }
};

// The packed form: key' << pay_bits | field in one int64.
struct PackedStats {
  using Seg = StatSeg;
  struct Shared {
    long long s[kChunk];
    long long prev;
  };
  const long long* s;
  int pay_bits;
  int* mult;
  long long* psum;

  __device__ int load(Shared& sh, long long base, long long L) const {
    const int cnt = static_cast<int>(L - base < kChunk ? L - base : kChunk);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) sh.s[i] = s[base + i];
    if (threadIdx.x == 0) sh.prev = base > 0 ? s[base - 1] : 0;
    return cnt;
  }
  __device__ Seg element(const Shared& sh, int j, bool first) const {
    const long long x = sh.s[j];
    const long long prev = j ? sh.s[j - 1] : sh.prev;
    const long long field = x & ((1LL << pay_bits) - 1);
    const bool build = (field & 1) == 0;
    return Seg{first || (x >> pay_bits) != (prev >> pay_bits), build ? 1 : 0,
               build ? (field >> 1) : 0LL};
  }
  __device__ void emit(const Shared& sh, int j, long long i, const Seg& run) const {
    const bool build = (sh.s[j] & 1) == 0;  // the field's low bit
    mult[i] = build ? 0 : run.count;
    psum[i] = build ? 0 : run.sum;
  }
};

template <typename K>
int row_stats(const void* s, const void* v, long long L, long long n,
              void* scratch, void* mult, void* psum, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const RowStats<K> p{static_cast<const K*>(s), static_cast<const int*>(v), n,
                      static_cast<int*>(mult), static_cast<long long*>(psum)};
  return seg_scan::run(p, L, scratch, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Bytes of scratch the wrapper allocates for a stream of L elements (every
// form of this file).
extern "C" long long ccve_merge_stats_scratch_bytes(long long L) {
  return seg_scan::scratch_bytes<StatSeg>(L);
}

// s: int32[L] or int64[L]; v: int32[L]; mult: int32[n], psum: int64[n]
// (rows that no probe of the stream names are left as they are); scratch:
// as sized above.
extern "C" int ccve_merge_stats_i32(const void* s, const void* v, long long L,
                                    long long n, void* scratch, void* mult,
                                    void* psum, void* stream) {
  return row_stats<int>(s, v, L, n, scratch, mult, psum, stream);
}

extern "C" int ccve_merge_stats_i64(const void* s, const void* v, long long L,
                                    long long n, void* scratch, void* mult,
                                    void* psum, void* stream) {
  return row_stats<long long>(s, v, L, n, scratch, mult, psum, stream);
}

// sk, st: int64[L]; mult: int32[L], psum: int64[L], every element written.
extern "C" int ccve_merge_scan_stats_i64(const void* sk, const void* st,
                                         long long L, void* scratch,
                                         void* mult, void* psum,
                                         void* stream) {
  const GenericStats p{static_cast<const long long*>(sk),
                       static_cast<const long long*>(st),
                       static_cast<int*>(mult), static_cast<long long*>(psum)};
  return seg_scan::run(p, L, scratch, static_cast<cudaStream_t>(stream));
}

// s: int64[L]; 2 <= pay_bits <= 31; mult: int32[L], psum: int64[L].
extern "C" int ccve_merge_scan_stats_packed_i64(const void* s, long long L,
                                                int pay_bits, void* scratch,
                                                void* mult, void* psum,
                                                void* stream) {
  if (pay_bits < 2 || pay_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PackedStats p{static_cast<const long long*>(s), pay_bits,
                      static_cast<int*>(mult), static_cast<long long*>(psum)};
  return seg_scan::run(p, L, scratch, static_cast<cudaStream_t>(stream));
}
