// Merge stats: per-probe match count and matched-payload sum over a
// sorted sort-merge stream, three stream forms on one segmented scan
// (seg_scan.cuh).
//
//  - ccve_merge_stats_i32 / _i64: the merged stream s[0, L) of
//    `key' << 1 | tag` (int32, or int64), builds even (tag 0, so they
//    precede the probes of their key) and probes odd, with an int32 cargo
//    plane v: a build's payload (any sign) or a probe's row id in [0, n).
//    The key type's maximum is sort padding, never counted as a probe.
//    Output mult int32[n] and psum int64[n], written into probe row order:
//    for probe row r, the number of builds with its key and the sum of
//    their payloads. Rows no probe names keep their value; a probe whose
//    row lies outside [0, n) is ignored; a row that several probes name
//    gets one of their values.
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
// What bounds it on an H100: device memory. The scan reads the stream
// once (8 bytes an element for int32 keys with their plane, 12 for int64
// keys, 16 for the generic form, 8 for the packed one); the per-element
// forms write 12 bytes an element, the row form 12 bytes a probe row, and
// the scan's few operations an element are far below the card's rate.
// What costs is how the bytes are written. The row form's probes come in
// key order and their rows in random order; at 2^24 rows its outputs (192
// MB) are four times the L2. A store that fills part of a 32-byte sector
// costs the card about as much as a whole one, and one that misses L2
// more: on an H100 80GB HBM3, a scan whose last pass wrote each probe's
// 4-byte and 8-byte results to its row took 2.37 ms at the wide stats
// shape, 0.44 writing the same bytes in stream order, and a 16-byte record
// a probe to a staging slot took 0.69 ms more than no record while the
// records of a sector came from different warps (stats_sweep).
//
// Design: a segmented sum, (count, payload sum) restarting at each key
// run, by seg_scan.cuh's single-pass scan (one read of the stream, one
// launch). A segmented scan is exact for payloads of any sign, so the
// cummax trick and its non-negative restriction are gone, and psum is
// native int64: the (hi, lo) limbs have no job. The per-element forms
// write their outputs striped, whole sectors. The row form stages its
// results so that every write is of whole sectors. Rows fall in buckets
// of 2^kBucketLog (16384 rows, 192 KB of output). A scan block sorts its
// probes' (row, mult, psum) records by bucket in shared memory: a shared
// atomic add on the bucket's count gives a record its place; a block scan
// of the counts, each rounded up to even (a filler record pads an odd
// one), lays the runs out; one global atomic add a bucket reserves each
// run's slots, and the block writes the runs in order. Slots are 16 bytes
// and every run starts on an even slot and is even, so each sector is
// written whole by one instruction. A second kernel, a block a bucket,
// reads the bucket's records (fillers skipped), gathers them in shared
// memory (192 KB) and writes the bucket's rows in order: whole sectors
// where every row is named. A bucket holds its rows and one filler a tile,
// so with each row named once nothing overflows; a record that would is
// written to its row directly. Past 1024 buckets (n > 2^24), a probe takes
// its own slot with a global atomic add, unsorted. The TPU's unsort sort,
// its unsort-key plane and the packed psum << mult_bits | mult plane have
// no job. The generic form takes any length and no padding: INT64_MAX is
// a real key there, and a probe on it counts. The packed form's pay_bits
// is a kernel argument.

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::kChunk;
using seg_scan::kItems;
using seg_scan::kThreads;
using seg_scan::Seg;

constexpr int kBucketLog = 14;  // rows a bucket: 16384, 192 KB of output
constexpr int kBins = 1024;      // buckets a scan block sorts its records into
constexpr int kScatterThreads = 1024;
constexpr size_t kScatterSmem = (1 << kBucketLog) * (sizeof(int) + sizeof(long long)) +
                                (1 << kBucketLog) / 8;

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

// A probe's result on its way to its row; two fill a 32-byte sector. A
// negative row marks a filler, ~row its bucket.
struct __align__(16) Record {
  int row;
  int mult;
  long long psum;
};

// Scratch, from its start: the look-back's state and the bucket cursors
// (both zeroed before the scan), the look-back's values, then the staged
// records: a bucket's slots are its rows and, where blocks sort their
// records, one filler a tile, rounded up to even.
struct Layout {
  long long buckets, capacity, cursors, zeroed, values, records, bytes;

  Layout(long long L, long long n) {
    buckets = (n + (1LL << kBucketLog) - 1) >> kBucketLog;
    capacity = buckets > kBins ? 1LL << kBucketLog  // a slot a probe: no fillers
                               : ((1LL << kBucketLog) + seg_scan::n_tiles(L) + 1) & ~1LL;
    cursors = seg_scan::state_bytes(L);
    zeroed = cursors + 4 * buckets;
    values = seg_scan::round16(zeroed);
    records = (values + seg_scan::value_bytes(L) + 31) & ~31LL;
    bytes = records + buckets * capacity * static_cast<long long>(sizeof(Record));
  }
};

// Where the row form's results go: the staged records (see the design).
struct RowOut {
  int* cursor;
  Record* records;
  int* mult;
  long long* psum;
  int buckets;
  int capacity;

  static constexpr int kList = kChunk + kBins;  // a tile's records and fillers
  static constexpr size_t kSmem = kList * sizeof(Record) + 3 * kBins * sizeof(int);

  __device__ __forceinline__ void direct(int row, int count, long long sum) const {
    mult[row] = count;
    psum[row] = sum;
  }

  // The thread's first `valid` elements, those with row[k] >= 0 probes.
  // Every thread of the block calls it (see the design).
  __device__ void put(const int (&row)[kItems], const int (&count)[kItems],
                      const long long (&sum)[kItems], int valid, unsigned char* smem) const {
    const int t = threadIdx.x;
    if (buckets > kBins) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (k < valid && row[k] >= 0) {
          const int b = row[k] >> kBucketLog;
          const int slot = atomicAdd(cursor + b, 1);
          if (slot < capacity) {
            records[static_cast<long long>(b) * capacity + slot] = Record{row[k], count[k], sum[k]};
          } else {
            direct(row[k], count[k], sum[k]);
          }
        }
      }
      return;
    }
    Record* list = reinterpret_cast<Record*>(smem);
    int* bins = reinterpret_cast<int*>(list + kList);  // records a bucket
    int* at = bins + kBins;                            // a bucket's first in the list
    int* slot0 = at + kBins;                           // and its first slot
    __shared__ int warp_sum[seg_scan::kWarps];
    __shared__ int listed;
    for (int b = t; b < kBins; b += kThreads) bins[b] = 0;
    __syncthreads();
    int rank[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      rank[k] = k < valid && row[k] >= 0 ? atomicAdd(bins + (row[k] >> kBucketLog), 1) : 0;
    }
    __syncthreads();
    // each bucket's run, rounded up to even, in bucket order: 4 buckets a thread
    constexpr int kPer = kBins / kThreads;
    int even[kPer];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      even[j] = (bins[t * kPer + j] + 1) & ~1;
      mine += even[j];
    }
    const int lane = t & 31;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[t >> 5] = incl;
    __syncthreads();
    int first = incl - mine;
    for (int w = 0; w < (t >> 5); ++w) first += warp_sum[w];
    if (t == kThreads - 1) listed = first + mine;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = t * kPer + j;
      at[b] = first;
      slot0[b] = even[j] ? atomicAdd(cursor + b, even[j]) : 0;
      if (bins[b] & 1) list[first + bins[b]] = Record{~b, 0, 0};
      first += even[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k < valid && row[k] >= 0) {
        list[at[row[k] >> kBucketLog] + rank[k]] = Record{row[k], count[k], sum[k]};
      }
    }
    __syncthreads();
    // the runs out in list order: each starts on a sector and fills whole ones
    for (int i = t; i < listed; i += kThreads) {
      const Record x = list[i];
      const int b = x.row >= 0 ? x.row >> kBucketLog : ~x.row;
      const int slot = slot0[b] + (i - at[b]);
      if (slot < capacity) {
        records[static_cast<long long>(b) * capacity + slot] = x;
      } else if (x.row >= 0) {
        direct(x.row, x.mult, x.psum);
      }
    }
  }
};

// The row form: `key' << 1 | tag` keys with an int32 cargo plane.
template <typename K>
struct RowStats {
  size_t smem() const { return RowOut::kSmem; }  // above the loads' kSlots * sizeof(K)
  struct Items {
    K key[kItems];
    int val[kItems];  // after emit: the probe's row, or -1
    K prev;           // the key before the thread's first (unused at the stream's start)
    int count[kItems];
    long long sum[kItems];
  };
  const K* s;
  const int* v;
  long long n;
  RowOut out;

  __device__ void load(Items& it, long long tile0, long long L, unsigned char* smem) const {
    int unused;
    seg_scan::load_blocked(s, tile0, L, reinterpret_cast<K*>(smem), it.key, it.prev);
    seg_scan::load_blocked(v, tile0, L, reinterpret_cast<int*>(smem), it.val, unused);
  }
  __device__ Seg element(const Items& it, int k, long long i) const {
    const K key = it.key[k];
    const K prev = k ? it.key[k - 1] : it.prev;
    const bool build = (key & 1) == 0;
    return Seg{i == 0 || (key >> 1) != (prev >> 1), build ? 1 : 0,
               build ? static_cast<long long>(it.val[k]) : 0LL};
  }
  __device__ void emit(Items& it, int k, long long, const Seg& run) const {
    const K key = it.key[k];
    const int row = it.val[k];
    it.val[k] = (key & 1) && key != Pad<K>::value && row >= 0 && row < n ? row : -1;
    it.count[k] = run.count;
    it.sum[k] = run.sum;
  }
  __device__ void finish(const Items& it, long long tile0, long long L,
                         unsigned char* smem) const {
    const long long i0 = tile0 + static_cast<long long>(threadIdx.x) * kItems;
    const long long left = L - i0;
    const int valid = static_cast<int>(left < 0 ? 0 : left < kItems ? left : kItems);
    out.put(it.val, it.count, it.sum, valid, smem);
  }
};

// The per-element forms' outputs, striped through shared memory.
struct ElementOut {
  static constexpr size_t kSmem = seg_scan::kSlots * sizeof(long long);
  int* mult;
  long long* psum;

  __device__ void store(const int (&m)[kItems], const long long (&s)[kItems], long long tile0,
                        long long L, unsigned char* smem) const {
    seg_scan::store_blocked(mult, tile0, L, reinterpret_cast<int*>(smem), m);
    seg_scan::store_blocked(psum, tile0, L, reinterpret_cast<long long*>(smem), s);
  }
};

// The generic form: untagged int64 keys, tagged int64 payloads.
struct GenericStats {
  size_t smem() const { return ElementOut::kSmem; }
  struct Items {
    long long key[kItems];
    long long tag[kItems];
    long long prev;
    int mult[kItems];
    long long psum[kItems];
  };
  const long long* sk;
  const long long* st;
  ElementOut out;

  __device__ void load(Items& it, long long tile0, long long L, unsigned char* smem) const {
    long long unused;
    long long* buf = reinterpret_cast<long long*>(smem);
    seg_scan::load_blocked(sk, tile0, L, buf, it.key, it.prev);
    seg_scan::load_blocked(st, tile0, L, buf, it.tag, unused);
  }
  __device__ Seg element(const Items& it, int k, long long i) const {
    const long long prev = k ? it.key[k - 1] : it.prev;
    const long long tag = it.tag[k];
    const bool build = (tag & 1) != 0;
    return Seg{i == 0 || it.key[k] != prev, build ? 1 : 0,
               build ? (tag >> 1) : 0LL};  // arithmetic: payloads of any sign
  }
  __device__ void emit(Items& it, int k, long long, const Seg& run) const {
    const bool build = (it.tag[k] & 1) != 0;
    it.mult[k] = build ? 0 : run.count;
    it.psum[k] = build ? 0 : run.sum;
  }
  __device__ void finish(const Items& it, long long tile0, long long L,
                         unsigned char* smem) const {
    out.store(it.mult, it.psum, tile0, L, smem);
  }
};

// The packed form: key' << pay_bits | field in one int64.
struct PackedStats {
  size_t smem() const { return ElementOut::kSmem; }
  struct Items {
    long long s[kItems];
    long long prev;
    int mult[kItems];
    long long psum[kItems];
  };
  const long long* s;
  int pay_bits;
  ElementOut out;

  __device__ void load(Items& it, long long tile0, long long L, unsigned char* smem) const {
    seg_scan::load_blocked(s, tile0, L, reinterpret_cast<long long*>(smem), it.s, it.prev);
  }
  __device__ Seg element(const Items& it, int k, long long i) const {
    const long long x = it.s[k];
    const long long prev = k ? it.s[k - 1] : it.prev;
    const long long field = x & ((1LL << pay_bits) - 1);
    const bool build = (field & 1) == 0;
    return Seg{i == 0 || (x >> pay_bits) != (prev >> pay_bits), build ? 1 : 0,
               build ? (field >> 1) : 0LL};
  }
  __device__ void emit(Items& it, int k, long long, const Seg& run) const {
    const bool build = (it.s[k] & 1) == 0;  // the field's low bit
    it.mult[k] = build ? 0 : run.count;
    it.psum[k] = build ? 0 : run.sum;
  }
  __device__ void finish(const Items& it, long long tile0, long long L,
                         unsigned char* smem) const {
    out.store(it.mult, it.psum, tile0, L, smem);
  }
};

// Each bucket's staged records to their rows, a block a bucket: gathered
// in shared memory (kScatterSmem), then written in order, whole sectors
// where every row of the bucket is named.
__global__ void __launch_bounds__(kScatterThreads)
    scatter_kernel(const int* __restrict__ cursor, const Record* __restrict__ records,
                   int capacity, long long n, int* __restrict__ mult,
                   long long* __restrict__ psum) {
  constexpr int kRows = 1 << kBucketLog;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* ps = reinterpret_cast<long long*>(smem);
  int* m = reinterpret_cast<int*>(ps + kRows);
  unsigned* named = reinterpret_cast<unsigned*>(m + kRows);
  const int bucket = blockIdx.x;
  const long long row0 = static_cast<long long>(bucket) << kBucketLog;
  for (int i = threadIdx.x; i < kRows / 32; i += kScatterThreads) named[i] = 0;
  __syncthreads();
  const int count = min(cursor[bucket], capacity);
  const Record* r = records + static_cast<long long>(bucket) * capacity;
  for (int i = threadIdx.x; i < count; i += kScatterThreads) {
    const Record x = r[i];
    if (x.row < 0) continue;  // a filler
    const int j = x.row - static_cast<int>(row0);
    m[j] = x.mult;
    ps[j] = x.psum;
    atomicOr(named + (j >> 5), 1u << (j & 31));
  }
  __syncthreads();
  const int rows = static_cast<int>(n - row0 < kRows ? n - row0 : kRows);
  for (int j = threadIdx.x; j < rows; j += kScatterThreads) {
    if ((named[j >> 5] >> (j & 31)) & 1) {
      mult[row0 + j] = m[j];
      psum[row0 + j] = ps[j];
    }
  }
}

// Zero the look-back's state (and the bucket cursors), then scan.
template <class P>
int scan(const P& p, long long L, const Layout& lay, void* scratch, cudaStream_t stream) {
  unsigned char* base = static_cast<unsigned char*>(scratch);
  cudaError_t err = cudaMemsetAsync(base, 0, static_cast<size_t>(lay.zeroed), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return seg_scan::launch(p, L, seg_scan::tiles_at(base, base + lay.values, L), stream);
}

bool bad_length(long long L) { return L < 0 || L > 0x7FFFFFFFLL; }

template <typename K>
int row_stats(const void* s, const void* v, long long L, long long n, void* scratch,
              void* mult, void* psum, void* stream) {
  if (bad_length(L) || n < 0 || n > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L == 0 || n == 0) return 0;
  const Layout lay(L, n);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* cursor = reinterpret_cast<int*>(base + lay.cursors);
  Record* records = reinterpret_cast<Record*>(base + lay.records);
  const RowStats<K> p{static_cast<const K*>(s), static_cast<const int*>(v), n,
                      RowOut{cursor, records, static_cast<int*>(mult),
                             static_cast<long long*>(psum), static_cast<int>(lay.buckets),
                             static_cast<int>(lay.capacity)}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kScatterSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int code = scan(p, L, lay, scratch, st);
  if (code != 0) return code;
  scatter_kernel<<<static_cast<unsigned>(lay.buckets), kScatterThreads, kScatterSmem, st>>>(
      cursor, records, static_cast<int>(lay.capacity), n, static_cast<int*>(mult),
      static_cast<long long*>(psum));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch the wrapper allocates for a stream of L elements and n
// output rows (n = 0 for the per-element forms).
extern "C" long long ccve_merge_stats_scratch_bytes(long long L, long long n) {
  return Layout(L, n).bytes;
}

// s: int32[L] or int64[L]; v: int32[L]; mult: int32[n], psum: int64[n]
// (rows that no probe of the stream names are left as they are); scratch:
// as sized above.
extern "C" int ccve_merge_stats_i32(const void* s, const void* v, long long L, long long n,
                                    void* scratch, void* mult, void* psum, void* stream) {
  return row_stats<int>(s, v, L, n, scratch, mult, psum, stream);
}

extern "C" int ccve_merge_stats_i64(const void* s, const void* v, long long L, long long n,
                                    void* scratch, void* mult, void* psum, void* stream) {
  return row_stats<long long>(s, v, L, n, scratch, mult, psum, stream);
}

// sk, st: int64[L]; mult: int32[L], psum: int64[L], every element written.
extern "C" int ccve_merge_scan_stats_i64(const void* sk, const void* st, long long L,
                                         void* scratch, void* mult, void* psum, void* stream) {
  if (bad_length(L)) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  const GenericStats p{static_cast<const long long*>(sk), static_cast<const long long*>(st),
                       ElementOut{static_cast<int*>(mult), static_cast<long long*>(psum)}};
  return scan(p, L, Layout(L, 0), scratch, static_cast<cudaStream_t>(stream));
}

// s: int64[L]; 2 <= pay_bits <= 31; mult: int32[L], psum: int64[L].
extern "C" int ccve_merge_scan_stats_packed_i64(const void* s, long long L, int pay_bits,
                                                void* scratch, void* mult, void* psum,
                                                void* stream) {
  if (bad_length(L) || pay_bits < 2 || pay_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L == 0) return 0;
  const PackedStats p{static_cast<const long long*>(s), pay_bits,
                      ElementOut{static_cast<int*>(mult), static_cast<long long*>(psum)}};
  return scan(p, L, Layout(L, 0), scratch, static_cast<cudaStream_t>(stream));
}
