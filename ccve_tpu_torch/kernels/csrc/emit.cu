// The emission of a sorted join level: each output row written once from
// the compacted triples.
//
//  - ccve_emit_rows_i32: #9's compacted planes (int32[3, plane_len]: probe
//    row, key', payload; the first n_keep slots hold the level's matches),
//    the key offset kmin - 1 (int64, wrapping: key = key' + kmin - 1), the
//    partial output rows `state` (int64[rows, W], row-major) and the join
//    column `level`. Writes out (int64[n_keep, W + 2], row-major): row i is
//    state[row[i], :] with column `level` set to key[i], then (key,
//    payload) when `full`, else (0, key).
//
// Replaces no Pallas kernel: the JAX package emits a level with takes and
// concatenations (ccve_tpu/exec/bulk.py:342-390, `bulk_materialize`: the
// survivors' row ids and appended columns gathered, the new columns
// stacked and concatenated, the probe rows gathered at the end), and the
// port's plain version (kernels/emit.py `emit_rows_plain`) with a gather,
// a stack and a concatenation.
//
// What bounds it on an H100: device memory, and the writes above all. At
// W = 1 it reads 8 bytes a row (key' and payload) and writes 24; at config
// 1's 16M rows, 512 MB, 0.153 ms at 3.35 TB/s. Its few integer operations
// a row are far below the card's rate.
//
// Design: a row is W + 2 int64 words, so a thread storing its own rows
// would store strided 8-byte words, partial sectors that cost the card.
// Instead a block stages a tile of rows in shared memory as they will lie
// in `out`, then writes the tile's contiguous block with 16-byte stores
// (a tile starts on an even word, so every pair is 16-byte aligned). The
// planes are read striped, a row a thread, four rows' loads in flight
// before any is staged. The join column is written from the key: a probe
// matches only its own key (a clamped probe matches nothing), so
// state[row, level] is the key; only the other W - 1 columns are gathered,
// after a barrier, a state row's words read by consecutive threads. At W =
// 1 the row plane is not read at all.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsInFlight = 4;         // rows a thread loads before it stages
constexpr int kMaxTileRows = 1024;
constexpr int kStageBytes = 48 * 1024;   // a block's stage, no opt-in needed

// Rows a tile: the largest power of two up to kMaxTileRows whose stage (W + 2
// words a row, and the row index when W > 1) fits kStageBytes; 0 where not
// even two rows fit. Even, so that every tile starts on a 16-byte boundary.
int tile_rows(int width) {
  const long long row_bytes = 8LL * (width + 2) + (width > 1 ? 4 : 0);
  int t = kMaxTileRows;
  while (t >= 2 && t * row_bytes > kStageBytes) t >>= 1;
  return t >= 2 ? t : 0;
}

__global__ void __launch_bounds__(kThreads)
emit_rows_kernel(const int* __restrict__ planes, long long plane_len, long long n_keep,
                 long long key_off, const long long* __restrict__ state, int width,
                 int level, int full, int tile, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* stage = reinterpret_cast<long long*>(smem);
  const int w2 = width + 2;
  int* src = reinterpret_cast<int*>(stage + static_cast<long long>(tile) * w2);
  const int* rows = planes;
  const int* keys = planes + plane_len;
  const int* pays = planes + 2 * plane_len;
  const long long r0 = static_cast<long long>(blockIdx.x) * tile;
  const int n = static_cast<int>(n_keep - r0 < tile ? n_keep - r0 : tile);
  const int bd = blockDim.x;
  const unsigned long long off = static_cast<unsigned long long>(key_off);

  // 1. the planes, striped; the level's columns staged
  for (int first = threadIdx.x; first < n; first += kRowsInFlight * bd) {
    int k[kRowsInFlight], p[kRowsInFlight], s[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const int r = first + j * bd;
      if (r < n) {
        k[j] = __ldg(keys + r0 + r);
        p[j] = __ldg(pays + r0 + r);
        if (width > 1) s[j] = __ldg(rows + r0 + r);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const int r = first + j * bd;
      if (r < n) {
        const long long key = static_cast<long long>(
            static_cast<unsigned long long>(static_cast<long long>(k[j])) + off);
        long long* row = stage + static_cast<long long>(r) * w2;
        row[level] = key;
        row[width] = full ? key : 0;
        row[width + 1] = full ? static_cast<long long>(p[j]) : key;
        if (width > 1) src[r] = s[j];
      }
    }
  }
  // 2. the state's other columns, each row's words read by consecutive threads
  if (width > 1) {
    __syncthreads();
    const int words = n * width;
    for (int w = threadIdx.x; w < words; w += bd) {
      const int r = w / width;
      const int c = w - r * width;
      if (c != level) {
        stage[static_cast<long long>(r) * w2 + c] =
            __ldg(state + static_cast<long long>(src[r]) * width + c);
      }
    }
  }
  __syncthreads();
  // 3. the tile's contiguous block of out, 16 bytes a store
  const int total = n * w2;
  long long* dst = out + r0 * w2;
  const longlong2* from = reinterpret_cast<const longlong2*>(stage);
  longlong2* to = reinterpret_cast<longlong2*>(dst);
  for (int q = threadIdx.x; q < total / 2; q += bd) to[q] = from[q];
  if ((total & 1) && threadIdx.x == 0) dst[total - 1] = stage[total - 1];
}

}  // namespace

// planes: int32[3, plane_len]; 0 <= n_keep <= plane_len < 2^31; state:
// int64[rows, width] with every row[i] < rows; 0 <= level < width; out:
// int64[n_keep, width + 2], 16-byte aligned, not aliasing state. n_keep = 0
// launches nothing.
extern "C" int ccve_emit_rows_i32(const void* planes, long long plane_len, long long n_keep,
                                  long long key_off, const void* state, int width, int level,
                                  int full, void* out, void* stream) {
  const int tile = width >= 1 ? tile_rows(width) : 0;
  if (n_keep < 0 || n_keep > plane_len || plane_len > 0x7FFFFFFFLL || tile == 0 ||
      level < 0 || level >= width || (reinterpret_cast<unsigned long long>(out) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_keep == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_keep + tile - 1) / tile;
  const size_t smem = static_cast<size_t>(tile) * (8 * (width + 2) + (width > 1 ? 4 : 0));
  emit_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(planes), plane_len, n_keep, key_off,
      static_cast<const long long*>(state), width, level, full, tile,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
