// The merge-path search and the serial merge that the multi-plane merge
// (merge_multi.cu) and the tile sort (sort_tiles.cu)
// share. Both merge two ascending sequences A[0, na) and B[0, nb) stably:
// at equal keys A's element comes first. The sequences are read through
// `load_a(i)` and `load_b(j)` and compared by `le(x, y)` (x <= y), so
// that each caller keeps its own storage: staged key slices, or (key,
// index) words in shared memory.
#pragma once

#include <cuda_runtime.h>

namespace merge_path {

// Number of A's elements among the first d outputs of the merge: the
// least i in [max(0, d - nb), min(d, na)] with !(A[i] <= B[d - i - 1]),
// by binary search.
template <typename LoadA, typename LoadB, typename LessEq>
__device__ __forceinline__ int split(int na, int nb, int d, LoadA load_a, LoadB load_b,
                                     LessEq le) {
  int lo = d - nb > 0 ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (le(load_a(mid), load_b(d - mid - 1))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Outputs k = 0 .. count - 1 (count <= kItems) of the merge from position
// (ai, bi), each handed to emit(k, value, from_a, index) in order; every
// element is loaded once. Unrolled, so that emit may write a register
// array at k.
template <int kItems, typename T, typename LoadA, typename LoadB, typename LessEq,
          typename Emit>
__device__ __forceinline__ void serial(int ai, int na, int bi, int nb, int count,
                                       LoadA load_a, LoadB load_b, LessEq le, Emit emit) {
  T x = ai < na ? load_a(ai) : T{};
  T y = bi < nb ? load_b(bi) : T{};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (k < count) {
      if (ai < na && (bi >= nb || le(x, y))) {
        emit(k, x, true, ai);
        if (++ai < na) x = load_a(ai);
      } else {
        emit(k, y, false, bi);
        if (++bi < nb) y = load_b(bi);
      }
    }
  }
}

}  // namespace merge_path
