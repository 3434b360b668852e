"""Inputs that hold two kernels at the edges of their designs, as numpy
arrays made from a seeded generator: `chunk_rank_cases` for #11
(`kernels.chunk_probe.chunk_rank`, csrc/chunk_rank.cu) and
`dense_counts_cases` for #4 (`kernels.merge_scan.merge_scan_build_counts`,
csrc/dense_counts.cu). `chip_smoke.py` and tests/test_torch_cuda.py hold
each kernel against its plain version on them, exactly; the CPU tests
hold the plain versions against numpy.
"""

from __future__ import annotations

import numpy as np

from ccve_tpu_torch.kernels.chunk_probe import INDEX_MAX, MIN_STRIDE_LOG, index_stride_log
from ccve_tpu_torch.kernels.merge_scan import DENSE_TILE

I64 = np.iinfo(np.int64)
I32_MAX = 2**31 - 1
LANES = 2048  # config 3's chunk
HOT_RUN = 12_000  # table rows of the hot key (mult >= 10,000)
HOT_PROBES = 100_000  # probes of #4's hot key at the kernel's own tile


def _lanes(rng, table: np.ndarray, extra=()) -> tuple[np.ndarray, np.ndarray]:
    """(keys int64[LANES], valid bool[LANES]): the `extra` keys, the
    index's sampled keys and the rows on both sides of each leaf boundary,
    keys drawn from the table, and keys drawn around its range; 90 %
    valid."""
    parts = [np.asarray(extra, np.int64)]
    m = table.size
    if m:
        stride = 1 << index_stride_log(m)
        edges = np.arange(stride, m, stride)
        parts += [table[::stride][:256], table[edges[:128] - 1], table[edges[:128]],
                  table[np.minimum(edges[:128] + 1, m - 1)], table[-1:] + 1, table[:1] - 1,
                  rng.choice(table, LANES // 4)]
        lo, hi = float(table[0]), float(table[-1])
        parts.append(np.clip(rng.uniform(lo - 10, hi + 10, LANES), -2.0**62, 2.0**62)
                     .astype(np.int64))
    else:
        parts.append(rng.integers(-50, 50, LANES))
    keys = np.concatenate(parts)[:LANES]
    return keys, rng.random(LANES) < 0.9


def _straddling(m: int, stride: int, run: int) -> np.ndarray:
    """Distinct even keys with a run of `run` (< 4 `stride`) equal keys
    across every fourth leaf boundary (the rows around each multiple of
    4 `stride`)."""
    table = np.arange(m, dtype=np.int64) * 2
    for b in range(4 * stride, m, 4 * stride):
        table[b - run // 2:b + run - run // 2] = table[b]
    return table


def chunk_rank_cases(rng, big: bool = True) -> list:
    """[(what, table int64[m] ascending, keys int64[LANES], valid
    bool[LANES])]: tables of m = stride·k and stride·k ± 1 (at the least
    stride, and where the stride first doubles), the index's sampled keys
    and the rows beside each leaf boundary among the keys, duplicate runs
    straddling leaf boundaries, a hot key with HOT_RUN rows, the int64
    extremes, m = 0 and 1, and with `big` tables of 2^21 and 2^24 rows,
    where the stride is 2^9 and 2^12."""
    s0 = 1 << MIN_STRIDE_LOG
    cases = []
    for m in (1, s0 - 1, s0, s0 + 1, 37 * s0 - 1, 37 * s0, 37 * s0 + 1,
              INDEX_MAX * s0 - 1, INDEX_MAX * s0, INDEX_MAX * s0 + 1):
        table = np.sort(rng.integers(0, 3 * m, m))
        cases.append((f"m={m}", table, *_lanes(rng, table)))
    for run in (2, 3, s0 + 1, 2 * s0 + 3):
        table = _straddling(50_000, s0, run)
        cases.append((f"runs of {run} across leaf boundaries", table, *_lanes(rng, table)))
    hot = 10**6 // 2
    table = np.sort(np.concatenate([rng.integers(0, 10**6, 40_000), np.full(HOT_RUN, hot)]))
    cases.append((f"a hot key with {HOT_RUN} rows", table,
                  *_lanes(rng, table, [hot] * 300 + [hot - 1, hot + 1] * 50)))
    ext = np.array([I64.min, I64.min, -(1 << 62), -1, 0, 0, 0, 1 << 40, I64.max - 1, I64.max],
                   np.int64)
    cases.append(("int64 extremes", ext, *_lanes(rng, ext, np.resize(ext[::-1], 256))))
    cases.append(("m=0", np.zeros(0, np.int64), *_lanes(rng, np.zeros(0, np.int64))))
    if big:
        for log in (21, 24):
            table = np.sort(rng.integers(-(1 << 40), 1 << 40, 1 << log))
            stride = 1 << index_stride_log(table.size)
            table[stride - 100:stride + 200] = table[stride]  # a run across a leaf boundary
            cases.append((f"m=2^{log} (stride {stride})", table, *_lanes(rng, table)))
    return cases


def _stream(rng, n_build: int, n_probe: int, dom: int, phantoms: int = 0,
            hot: int = 0) -> np.ndarray:
    """A merged ascending int32 stream: builds `key' << 1 | 1` (keys in
    [0, dom), two of them the hot key dom // 2 when `hot`), probes
    `key' << 1` (keys in [0, dom + 4), and `hot` more of the hot key) and
    `phantoms` INT32_MAX entries."""
    bkeys = rng.integers(0, dom, n_build)
    if hot:
        bkeys[:2] = dom // 2
    pkeys = np.concatenate([rng.integers(0, dom + 4, n_probe), np.full(hot, dom // 2)])
    s = np.concatenate([bkeys * 2 + 1, pkeys * 2, np.full(phantoms, I32_MAX)])
    return np.sort(s).astype(np.int32)


def dense_counts_cases(rng, tile: int = DENSE_TILE, big: bool = True) -> list:
    """[(what, s int32[L] merged ascending, m)]: stream lengths at tile·k
    and tile·k ± 1, builds only, probes only, a hot key whose probes span
    many tiles (HOT_PROBES at the kernel's tile, scaled with `tile`),
    phantoms with m at, inside and past the stream's builds, m below the
    builds, L = 1 and L = 0, and with `big` a stream of more tiles than an
    H100's grid holds (each block then reads some tiles twice). `tile`
    shrinks the lengths for the plain version on the CPU."""
    cases = []
    for k in (1, 3):
        for d in (-1, 0, 1):
            L = k * tile + d
            s = _stream(rng, L // 3, L - L // 3, max(L // 2, 2))
            cases.append((f"L={L}", s, L // 3))
    L = 3 * tile + 5
    cases.append(("builds only", _stream(rng, L, 0, 10 * L), L))
    cases.append(("probes only", _stream(rng, 0, L, 50), 100))
    hot = HOT_PROBES * tile // DENSE_TILE
    s = _stream(rng, 1000, hot // 5, 5000, hot=hot)
    cases.append((f"a hot key with {hot} probes", s, 1000))
    s = _stream(rng, 2 * tile, tile, 4 * tile, phantoms=5000 * tile // DENSE_TILE + 3)
    for m in (2 * tile, 2 * tile + 2, 3 * tile):
        cases.append((f"phantoms, m={m}", s, m))
    cases.append(("m below the builds", s, tile // 3))
    cases.append(("L=1, a build", np.array([7], np.int32), 3))
    cases.append(("L=1, a probe", np.array([6], np.int32), 2))
    cases.append(("L=0", np.zeros(0, np.int32), 5))
    if big:
        L = 300 * tile + 7
        cases.append((f"L={L}", _stream(rng, L // 5, L - L // 5, L // 4), L // 5))
    return cases
