"""Inputs that hold kernels at the edges of their designs, as numpy
arrays made from a seeded generator: `chunk_rank_cases` for #11
(`kernels.chunk_probe.chunk_rank`, csrc/chunk_rank.cu),
`dense_counts_cases` for #4 (`kernels.merge_scan.merge_scan_build_counts`,
csrc/dense_counts.cu) and `merge_counts_case` for #3 and #14
(`kernels.merge_scan.merge_counts_i32` / `_i64`, csrc/merge_counts.cu).
`chip_smoke.py` and tests/test_torch_cuda.py hold each kernel against its
plain version on them, exactly; the CPU tests hold the plain versions
against numpy, or a model of the kernel against its plain version.
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


MERGE_COUNTS_TILE = 1024  # csrc/merge_counts.cu: kTile, the build rows a block
# #3 and #14's cases, keys in [0, 2^62) or [0, 2^30) before packing: an
# int64 case's keys lie near 2^61, so that packed they come near 2^62
MERGE_COUNTS_KINDS = (
    "unique", "repeated", "key across a tile boundary", "a tile of one key",
    "one key holds most probes", "n_real inside a run", "runs past n_real", "runs of 2^11",
    "a single run", "m > n", "m = 1", "n = 0", "extremes",
)
_KEY_BASE = {np.dtype(np.int32): 0, np.dtype(np.int64): 2**61 - 10**6}


def probe_runs(probes: np.ndarray, run_log: int, dtype) -> np.ndarray:
    """Packed probes (`key' << 1`) padded with the key type's maximum to a
    multiple of 2^11, as the count side pads them, and sorted into runs of
    2^run_log (the last one possibly shorter)."""
    n_pad = probes.size + (-probes.size) % 2048
    pad = np.full(n_pad - probes.size, np.iinfo(dtype).max, np.int64)
    p = np.concatenate([probes.astype(np.int64), pad]).astype(dtype)
    step = 1 << run_log
    return np.concatenate([np.sort(p[lo:lo + step]) for lo in range(0, n_pad, step)] or [p])


def _merge_counts_keys(rng, kind: str, tile: int):
    """(probe keys, build keys, run_log, n_real or None) of a case."""
    if kind == "unique":
        return rng.integers(0, 5000, 60_000), rng.choice(5000, 3000, replace=False), 13, None
    if kind == "repeated":
        return rng.integers(0, 3000, 40_000), rng.integers(0, 3000, 7000), 12, None
    if kind == "key across a tile boundary":
        # the key of rows tile - 50 .. tile + 50 straddles the first two tiles
        builds = np.concatenate([np.arange(tile - 50), np.full(100, tile),
                                 tile + 1 + np.arange(500)])
        probes = rng.integers(0, builds.max() + 2, 30_000)
        probes[:4000] = tile
        return probes, builds, 12, None
    if kind == "a tile of one key":
        # two whole tiles of key 100, which holds 70 % of the probes: its
        # slice in each run is longer than the stage
        builds = np.concatenate([rng.integers(0, 100, 300), np.full(2 * tile + 7, 100),
                                 100 + rng.integers(1, 400, 300)])
        probes = rng.integers(0, 500, 50_000)
        probes[rng.random(50_000) < 0.7] = 100
        return probes, builds, 13, None
    if kind == "one key holds most probes":
        probes = rng.integers(0, 3000, 80_000)
        probes[rng.random(80_000) < 0.8] = 1234
        return probes, np.union1d(rng.choice(3000, 2500, replace=False), [1234]), 14, None
    if kind == "n_real inside a run":
        return rng.integers(0, 800, 9000), rng.integers(0, 800, 500), 11, 5000
    if kind == "runs past n_real":
        return rng.integers(0, 800, 20_000), rng.integers(0, 800, 500), 11, 3000
    if kind == "runs of 2^11":
        return rng.integers(0, 600, 2**19 - 100), rng.integers(0, 600, 400), 11, None
    if kind == "a single run":
        return rng.integers(0, 4000, 30_000), rng.integers(0, 4000, 2000), 15, None
    if kind == "m > n":
        return rng.integers(0, 20_000, 3000), rng.integers(0, 20_000, 9000), 11, None
    if kind == "m = 1":
        return rng.integers(0, 3, 5000), np.array([1]), 11, None
    if kind == "n = 0":
        return np.zeros(0, np.int64), np.arange(50), 11, None
    raise ValueError(f"unknown merge counts case {kind!r}")


def merge_counts_case(rng, dtype, kind: str, tile: int = MERGE_COUNTS_TILE) -> tuple:
    """(runs, run_len, n_real, b) of one of MERGE_COUNTS_KINDS for the key
    type `dtype`: the probe runs as `probe_runs` leaves them and the packed
    ascending build stream (`key' << 1 | 1`). `tile` places the cases that
    straddle or fill tiles. "extremes": builds at the top of the key range
    (the last packed build is the type's maximum, as the padding is),
    probes on it and clamped to the bottom (0)."""
    dtype = np.dtype(dtype)
    if kind == "extremes":
        top = np.iinfo(dtype).max // 2  # the largest key'
        probes = rng.integers(top - 600, top + 1, 8000)
        probes[:300] = 0
        probes[300:900] = top
        builds = np.concatenate([rng.integers(top - 600, top + 1, 400), [top, top]])
        return (probe_runs(probes * 2, 11, dtype), 2048, probes.size,
                (np.sort(builds) * 2 + 1).astype(dtype))
    probes, builds, run_log, n_real = _merge_counts_keys(rng, kind, tile)
    base = _KEY_BASE[dtype]
    return (probe_runs((base + probes) * 2, run_log, dtype), 1 << run_log,
            probes.size if n_real is None else n_real,
            ((base + np.sort(builds)) * 2 + 1).astype(dtype))
