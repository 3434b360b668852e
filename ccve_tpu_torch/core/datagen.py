"""Deterministic workload generators, bit-exact with `ccve_tpu.core.datagen`.

 - Probe table: `std::mt19937 gen(2)` feeding libstdc++'s
   `uniform_int_distribution<int>(0, rhs_size)`, drawn row-major.
 - Build (RHS) table: `ceil(n_rhs / chunk_factor)` distinct keys
   `i * (n_rhs // num_unique)`, each repeated `chunk_factor` times, with
   payload = row index + 10_000_000.
 - Zipf keys (config 4): `np.random.default_rng(seed)`'s draws in the JAX
   package's order, `random(n)` then `permutation(domain)`.
 - The micro-benchmark's keys: glibc `rand()`.

NumPy only: the JAX package's ctypes generator is not carried over (the
NumPy MT19937 draws the 16M-row config-1 probe table in a few seconds),
and importing `ccve_tpu` would import JAX.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


def _mix(hi_src: np.ndarray, lo_src: np.ndarray) -> np.ndarray:
    """MT19937's twist of one word: top bit of `hi_src`, low 31 of `lo_src`."""
    y = (hi_src & _UPPER) | (lo_src & _LOWER)
    return (y >> np.uint32(1)) ^ np.where(y & np.uint32(1), _MATRIX_A, np.uint32(0))


class MT19937:
    """`std::mt19937` (32-bit outputs), one 624-word block at a time."""

    def __init__(self, seed: int):
        state = np.empty(_N, dtype=np.uint32)
        word = seed & 0xFFFFFFFF
        state[0] = word
        for i in range(1, _N):
            word = (1812433253 * (word ^ (word >> 30)) + i) & 0xFFFFFFFF
            state[i] = word
        self._state = state
        self._pos = _N  # the first draw twists

    def _twist(self) -> None:
        # mt[i] = mt[(i + M) % N] ^ mix(mt[i], mt[i + 1]), updated in place in
        # index order: for i >= N - M the (i + M) % N word is already new, and
        # the last word mixes in the new mt[0]. Vectorised in strides of N - M.
        old = self._state
        new = np.empty_like(old)
        k = _N - _M
        new[:k] = old[_M:] ^ _mix(old[:k], old[1 : k + 1])
        for start in range(k, _N - 1, k):
            stop = min(start + k, _N - 1)
            new[start:stop] = new[start - k : stop - k] ^ _mix(
                old[start:stop], old[start + 1 : stop + 1]
            )
        new[_N - 1] = new[_M - 1] ^ _mix(old[_N - 1 :], new[:1])[0]
        self._state = new
        self._pos = 0

    def draw(self, n: int) -> np.ndarray:
        """The next n tempered outputs as uint32[n]."""
        out = np.empty(n, dtype=np.uint32)
        done = 0
        while done < n:
            if self._pos == _N:
                self._twist()
            take = min(n - done, _N - self._pos)
            y = self._state[self._pos : self._pos + take].copy()
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[done : done + take] = y
            self._pos += take
            done += take
        return out


def uniform_int_stream(gen: MT19937, n: int, lo: int, hi: int) -> np.ndarray:
    """n draws of libstdc++'s `uniform_int_distribution<int>(lo, hi)` fed by
    a 32-bit generator: Lemire's nearly-divisionless method, which keeps
    `(g() * range) >> 32` when the low word is at least
    `(2^32 - range) % range` and draws again otherwise."""
    span = hi - lo
    if not 0 <= span < 0xFFFFFFFF:
        raise ValueError(f"bad range [{lo}, {hi}]")
    rng = np.uint64(span + 1)
    threshold = np.uint64(((1 << 32) - (span + 1)) % (span + 1))
    out = np.empty(n, dtype=np.int64)
    done = 0
    while done < n:
        need = n - done
        product = gen.draw(need + need // 100 + 64).astype(np.uint64) * rng
        kept = (product >> np.uint64(32))[
            (product & np.uint64(0xFFFFFFFF)) >= threshold
        ]
        take = min(need, kept.shape[0])
        out[done : done + take] = kept[:take].astype(np.int64) + lo
        done += take
    return out


def gen_probe_table(n_rows: int, n_cols: int, rhs_size: int) -> np.ndarray:
    """The probe table: int64[n_rows, n_cols] of uniform draws in
    [0, rhs_size] from mt19937(2), row-major."""
    flat = uniform_int_stream(MT19937(2), n_rows * n_cols, 0, rhs_size)
    return flat.reshape(n_rows, n_cols)


def gen_rhs_table(n_rhs: int, chunk_factor: int) -> tuple[np.ndarray, np.ndarray]:
    """Build-side (keys int64[n_rhs], payloads int64[n_rhs]) in insertion
    order."""
    num_unique = -(-n_rhs // chunk_factor)
    stride = n_rhs // num_unique if num_unique else 0
    keys = (np.arange(n_rhs, dtype=np.int64) // chunk_factor) * stride
    payloads = np.arange(n_rhs, dtype=np.int64) + 10_000_000
    return keys, payloads


def gen_zipf_keys(n: int, domain: int, alpha: float = 1.1, seed: int = 7) -> np.ndarray:
    """Zipf-skewed int64[n] keys in [0, domain): config 4's heavy hitters.
    A rank r is drawn with probability proportional to 1 / r^alpha by
    inverse-CDF sampling of `default_rng(seed).random(n)`, then the ranks
    go through one `permutation(domain)` of the same generator, so that
    hot keys do not cluster in key space."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(np.arange(1, domain + 1, dtype=np.float64) ** -alpha)
    cdf /= cdf[-1]
    u = rng.random(n)
    r = np.searchsorted(cdf, u)  # 0-based rank
    perm = rng.permutation(domain)
    return perm[r].astype(np.int64)


# ---------------------------------------------------------------------------
# glibc rand() (TYPE_3 additive feedback): the micro-benchmark's key stream
# ---------------------------------------------------------------------------

_GLIBC_BLOCK = 1024  # outputs drawn a matrix product at a time


def _glibc_coefficients(n: int) -> np.ndarray:
    """uint64[n, 31]: output j after a state of 31 words as a linear
    combination of them, wrapping mod 2^64 (so exact mod 2^32):
    r[i] = r[i - 31] + r[i - 3]."""
    c = np.zeros((31 + n, 31), dtype=np.uint64)
    c[:31] = np.eye(31, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i in range(31, 31 + n):
            c[i] = c[i - 31] + c[i - 3]
    return c[31:]


class GlibcRand:
    """glibc `rand()` after `srand(seed)` (default seed 1): the 31-word
    additive feedback generator r[i] = r[i - 31] + r[i - 3] (mod 2^32),
    output r[i] >> 1, after glibc's 310 discarded outputs. Bit-exact with
    the JAX package's `GlibcRand`, whose numpy path steps one output at a
    time in Python; here each block of outputs is one matrix product of
    the recurrence's coefficients with the last 31 words."""

    def __init__(self, seed: int = 1):
        r = [seed]
        word = seed
        for _ in range(1, 31):
            # word = (16807 * word) % 2147483647 by Schrage, as glibc does
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r.append(word)
        buf = [w & 0xFFFFFFFF for w in r] + [w & 0xFFFFFFFF for w in r[:3]]
        for i in range(34, 344):
            buf.append((buf[i - 31] + buf[i - 3]) & 0xFFFFFFFF)
        self._state = np.asarray(buf[-31:], dtype=np.uint64)  # the last 31 words
        self._coef = _glibc_coefficients(_GLIBC_BLOCK)

    def draw(self, n: int) -> np.ndarray:
        """The next n outputs as int64[n] (values in [0, 2^31))."""
        out = np.empty(n, dtype=np.int64)
        mask = np.uint64(0xFFFFFFFF)
        with np.errstate(over="ignore"):
            for start in range(0, n, _GLIBC_BLOCK):
                words = (self._coef @ self._state) & mask
                take = min(_GLIBC_BLOCK, n - start)
                out[start : start + take] = (words[:take] >> np.uint64(1)).astype(np.int64)
                # the stream goes on from the last 31 words actually drawn
                self._state = np.concatenate([self._state, words[:take]])[-31:]
        return out


def gen_microbench_keys(n_keys: int, rhs_tuples: int, hit_freq: int) -> np.ndarray:
    """The micro-benchmark's probe keys (simd_micro_bench.cpp:78-79):
    rand() & (rhs_tuples * hit_freq - 1), glibc rand with its default
    seed."""
    return GlibcRand(1).draw(n_keys) & (rhs_tuples * hit_freq - 1)
