"""`exec.bulk.bulk_materialize` of one level over a `SortedTable`, in
FULL mode, against the benchmark's plain reference of query kind
`materialize` (`benchmark/reference/materialize.py`: `searchsorted` ranges
and `repeat_interleave`), row for row as sorted multisets, at small
sizes on seeded random data: config 1's shape (unique keys in a seeded
order, uniform int64 probes, misses past the table), duplicate build
keys, an empty table, probes outside the key range and at the int64
extremes, and a wide table (the generic route). The reference's digest
of the port's rows equals its answer. The JAX package has no part
here: nothing imports it."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.exec import bulk
from ccve_tpu_torch.kernels import pairsort
from ccve_tpu_torch.ops import sort_merge as sm

_PATH = Path(__file__).resolve().parent.parent / "benchmark" / "reference" / "materialize.py"
_SPEC = importlib.util.spec_from_file_location("reference_materialize", _PATH)
reference = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(reference)

I64 = np.iinfo(np.int64)
FIELDS = ["count", "column_sums", "row_hash"]


def _multiset(rows: torch.Tensor) -> list:
    return sorted(map(tuple, rows.tolist()))


def _check(keys: np.ndarray, payloads: np.ndarray, probe: np.ndarray) -> torch.Tensor:
    """The port's rows against the reference's, as multisets and as
    digests; returns the port's rows."""
    table = sm.build_sorted(keys, payloads, device="cpu")
    col = torch.from_numpy(probe.astype(np.int64)).reshape(-1, 1)
    got = bulk.bulk_materialize([table], col, PayloadMode.FULL)
    build = [(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(payloads.astype(np.int64)))]
    want = reference.rows(build, col)
    assert got.dtype == torch.int64 and got.shape == (want.shape[0], 3)
    assert _multiset(got) == _multiset(want)
    digest = reference.digest(got)
    answer = reference.answer(build, col)
    assert {k: v.tolist() for k, v in digest.items()} == {k: v.tolist() for k, v in answer.items()}
    return got


@pytest.fixture(params=[None, 6], ids=["tile 2^13", "tile 2^6"])
def tile_log(request, monkeypatch):
    """The probe sort's tile as the port has it, and shrunk so that a few
    thousand probes take several tiles and merge levels."""
    if request.param is not None:
        monkeypatch.setattr(pairsort, "TILE_LOG", request.param)
    return request.param


@pytest.mark.parametrize("seed", range(3))
def test_config1_shape(seed, tile_log):
    rng = np.random.default_rng(seed)
    m, n = 1000, 6000
    keys = rng.permutation(m).astype(np.int64)
    payloads = np.arange(m, dtype=np.int64) + 10_000_000
    probe = rng.integers(0, m + 1, n, dtype=np.int64)  # key m misses
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert sm.stats_key_type(table) == torch.int32  # the kernel route
    got = _check(keys, payloads, probe)
    assert got.shape[0] == int((probe < m).sum())


@pytest.mark.parametrize("seed", range(3))
def test_duplicate_build_keys(seed, tile_log):
    rng = np.random.default_rng(10 + seed)
    distinct = rng.permutation(400).astype(np.int64) * 3 - 200
    keys = np.concatenate([distinct, distinct[:150], distinct[:60]])  # 1, 2 or 3 a key
    keys = keys[rng.permutation(keys.size)]
    payloads = rng.integers(-(10**9), 10**9, keys.size, dtype=np.int64)
    probe = rng.choice(distinct, 3000) + rng.integers(0, 2, 3000)
    assert sm.build_sorted(keys, payloads, device="cpu").max_mult == 3
    got = _check(keys, payloads, probe)
    assert got.shape[0] > 3000 // 2


def test_empty_table():
    empty = np.zeros(0, np.int64)
    got = _check(empty, empty, np.arange(50, dtype=np.int64))
    assert got.shape == (0, 3)


@pytest.mark.parametrize("seed", range(2))
def test_probes_outside_the_key_range(seed):
    rng = np.random.default_rng(20 + seed)
    keys = rng.permutation(500).astype(np.int64) + 1000
    payloads = rng.integers(0, 10**6, 500, dtype=np.int64)
    probe = np.concatenate([
        rng.integers(-(10**12), 1000, 300),  # below the table
        rng.integers(1500, 10**12, 300),  # above
        np.array([I64.min, I64.max, I64.min + 1, I64.max - 1, 999, 1500, 1000, 1499]),
        rng.integers(1000, 1500, 400),  # in range
    ])
    got = _check(keys, payloads, probe[rng.permutation(probe.size)])
    assert got.shape[0] == 400 + 2


def test_wide_table_takes_the_generic_route():
    rng = np.random.default_rng(30)
    keys = rng.permutation(300).astype(np.int64) * (1 << 32) - (1 << 40)
    payloads = np.arange(300, dtype=np.int64)
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert sm.stats_key_type(table) != torch.int32
    _check(keys, payloads, np.concatenate([rng.choice(keys, 1000), keys[:10] + 1]))
