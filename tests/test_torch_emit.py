"""The emission of a sorted join level (`kernels.emit`), on the CPU: its
plain version against the formulation `bulk_materialize` had before it
(the survivors' probe row ids `src` and their appended columns gathered
level by level, the probe rows gathered at the end), written here, as
multisets of rows; the wrapper's checks; and `bulk_materialize` over
mixed levels (sorted int32, LP, CSR, wide int64) against the numpy
oracle, with the emission taken on every sorted int32 level and no
other. Tolerance 0: every value is an integer. The card's kernel is held
against the plain version in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.exec import bulk, oracle
from ccve_tpu_torch.kernels import emit
from ccve_tpu_torch.ops import sort_merge as sm
from ccve_tpu_torch.ops.hash_table import build_csr, build_lp

I64_MIN = -(2**63)
# the smallest key of each sorted table: small, and near -2^62 and +2^62
BASES = {"small": 0, "low": -(2**62) + 12_345, "high": 2**62 - 10**6}


def _old_materialize(tables, probe: torch.Tensor, full: bool) -> torch.Tensor:
    """`bulk_materialize` over sorted tables as it was before the emission
    kernel: `sorted_expand` at full capacity, then the survivors' `src`
    and `appended` gathered, the new columns stacked and concatenated."""
    n = probe.shape[0]
    src = torch.arange(n)
    appended = torch.zeros((0, n), dtype=torch.int64)
    for level, table in enumerate(tables):
        keys = probe[src, level]
        rows, ck, cp, total = sm.sorted_expand(table, keys, keys.numel() * table.max_mult)
        n_keep = int(total)
        row_of = rows[:n_keep].to(torch.int64)
        ck, cp = ck[:n_keep], cp[:n_keep]
        src, appended = src[row_of], appended[:, row_of]
        new = torch.stack([ck, cp]) if full else torch.stack([torch.zeros_like(ck), ck])
        appended = torch.cat([appended, new])
    return torch.cat([probe[src], appended.T], dim=1)


def _rows(out) -> list:
    return sorted(map(tuple, torch.as_tensor(out).tolist()))


def _sorted_table(rng, base: int, n_keys: int, fan_out: int):
    """A sorted table of n_keys keys from `base` up, in a seeded order,
    each repeated `fan_out` times, with payloads of both signs."""
    keys = np.repeat(base + rng.permutation(n_keys).astype(np.int64) * 3, fan_out)
    pays = rng.integers(-(2**31), 2**31 - 1, keys.size)
    return keys, pays


def _probe_col(rng, keys: np.ndarray, n: int) -> np.ndarray:
    """Probes of the table's keys, misses between them and beyond both
    ends (clamped by the narrowing)."""
    hit = rng.choice(keys, n) + rng.integers(0, 2, n)
    lo, hi = int(keys.min()), int(keys.max())
    ends = np.array([lo - 1, hi + 1, max(lo - 2**40, I64_MIN), min(hi + 2**40, 2**63 - 1)])
    return np.concatenate([hit, ends])


@pytest.mark.parametrize("full", [True, False], ids=["full", "reference"])
@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("fan_out", [1, 4])
@pytest.mark.parametrize("width", [1, 2, 3])
def test_emission_equals_the_gathers_and_concatenations(width, fan_out, base, full):
    """W probe columns over W sorted int32 tables: level l's state is W +
    2l wide, so the first level reads W = 1, 2, 3."""
    rng = np.random.default_rng(width * 10 + fan_out)
    built = [_sorted_table(rng, BASES[base], 300, fan_out) for _ in range(width)]
    tables = [sm.build_sorted(k, p, device="cpu") for k, p in built]
    assert all(sm.stats_key_type(t) == torch.int32 and t.max_mult == fan_out for t in tables)
    n = 200 if width == 3 else 700
    probe = torch.from_numpy(np.stack([_probe_col(rng, k, n) for k, _ in built], axis=1))
    mode = PayloadMode.FULL if full else PayloadMode.REFERENCE
    got = bulk.bulk_materialize(tables, probe, mode)
    want = _old_materialize(tables, probe, full)
    assert got.dtype == torch.int64 and got.shape == want.shape == (want.shape[0], 3 * width)
    assert want.shape[0] > 0
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reference"])
@pytest.mark.parametrize("width, level", [(1, 0), (3, 0), (3, 2)])
def test_one_level_from_the_compacted_planes(width, level, full):
    """`emit_rows_i32` on `expand_compacted`'s planes of one level: the old
    level step's rows; slots past n_keep, whatever they hold, are not
    read; no match gives no row."""
    rng = np.random.default_rng(5)
    keys, pays = _sorted_table(rng, BASES["low"], 400, 2)
    table = sm.build_sorted(keys, pays, device="cpu")
    kmin = table.pack32[0]
    state = torch.from_numpy(rng.integers(-(2**62), 2**62, (900, width)))
    state[:, level] = torch.from_numpy(_probe_col(rng, keys, 896))
    planes, total = sm.expand_compacted(table, state[:, level])
    n_keep = int(total)
    assert 0 < n_keep < planes.shape[1]
    got = emit.emit_rows_i32(planes, n_keep, kmin, state, level, full)
    rows, ck, cp, _ = sm.sorted_expand(table, state[:, level], planes.shape[1])
    row_of = rows[:n_keep].to(torch.int64)
    new = [ck[:n_keep], cp[:n_keep]] if full else [torch.zeros(n_keep, dtype=torch.int64),
                                                     ck[:n_keep]]
    want = torch.cat([state[row_of], torch.stack(new, dim=1)], dim=1)
    assert got.shape == (n_keep, width + 2) and _rows(got) == _rows(want)
    noisy = torch.cat([planes[:, :n_keep],
                       torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (3, 77), dtype=np.int32))],
                      dim=1).contiguous()
    assert torch.equal(emit.emit_rows_i32(noisy, n_keep, kmin, state, level, full), got)
    none = emit.emit_rows_i32(planes, 0, kmin, state, level, full)
    assert none.shape == (0, width + 2) and none.dtype == torch.int64
    misses = state[:5].clone()
    misses[:, level] = int(keys.max()) + 1
    planes0, total0 = sm.expand_compacted(table, misses[:, level])
    assert int(total0) == 0
    assert emit.emit_rows_i32(planes0, 0, kmin, misses, level, full).shape == (0, width + 2)


def test_the_key_offset_at_the_int64_ends():
    """key = key' - 1 + kmin is exact with kmin at INT64_MIN, where kmin - 1
    is no int64, and at the top of the range."""
    for kmin, key_prime in ((I64_MIN, [1, 2, 2**29]), (2**63 - 2**29, [1, 2**29 - 1])):
        kp = torch.tensor(key_prime, dtype=torch.int32)
        planes = torch.stack([torch.zeros_like(kp), kp, -kp]).contiguous()
        state = torch.zeros((1, 1), dtype=torch.int64)
        got = emit.emit_rows_i32(planes, kp.numel(), kmin, state, 0, True)
        want = [[kmin + k - 1, kmin + k - 1, -k] for k in key_prime]
        assert got.tolist() == want


def test_the_wrapper_refuses_what_the_kernel_cannot_take():
    planes = torch.zeros((3, 8), dtype=torch.int32)
    state = torch.zeros((8, 2), dtype=torch.int64)
    with pytest.raises(TypeError, match="planes"):
        emit.emit_rows_i32(planes.to(torch.int64), 1, 0, state, 0, True)
    with pytest.raises(ValueError, match="planes"):
        emit.emit_rows_i32(planes[:2], 1, 0, state, 0, True)
    with pytest.raises(TypeError, match="state"):
        emit.emit_rows_i32(planes, 1, 0, state.to(torch.int32), 0, True)
    with pytest.raises(ValueError, match="state"):
        emit.emit_rows_i32(planes, 1, 0, state.T, 0, True)
    with pytest.raises(ValueError, match="n_keep"):
        emit.emit_rows_i32(planes, 9, 0, state, 0, True)
    with pytest.raises(ValueError, match="level"):
        emit.emit_rows_i32(planes, 1, 0, state, 2, True)
    with pytest.raises(ValueError, match="kmin"):
        emit.emit_rows_i32(planes, 1, 2**63, state, 0, True)


def _level(rng, kind: str, n: int):
    """(table, probe column, host keys, host payloads) of one level: keys
    with duplicates; `wide` spreads them over 2^50, past the int32 route."""
    keys = np.repeat(rng.permutation(120).astype(np.int64) * 5, rng.integers(1, 4, 120))
    if kind == "wide":
        keys = keys * 2**40 - 2**49
    pays = rng.integers(-(2**31), 2**31 - 1, keys.size)
    build = {"sorted": sm.build_sorted, "wide": sm.build_sorted, "lp": build_lp,
             "csr": build_csr}[kind]
    col = rng.choice(keys, n) + rng.integers(0, 2, n) * (2**40 if kind == "wide" else 1)
    return build(keys, pays, device="cpu"), col, keys, pays


@pytest.mark.parametrize("mode", list(PayloadMode))
@pytest.mark.parametrize("kinds", [("sorted", "lp", "csr", "wide"), ("wide", "sorted", "sorted"),
                                   ("csr", "sorted"), ("lp", "wide")])
def test_bulk_materialize_over_mixed_levels_matches_the_oracle(monkeypatch, kinds, mode):
    rng = np.random.default_rng(len(kinds))
    levels = [_level(rng, kind, 250) for kind in kinds]
    route = {"sorted": torch.int32, "wide": torch.int64}
    assert all(sm.stats_key_type(t) == route[kind] for (t, *_), kind in zip(levels, kinds)
               if kind in route)
    probe = np.stack([col for _, col, _, _ in levels], axis=1)
    calls = []
    real = bulk.emit_rows_i32

    def spy(planes, n_keep, kmin, state, level, full):
        calls.append(level)
        return real(planes, n_keep, kmin, state, level, full)

    monkeypatch.setattr(bulk, "emit_rows_i32", spy)
    got = bulk.bulk_materialize([t for t, *_ in levels], probe, mode)
    want = oracle.oracle_pipeline(
        probe, [oracle.OracleBuildTable(k, p) for _, _, k, p in levels], mode)
    assert got.dtype == torch.int64 and got.shape == want.shape and want.shape[0] > 0
    oracle.assert_same_multiset(got.numpy(), want)
    assert calls == [level for level, kind in enumerate(kinds) if kind == "sorted"]
