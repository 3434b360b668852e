"""Scalar reference executor — the correctness oracle.

Carried unchanged from `ccve_tpu.exec.oracle` (numpy only), so that the
port checks itself where JAX is not installed; the tests hold the two
copies against each other.

The reference repo has no tests (SURVEY.md §4); its correctness story is
determinism plus eyeballing matched-tuple counts. This module supplies the
oracle the reference never had: a vectorized-NumPy (but semantically scalar)
executor for the N-way equi-join pipeline, defining the observable output
multiset that every device path (XLA, Pallas, distributed) must reproduce
bit-exactly modulo row order.

Observable semantics (from the reference's executor, main.cpp:119-170):

 - The probe table has `n_joins` int64 key columns; join level `l` probes
   column `l` against its own build (RHS) table.
 - Each level appends TWO output columns to the row (main.cpp:63-66 grows
   `types` by 2 per join):
     * REFERENCE payload mode: (0, matched_key). The reference stores only
       keys in its hash tables (chaining_ht.cpp:34, linear_probing_ht.cpp:35)
       and gathers the matched key as the "payload" (chaining_ht.cpp:132);
       the first of the two columns is never written and stays 0 (only
       cols[1] is assigned, chaining_ht.cpp:60-80,126-136).
     * FULL payload mode (our extension): (matched_key, payload) with
       payload = build_row_index + 10_000_000 (chaining_ht.cpp:21).
 - A probe key matching k duplicate build keys emits k rows (the
   `while (ss.HasNext())` drain, main.cpp:150-161); with no match the row is
   dropped. Final result width = n_joins + 2*n_joins columns.

Row order is NOT part of the contract (BASELINE.json: "bit-identical join
results modulo row order"); comparisons go through `sort_rows`.
"""

from __future__ import annotations

import numpy as np

from ccve_tpu_torch.config import PayloadMode

PAYLOAD_BASE = 10_000_000


class OracleBuildTable:
    """Host-side build table indexed for O(log n) probe: keys sorted with
    duplicate runs, original insertion positions kept for payloads."""

    def __init__(self, keys: np.ndarray, payloads: np.ndarray | None = None):
        keys = np.asarray(keys, dtype=np.int64)
        if payloads is None:
            payloads = np.arange(keys.shape[0], dtype=np.int64) + PAYLOAD_BASE
        self.keys = keys
        self.payloads = np.asarray(payloads, dtype=np.int64)
        self.order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[self.order]
        self.sorted_payloads = self.payloads[self.order]


def oracle_join(
    probe_rows: np.ndarray,
    key_col: int,
    build: OracleBuildTable,
    payload_mode: PayloadMode = PayloadMode.REFERENCE,
) -> np.ndarray:
    """One equi-join level: expand `probe_rows` (int64[n, w]) against `build`
    on column `key_col`, appending 2 columns. Returns int64[m, w+2]."""
    probe_rows = np.asarray(probe_rows, dtype=np.int64)
    keys = probe_rows[:, key_col]
    lo = np.searchsorted(build.sorted_keys, keys, side="left")
    hi = np.searchsorted(build.sorted_keys, keys, side="right")
    mult = hi - lo  # matches per probe row

    # Expand probe rows by multiplicity.
    row_ids = np.repeat(np.arange(probe_rows.shape[0]), mult)
    out_lhs = probe_rows[row_ids]

    # For the j-th duplicate of row i, the matched build position is
    # order[lo[i] + j].
    total = int(mult.sum())
    starts = np.repeat(lo, mult)
    offs = np.arange(total) - np.repeat(np.cumsum(mult) - mult, mult)
    pos = starts + offs
    matched_keys = build.sorted_keys[pos]

    if payload_mode is PayloadMode.REFERENCE:
        col_a = np.zeros(total, dtype=np.int64)
        col_b = matched_keys
    else:
        col_a = matched_keys
        col_b = build.sorted_payloads[pos]
    return np.column_stack([out_lhs, col_a, col_b]) if total else np.zeros(
        (0, probe_rows.shape[1] + 2), dtype=np.int64
    )


def oracle_pipeline(
    probe_table: np.ndarray,
    builds: list[OracleBuildTable],
    payload_mode: PayloadMode = PayloadMode.REFERENCE,
) -> np.ndarray:
    """The full N-way join pipeline (main.cpp:119-170): probe column l joins
    builds[l]; result width = n_joins + 2*n_joins."""
    rows = np.asarray(probe_table, dtype=np.int64)
    n_joins = len(builds)
    assert rows.shape[1] == n_joins
    for level, build in enumerate(builds):
        rows = oracle_join(rows, level, build, payload_mode)
    return rows


def sort_rows(rows: np.ndarray) -> np.ndarray:
    """Canonical row order for multiset comparison."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return rows.reshape(0, rows.shape[1] if rows.ndim == 2 else 0)
    return rows[np.lexsort(rows.T[::-1])]


def assert_same_multiset(actual: np.ndarray, expected: np.ndarray) -> None:
    a, e = sort_rows(actual), sort_rows(expected)
    if a.shape != e.shape:
        raise AssertionError(f"row-count mismatch: {a.shape} vs {e.shape}")
    if not np.array_equal(a, e):
        bad = np.nonzero(~(a == e).all(axis=1))[0]
        i = int(bad[0])
        raise AssertionError(
            f"{bad.size} mismatching rows; first at {i}: {a[i]} vs {e[i]}"
        )
