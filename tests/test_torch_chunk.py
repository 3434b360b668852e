"""The port's chunk data model, compactor and filter (`core.chunk`,
`ops.compactor`, `ops.filter`) against the JAX package's on the same
inputs; twins of tests/test_chunk.py and tests/test_compactor.py. Exact:
the columns are integers. Only live rows are compared where the JAX
function leaves storage past the count as it finds it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.core import chunk as JC
from ccve_tpu.ops import compactor as JComp
from ccve_tpu.ops import filter as JF
from ccve_tpu_torch.core import chunk as C
from ccve_tpu_torch.ops import compactor as comp
from ccve_tpu_torch.ops import filter as F

BLOCK = 128


def _pair(rows, block, count=None):
    """The same chunk in both packages, from host rows."""
    j, t = JC.from_rows(rows, block), C.from_rows(rows, block, device="cpu")
    if count is not None:
        j = JC.Chunk(j.cols, j.sel, jnp.asarray(count, jnp.int32))
        t = C.Chunk(t.cols, t.sel, count)
    return j, t


def _same_chunk(t, j):
    assert t.count == int(j.count)
    np.testing.assert_array_equal(C.to_rows(t), JC.to_rows(j))


def test_from_rows_roundtrip_and_reset():
    rows = np.array([[1, 10], [2, 20], [3, 30]])
    j, t = _pair(rows, 8)
    _same_chunk(t, j)
    assert (t.n_cols, t.block_size) == (2, 8)
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    r = C.reset(t)
    assert r.count == 0 and torch.equal(r.sel, torch.arange(8, dtype=torch.int32))
    e = C.empty(3, 8, device="cpu")
    assert e.count == 0 and e.cols.shape == (3, 8) and not e.cols.any()
    d = C.make_dense(torch.ones((2, 8), dtype=torch.int32))
    assert d.count == 8 and d.cols.dtype == torch.int64
    np.testing.assert_array_equal(C.valid_mask(t).numpy(), np.asarray(JC.valid_mask(j)))


@pytest.mark.parametrize("seed", range(3))
def test_slice_compose_and_gather_rows(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-50, 50, (13, 3))
    j, t = _pair(rows, 16)
    for step in range(2):  # a slice of a slice
        keep = rng.random(16) < 0.6
        rv_j, cnt_j = JC.compress_indices(jnp.asarray(keep) & JC.valid_mask(j))
        rv_t, cnt_t = C.compress_indices(torch.from_numpy(keep) & C.valid_mask(t))
        assert cnt_t == int(cnt_j)
        np.testing.assert_array_equal(rv_t.numpy()[:cnt_t], np.asarray(rv_j)[:cnt_t])
        j = JC.slice_compose(j, rv_j, cnt_j)
        t = C.slice_compose(t, rv_t, cnt_t)
        _same_chunk(t, j)
        np.testing.assert_array_equal(C.gather_rows(t).numpy(), np.asarray(JC.gather_rows(j)))


@pytest.mark.parametrize("fill", [0.0, 0.3, 1.0])
def test_compact_rows(fill):
    rng = np.random.default_rng(int(fill * 10))
    cols = rng.integers(-(2**40), 2**40, (3, BLOCK))
    mask = rng.random(BLOCK) < fill
    want, want_count = JC.compact_rows(jnp.asarray(cols), jnp.asarray(mask))
    got, count = C.compact_rows(torch.from_numpy(cols), torch.from_numpy(mask))
    assert count == int(want_count) == int(mask.sum())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # zero past the count


@pytest.mark.parametrize(
    "dst_count, src_count, limit, dense",
    [(2, 3, None, False), (6, 5, None, False), (0, 8, None, True), (5, 3, 2, False),
     (7, 1, None, True), (3, 0, None, False)],
)
def test_append_into(dst_count, src_count, limit, dense):
    rng = np.random.default_rng(dst_count * 10 + src_count)
    dst = rng.integers(0, 99, (2, 8))
    rows = rng.integers(100, 199, (8, 2))
    j, t = _pair(rows, 8, count=src_count)
    if not dense:  # read through a shuffled selection vector
        sel = rng.permutation(8).astype(np.int32)
        j = JC.Chunk(j.cols, jnp.asarray(sel), j.count)
        t = C.Chunk(t.cols, torch.from_numpy(sel), t.count)
    want = JC.append_into(jnp.asarray(dst), jnp.int32(dst_count), j, limit=limit, src_dense=dense)
    dst_t = torch.from_numpy(dst)
    got = C.append_into(dst_t, dst_count, t, limit=limit, src_dense=dense)
    assert (got[1], got[3]) == (int(want[1]), int(want[3]))
    np.testing.assert_array_equal(got[0].numpy()[:, : got[1]], np.asarray(want[0])[:, : got[1]])
    np.testing.assert_array_equal(got[2].numpy()[:, : got[3]], np.asarray(want[2])[:, : got[3]])
    assert torch.equal(dst_t, torch.from_numpy(dst))  # the input is not written


def _compact_both(states, chunk_pair, threshold):
    (js, ts), (jc, tc) = states, chunk_pair
    je, js = JComp.compact(js, jc, jnp.asarray(threshold))
    te, ts = comp.compact(ts, tc, threshold)
    _same_chunk(te, je)
    assert ts.cache_count == int(js.cache_count)
    live = ts.cache_count
    np.testing.assert_array_equal(ts.cache_cols.numpy()[:, :live],
                                  np.asarray(js.cache_cols)[:, :live])
    return (js, ts), te


# (threshold, chunk sizes): pass-through, absorb, an exact fill, overflow
COMPACTOR_CASES = {
    "none": (0, [3, 50, 0, 128]),
    "binary": (BLOCK // 2, [70, 10, 100, 30, 64, 63, 1]),
    "full_exact_fill": (BLOCK, [100, 28, 128, 5]),
    "full_overflow": (BLOCK, [100, 100, 50, 127, 1, 90]),
    "full_small": (BLOCK, [50] * 5),
}


@pytest.mark.parametrize("case", sorted(COMPACTOR_CASES))
def test_compactor_matches_jax(case):
    threshold, sizes = COMPACTOR_CASES[case]
    states = (JComp.init_state(2, BLOCK), comp.init_state(2, BLOCK, device="cpu"))
    emitted, base = [], 0
    for size in sizes:
        rows = np.stack([np.arange(base, base + size), -np.arange(base, base + size)], axis=1)
        base += size
        states, te = _compact_both(states, _pair(rows, BLOCK), threshold)
        emitted.append(C.to_rows(te))
    jf, _ = JComp.flush(states[0])
    tf, fresh = comp.flush(states[1])
    _same_chunk(tf, jf)
    assert fresh.cache_count == 0 and not fresh.cache_cols.any()
    got = np.concatenate(emitted + [C.to_rows(tf)])
    np.testing.assert_array_equal(np.sort(got[:, 0]), np.arange(base))  # nothing lost


def test_compactor_does_not_alias_emitted_chunks():
    """An emitted chunk keeps its rows while the compactor goes on."""
    state = comp.init_state(1, BLOCK, device="cpu")
    e1, state = comp.compact(state, C.from_rows(np.arange(100).reshape(-1, 1), BLOCK, device="cpu"), BLOCK)
    e2, state = comp.compact(state, C.from_rows(np.arange(100, 200).reshape(-1, 1), BLOCK, device="cpu"), BLOCK)
    kept = C.to_rows(e2).copy()
    e3, state = comp.compact(state, C.from_rows(np.arange(200, 300).reshape(-1, 1), BLOCK, device="cpu"), BLOCK)
    np.testing.assert_array_equal(C.to_rows(e2), kept)
    assert (e1.count, e2.count, e3.count, state.cache_count) == (0, BLOCK, BLOCK, 44)


def test_compactor_reads_through_selection_vector():
    state = comp.init_state(1, BLOCK, device="cpu")
    base = C.from_rows(np.arange(BLOCK).reshape(-1, 1), BLOCK, device="cpu")
    sel = torch.zeros(BLOCK, dtype=torch.int32)
    sel[:3] = torch.tensor([5, 9, 33])
    e, state = comp.compact(state, C.Chunk(base.cols, sel, 3), BLOCK)
    assert e.count == 0
    np.testing.assert_array_equal(C.to_rows(comp.flush(state)[0])[:, 0], [5, 9, 33])


PREDICATES = [("lt", (40,)), ("le", (40,)), ("gt", (-3,)), ("ge", (7,)), ("eq", (12,)),
              ("between", (-20, 30)), ("mod_eq", (3, 1))]


@pytest.mark.parametrize("name, args", PREDICATES)
def test_filter_matches_jax(name, args):
    rng = np.random.default_rng(len(name))
    rows = rng.integers(-60, 60, (100, 2))
    j, t = _pair(rows, BLOCK)
    j = JF.filter_chunk(j, getattr(JF, name)(*args), col=1)
    t = F.filter_chunk(t, getattr(F, name)(*args), col=1)
    _same_chunk(t, j)
    # a filter of the filtered chunk composes selection vectors again
    j = JF.filter_chunk(j, JF.gt(-40), col=0)
    t = F.filter_chunk(t, F.gt(-40), col=0)
    _same_chunk(t, j)
    values = rng.integers(-99, 99, 64)
    np.testing.assert_array_equal(
        F.filter_mask(torch.from_numpy(values), getattr(F, name)(*args)).numpy(),
        np.asarray(JF.filter_mask(jnp.asarray(values), getattr(JF, name)(*args))))


def _constructors():
    from ccve_tpu_torch.control import device_bandit as db
    from ccve_tpu_torch.exec.pipeline import init_pipeline_state

    return {
        "init_pipeline_state": lambda: init_pipeline_state(2, 2, 8, 16),
        "compactor.init_state": lambda: comp.init_state(2, 8),
        "device_bandit.init_state": lambda: db.init_state(2, 3),
        "iota_sel": lambda: C.iota_sel(8),
        "empty": lambda: C.empty(2, 8),
        "from_rows": lambda: C.from_rows(np.zeros((3, 2), np.int64), 8),
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_constructors_default_to_the_gpu(monkeypatch, name):
    """Without a device argument a constructor asks for the card, and
    raises without one, as build_sorted does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _constructors()[name]()
