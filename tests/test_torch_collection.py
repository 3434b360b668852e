"""The port's `DataCollection` against the JAX package's, call for call on
the same rows: appends of tuples, row blocks and chunks (through a
selection vector), growth past capacity, empty appends, fetches,
`print`, and the views."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.core import chunk as JC
from ccve_tpu.core.collection import DataCollection as JaxCollection
from ccve_tpu_torch.core import DataCollection
from ccve_tpu_torch.core import chunk as C


def _same(port: DataCollection, ref: JaxCollection):
    assert len(port) == len(ref) == port.num_tuples() == ref.num_tuples()
    assert port.n_cols == ref.n_cols
    np.testing.assert_array_equal(port.columns(), ref.columns())
    np.testing.assert_array_equal(port.rows(), ref.rows())


@pytest.mark.parametrize("capacity", [1, 4, 1024])
def test_appends_match_jax(capacity, capsys):
    rng = np.random.default_rng(capacity)
    port, ref = DataCollection(3, capacity), JaxCollection(3, capacity)
    _same(port, ref)
    for tup in rng.integers(-(2**62), 2**62, (5, 3)):
        port.append_tuple(tup)
        ref.append_tuple(tup)
        _same(port, ref)
    for n_rows in (0, 1, 7, 0, 40):  # empty appends and growth past capacity
        rows = rng.integers(-(2**40), 2**40, (n_rows, 3))
        port.append_rows(rows)
        ref.append_rows(rows)
        _same(port, ref)
    port.append_rows(np.zeros((0, 3), np.int64))
    port.append_rows([])
    ref.append_rows([])
    _same(port, ref)
    assert port.print(4) == ref.print(4)
    assert port.print(100) == ref.print(100)
    assert DataCollection(3).print() == JaxCollection(3).print() == ""
    capsys.readouterr()


@pytest.mark.parametrize("block", [8, 64])
def test_chunks_match_jax(block):
    rng = np.random.default_rng(block)
    cols = rng.integers(-(2**62), 2**62, (2, 150))
    port, ref = DataCollection.from_columns(cols), JaxCollection.from_columns(cols)
    _same(port, ref)
    out, out_ref = DataCollection(2, 4), JaxCollection(2, 4)
    for start in range(0, 150, block):
        end = min(start + block, 150)
        got, want = port.fetch_chunk(start, end, block, device="cpu"), ref.fetch_chunk(start, end, block)
        assert got.cols.device.type == "cpu" and got.count == int(want.count)
        np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
        np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
        out.append_chunk(got)
        out_ref.append_chunk(want)
        _same(out, out_ref)
    # a chunk read through a selection vector: every third row, reversed
    picked = np.zeros(block, np.int32)
    live = np.arange(block - 1, -1, -3, dtype=np.int32)
    picked[: live.size] = live
    got = C.slice_compose(port.fetch_chunk(0, block, block, device="cpu"),
                          torch.from_numpy(picked), live.size)
    want = JC.slice_compose(ref.fetch_chunk(0, block, block), jnp.asarray(picked), live.size)
    out.append_chunk(got)
    out_ref.append_chunk(want)
    _same(out, out_ref)
    np.testing.assert_array_equal(out.rows()[150:], cols[:, live].T)
    out.append_chunk(C.empty(2, block, device="cpu"))  # an empty chunk appends nothing
    out_ref.append_chunk(JC.empty(2, block))
    _same(out, out_ref)


def test_fetch_chunk_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataCollection.from_columns(np.zeros((2, 4), np.int64)).fetch_chunk(0, 4, 4)


def test_fetch_chunk_refuses_more_rows_than_the_block():
    dc = DataCollection.from_columns(np.zeros((2, 10), np.int64))
    with pytest.raises(ValueError, match="block_size"):
        dc.fetch_chunk(0, 10, 8, device="cpu")
