"""Host-side table store: base-table storage and result sink.

Port of `ccve_tpu.core.collection` (the reference's `DataCollection`,
data_collection.h:15-33, data_collection.cpp:5-45, a
`vector<vector<int64_t>>` row store), as the same NumPy column store, so
that `fetch_chunk` is a column slice that goes to the device straight into
the chunk layout [n_cols, block] (`core.chunk.from_rows`), and
`append_chunk` a gather through the chunk's selection vector
(`core.chunk.to_rows`) instead of a loop a tuple (data_collection.cpp:15-19).
"""

from __future__ import annotations

import numpy as np

from ccve_tpu_torch.core import chunk as chunklib


class DataCollection:
    """Append-only int64 table; n_cols fixed at construction."""

    def __init__(self, n_cols: int, capacity: int = 1024):
        self._n_cols = n_cols
        self._data = np.zeros((n_cols, max(capacity, 1)), dtype=np.int64)
        self._n = 0

    # -- construction ------------------------------------------------------
    @classmethod
    def from_columns(cls, cols: np.ndarray) -> "DataCollection":
        cols = np.ascontiguousarray(cols, dtype=np.int64)
        out = cls(cols.shape[0], cols.shape[1])
        out._data[:, : cols.shape[1]] = cols
        out._n = cols.shape[1]
        return out

    def _reserve(self, extra: int):
        need = self._n + extra
        if need > self._data.shape[1]:
            cap = max(need, self._data.shape[1] * 2)
            grown = np.zeros((self._n_cols, cap), dtype=np.int64)
            grown[:, : self._n] = self._data[:, : self._n]
            self._data = grown

    # -- reference API parity ---------------------------------------------
    def append_tuple(self, tup) -> None:
        """DataCollection::AppendTuple (data_collection.cpp:5-8)."""
        self._reserve(1)
        self._data[:, self._n] = tup
        self._n += 1

    def append_rows(self, rows: np.ndarray) -> None:
        """Bulk append of int64[n_rows, n_cols]."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        self._reserve(rows.shape[0])
        self._data[:, self._n : self._n + rows.shape[0]] = rows.T
        self._n += rows.shape[0]

    def append_chunk(self, chunk: chunklib.Chunk) -> None:
        """DataCollection::AppendChunk (data_collection.cpp:10-21):
        materialize through the chunk's selection vector (the chunk may
        lie on any device)."""
        self.append_rows(chunklib.to_rows(chunk))

    def fetch_chunk(self, start: int, end: int, block_size: int, device="cuda") -> chunklib.Chunk:
        """DataCollection::FetchChunk (data_collection.cpp:23-27): rows
        [start, end) as a dense chunk on `device` (default the GPU; raises
        without one), zero-padded to block_size."""
        return chunklib.from_rows(self.rows()[start:end], block_size, device=device)

    def num_tuples(self) -> int:
        return self._n

    def print(self, n_tuples: int = 8) -> str:
        """DataCollection::Print (data_collection.cpp:29-45)."""
        lines = []
        for row in self.rows()[: min(n_tuples, self._n)]:
            lines.append(", ".join(str(v) for v in row) + ", ")
        text = "\n".join(lines)
        if text:
            print(text)
        return text

    # -- views --------------------------------------------------------------
    def columns(self) -> np.ndarray:
        """int64[n_cols, n] view of the live data."""
        return self._data[:, : self._n]

    def rows(self) -> np.ndarray:
        """int64[n, n_cols] view (transposed, not copied unless needed)."""
        return self._data[:, : self._n].T

    @property
    def n_cols(self) -> int:
        return self._n_cols

    def __len__(self) -> int:
        return self._n
