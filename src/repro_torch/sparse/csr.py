"""CSR sparse container (counterpart of ``repro/sparse/csr.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSR:
    """Compressed Sparse Row: three numpy arrays, no partitioning."""
    row_ptr: np.ndarray   # [V+1] int64
    col_idx: np.ndarray   # [E] int32
    values: np.ndarray    # [E] float32

    @classmethod
    def from_arrays(cls, row_ptr, col_idx, values) -> "CSR":
        """A CSR from another package's arrays (e.g. the JAX package's
        ``CSR``), copied into this package's dtypes."""
        row_ptr = np.array(row_ptr, np.int64)
        col_idx = np.array(col_idx, np.int32)
        values = np.array(values, np.float32)
        if row_ptr.ndim != 1 or len(row_ptr) < 1 or row_ptr[0] != 0:
            raise ValueError("row_ptr must be 1-D and start at 0")
        if len(col_idx) != row_ptr[-1] or len(values) != len(col_idx):
            raise ValueError("col_idx/values length must equal row_ptr[-1]")
        return cls(row_ptr, col_idx, values)

    @property
    def n(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.col_idx)

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def row_of(self) -> np.ndarray:
        """Row index of every nonzero (rows repeated by degree)."""
        return np.repeat(np.arange(self.n, dtype=np.int64), self.degrees())

    def transpose(self) -> "CSR":
        order = np.argsort(self.col_idx, kind="stable")
        rows_t = self.col_idx[order]
        cols_t = self.row_of()[order].astype(np.int32)
        return CSR(_row_ptr(rows_t, self.n), cols_t, self.values[order])

    def memory_bytes(self) -> int:
        """Bytes of the three arrays (the analytic models' footprint)."""
        return (self.row_ptr.nbytes + self.col_idx.nbytes
                + self.values.nbytes)


def _row_ptr(rows: np.ndarray, n: int) -> np.ndarray:
    rp = np.zeros(n + 1, np.int64)
    rp[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return rp


def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
               values: np.ndarray | None = None) -> CSR:
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    if values is None:
        values = np.ones(len(src), np.float32)
    else:
        values = values[order]
    return CSR(_row_ptr(src, n), dst.astype(np.int32),
               values.astype(np.float32))
