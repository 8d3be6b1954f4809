"""Sparse (CSR / ELL) representations of the mixing matrix ``A_t``.

Every registered topology family is sparse by construction -- a
k-regular row has ``k`` entries, a ``ring`` row ``hops + 1`` -- yet the
legacy pipeline materialized the block-diagonal ``(n, n)`` equal-neighbor
matrix densely at every layer (plans stored ``(K, n, n)`` columns, the
kernels ran a dense ``A @ X``).  That caps ``n`` in the hundreds.  This
module holds the representations that remove the O(n^2) wall:

``SparseA``
    one ``(n, n)`` mixing matrix in CSR *by destination row*: row ``i``
    lists the in-neighbors ``j`` contributing ``A[i, j] = 1 / d_j^+`` to
    client ``i``'s D2D mix (eq. 2-3).  Column-stochasticity and
    block-diagonal structure are properties of the data, not the
    container.

``SparseAseq``
    a K-round trajectory of ``SparseA`` matrices -- the sparse image of
    the ``RoundPlan.A_t`` column.  Emulates the ``(K, n, n)`` ndarray
    surface the plan machinery touches (``shape``, ``len``, int/slice
    indexing) so dense and sparse plans share one code path.

``ell`` padding
    the device-facing layout: per-round ``(n, d_max)`` neighbor-index
    and weight arrays (ELLPACK), one fixed shape across rounds.
    Padding slots carry ``index 0, weight 0.0`` -- a no-op contribution
    that needs no masking in the kernel.

The eq.-4 D2S combine row ``(tau^T A) / m`` never needs the dense matrix
either: it is a segment-sum over the same edge list
(``repro_torch.kernels.mixing.ops.combine_weights_ell``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "SparseA",
    "SparseAseq",
    "ell_from_dense",
]


@dataclasses.dataclass(frozen=True)
class SparseA:
    """One (n, n) mixing matrix, CSR by destination row (see module
    docstring).  ``indices`` are sorted ascending within each row."""

    n: int
    indptr: np.ndarray    # (n + 1,) int64 row pointers
    indices: np.ndarray   # (nnz,) int32 source client j per entry
    data: np.ndarray      # (nnz,) float32 A[i, j]

    def __post_init__(self):
        if self.indptr.shape != (self.n + 1,):
            raise ValueError(
                f"indptr must be ({self.n + 1},), got {self.indptr.shape}")
        if self.indices.shape != self.data.shape:
            raise ValueError("indices and data must have equal length")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @property
    def row_degrees(self) -> np.ndarray:
        """In-degree of each destination row (entries per row)."""
        return np.diff(self.indptr).astype(np.int64)

    def row_ids(self) -> np.ndarray:
        """Destination row id of every stored entry, shape (nnz,)."""
        return np.repeat(np.arange(self.n), self.row_degrees)

    def dense(self) -> np.ndarray:
        A = np.zeros((self.n, self.n), dtype=np.float32)
        A[self.row_ids(), self.indices] = self.data
        return A

    def ell(self, d_max: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Padded neighbor-list (ELLPACK) form: ``(idx, w)`` of shape
        ``(n, d_max)`` with index 0 / weight 0.0 padding."""
        deg = self.row_degrees
        d_max = max(int(d_max), int(deg.max(initial=0)), 1)
        idx = np.zeros((self.n, d_max), dtype=np.int32)
        w = np.zeros((self.n, d_max), dtype=np.float32)
        rows = self.row_ids()
        slots = np.arange(self.nnz) - np.repeat(self.indptr[:-1], deg)
        idx[rows, slots] = self.indices
        w[rows, slots] = self.data
        return idx, w

    def equals(self, other: "SparseA") -> bool:
        return (self.n == other.n
                and np.array_equal(self.indptr, other.indptr)
                and np.array_equal(self.indices, other.indices)
                and np.array_equal(self.data, other.data))

    @classmethod
    def from_dense(cls, A: np.ndarray) -> "SparseA":
        A = np.asarray(A)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"need a square matrix, got {A.shape}")
        rows, cols = np.nonzero(A)
        n = A.shape[0]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        return cls(n=n, indptr=indptr, indices=cols.astype(np.int32),
                   data=A[rows, cols].astype(np.float32))

    @classmethod
    def from_edges(cls, n: int, dst: np.ndarray, src: np.ndarray,
                   data: np.ndarray) -> "SparseA":
        """Assemble from an unsorted edge list (destination, source,
        weight); entries are CSR-canonicalized (rows ascending, sorted
        by source within each row)."""
        order = np.lexsort((src, dst))
        dst, src, data = dst[order], src[order], data[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
        return cls(n=n, indptr=indptr, indices=src.astype(np.int32),
                   data=np.asarray(data, np.float32))

    @classmethod
    def identity(cls, n: int) -> "SparseA":
        """The FedAvg matrix A = I, n entries instead of n^2."""
        return cls(n=n, indptr=np.arange(n + 1, dtype=np.int64),
                   indices=np.arange(n, dtype=np.int32),
                   data=np.ones(n, dtype=np.float32))


class SparseAseq:
    """A K-round trajectory of ``SparseA`` matrices with the ndarray
    surface ``RoundPlan`` touches: ``shape == (K, n, n)``, ``len``,
    ``seq[t] -> SparseA``, ``seq[a:b] -> SparseAseq``."""

    def __init__(self, mats: Sequence[SparseA]):
        mats = tuple(mats)
        if not mats:
            raise ValueError("SparseAseq needs at least one round")
        n = mats[0].n
        if any(m.n != n for m in mats):
            raise ValueError("all rounds must share the client count n")
        self.mats = mats
        self.n = n

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.mats), self.n, self.n)

    @property
    def nnz(self) -> int:
        return sum(m.nnz for m in self.mats)

    @property
    def max_degree(self) -> int:
        return max(int(m.row_degrees.max(initial=0)) for m in self.mats)

    def __len__(self) -> int:
        return len(self.mats)

    def __getitem__(self, idx: Union[int, slice]
                    ) -> Union[SparseA, "SparseAseq"]:
        if isinstance(idx, slice):
            return SparseAseq(self.mats[idx])
        return self.mats[int(idx)]

    def __iter__(self):
        return iter(self.mats)

    def dense(self) -> np.ndarray:
        """The (K, n, n) dense image (small-n parity tests only)."""
        return np.stack([m.dense() for m in self.mats])

    def ell(self) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked (K, n, d_max) ELL arrays, d_max shared across rounds
        so every round has one shape."""
        d_max = max(self.max_degree, 1)
        pairs = [m.ell(d_max) for m in self.mats]
        return (np.stack([i for i, _ in pairs]),
                np.stack([w for _, w in pairs]))

    def equals(self, other: "SparseAseq") -> bool:
        return (isinstance(other, SparseAseq)
                and len(self) == len(other)
                and all(a.equals(b) for a, b in zip(self.mats, other.mats)))

    @classmethod
    def from_dense(cls, A_t: np.ndarray) -> "SparseAseq":
        return cls([SparseA.from_dense(A) for A in np.asarray(A_t)])


def ell_from_dense(A: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (n, n) -> padded ELL ``(idx, w)`` (testing convenience)."""
    return SparseA.from_dense(A).ell()
