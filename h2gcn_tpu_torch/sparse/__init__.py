"""Sparse core: device sparse matrices, the SpMM kernels, host transforms."""

from .matrix import BSR, SparseMatrix, spmm
from . import transforms

__all__ = ["SparseMatrix", "BSR", "spmm", "transforms"]
