"""Native (C++, OpenMP) host kernels: boolean spgemm, pattern difference,
reverse Cuthill-McKee order, the padded ELL neighbor table.

The port of ``h2gcn_tpu.native``. The source is the port's own copy,
``h2gcn_tpu_torch/csrc/host/graphops.cpp``; at first use it is compiled by
``g++ -O3 -fopenmp -shared -fPIC`` (without ``-fopenmp``, serial, where the
compiler has no OpenMP runtime) into
``h2gcn_tpu_torch/_build/libgraphops_<hash>.so`` (``<hash>`` covers the
source, so an edit rebuilds) and loaded with :mod:`ctypes`. Without a host
compiler, or if every build fails, it warns once and every entry point
takes its scipy path, as the JAX package does. This is host code: it runs once per
dataset, before anything reaches the device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import scipy.sparse as sp

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "graphops.cpp"
BUILD_DIR = _PKG / "_build"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgraphops_{digest}.so"


def _compilers() -> list:
    found = [os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
             shutil.which("c++")]
    out = []
    for cxx in found:
        if cxx and Path(cxx).exists() and cxx not in out:
            out.append(cxx)
    return out


def _compile(so: Path) -> None:
    """Build ``so`` with the first host compiler that takes the source:
    with OpenMP where the compiler has it, else serial (the pragmas are
    then ignored; the results are the same)."""
    compilers = _compilers()
    if not compilers:
        raise RuntimeError("no host C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    errors = []
    for openmp in (["-fopenmp"], []):
        for cxx in compilers:
            cmd = [cxx, "-O3", *openmp, "-shared", "-fPIC", "-std=c++17",
                   "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, so)  # atomic: a concurrent build sees all
                return
            errors.append(f"{' '.join(cmd)}:\n{proc.stderr[-1000:]}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError("every host compiler failed:\n" + "\n".join(errors))


@functools.lru_cache(maxsize=1)
def _load():
    """The bound library, or None (after one warning) when it cannot be
    built or loaded."""
    try:
        so = library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
    except Exception as e:  # noqa: BLE001 — the scipy paths take over
        warnings.warn(f"graphops native library unavailable ({e}); "
                      "using scipy fallbacks")
        return None
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    for name, argtypes in (
            ("bool_spgemm_count_nt", [i64, i64, p64, p32, p64, p32, p64, i64]),
            ("bool_spgemm_fill_nt",
             [i64, i64, p64, p32, p64, p32, p64, p32, i64]),
            ("bool_subtract_count", [i64, p64, p32, p64, p32, p64]),
            ("bool_subtract_fill", [i64, p64, p32, p64, p32, p64, p32]),
            ("rcm_order", [i64, p64, p32, p32]),
            ("build_ell", [i64, p64, p32, i64, p32,
                           ctypes.POINTER(ctypes.c_uint8)])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    lib.graphops_openmp_threads.argtypes = []
    lib.graphops_openmp_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def openmp_threads() -> int:
    """Threads the library's OpenMP loops run on: 1 for a serial build (a
    compiler without OpenMP), 0 without the library."""
    lib = _load()
    return 0 if lib is None else int(lib.graphops_openmp_threads())


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _pu8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_csr_idx(m: sp.csr_matrix):
    indptr = np.ascontiguousarray(m.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(m.indices, dtype=np.int32)
    return indptr, indices


def bool_spgemm(a: sp.csr_matrix, b: sp.csr_matrix,
                num_threads: int = 0) -> sp.csr_matrix:
    """Boolean sparse x sparse product ``1[(A @ B) > 0]``, data all ones.

    ``num_threads`` caps the kernel's OpenMP team (0: the runtime's
    default): the thread transport of the sharded precompute
    (:mod:`h2gcn_tpu_torch.parallel.spgemm`) gives each of its P concurrent
    workers ``ncpu // P`` lanes. The ctypes calls release the GIL, so P
    Python threads run these products in parallel."""
    lib = _load()
    if lib is None:
        c = (a @ b)
        c.data[:] = 1.0
        return c.tocsr()
    n, k = a.shape
    k2, m = b.shape
    if k != k2:
        raise ValueError(f"bool_spgemm: {a.shape} @ {b.shape}")
    a_ip, a_ix = _as_csr_idx(a.tocsr())
    b_ip, b_ix = _as_csr_idx(b.tocsr())
    counts = np.zeros(n, dtype=np.int64)
    lib.bool_spgemm_count_nt(n, m, _p64(a_ip), _p32(a_ix), _p64(b_ip),
                             _p32(b_ix), _p64(counts), num_threads)
    c_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=c_indptr[1:])
    c_indices = np.empty(c_indptr[-1], dtype=np.int32)
    lib.bool_spgemm_fill_nt(n, m, _p64(a_ip), _p32(a_ix), _p64(b_ip),
                            _p32(b_ix), _p64(c_indptr), _p32(c_indices),
                            num_threads)
    data = np.ones(c_indptr[-1], dtype=np.float32)
    return sp.csr_matrix((data, c_indices, c_indptr), shape=(n, m))


def bool_subtract(a: sp.csr_matrix, b: sp.csr_matrix) -> sp.csr_matrix:
    """Set difference of CSR patterns: the entries of A not in B."""
    lib = _load()
    if lib is None:
        c = (a - a.multiply(b)).tocsr()
        c.eliminate_zeros()
        return c
    n, m = a.shape
    a_csr = a.tocsr()
    a_csr.sort_indices()
    b_csr = b.tocsr()
    b_csr.sort_indices()
    a_ip, a_ix = _as_csr_idx(a_csr)
    b_ip, b_ix = _as_csr_idx(b_csr)
    counts = np.zeros(n, dtype=np.int64)
    lib.bool_subtract_count(n, _p64(a_ip), _p32(a_ix), _p64(b_ip),
                            _p32(b_ix), _p64(counts))
    c_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=c_indptr[1:])
    c_indices = np.empty(c_indptr[-1], dtype=np.int32)
    lib.bool_subtract_fill(n, _p64(a_ip), _p32(a_ix), _p64(b_ip),
                           _p32(b_ix), _p64(c_indptr), _p32(c_indices))
    data = np.ones(c_indptr[-1], dtype=np.float32)
    return sp.csr_matrix((data, c_indices, c_indptr), shape=(n, m))


def nhood_split_fast(adj: sp.csr_matrix, nhood: int):
    """Exact-hop split ``[I, A1, A2, ...]`` through the boolean spgemm; the
    output contract of :func:`h2gcn_tpu_torch.sparse.transforms.nhood_split`
    (float32 patterns of ones)."""
    n = adj.shape[0]
    a_plus_i = (adj + sp.eye(n, format="csr")).tocsr()
    a_plus_i.data[:] = 1.0
    mt = sp.eye(n, format="csr", dtype=np.float32)
    out = [mt]
    edge_sum = 0
    i = 0
    while i < nhood:
        prev = mt
        mt = bool_spgemm(mt, a_plus_i)
        new_edge_sum = mt.nnz
        if new_edge_sum == edge_sum:
            break
        edge_sum = new_edge_sum
        i += 1
        out.append(bool_subtract(mt, prev))
    return out


def rcm_order(adj: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (int32[n]) of a symmetric pattern:
    ``A[perm][:, perm]`` has reduced bandwidth. scipy's
    ``reverse_cuthill_mckee`` without the library (its ties break
    differently, so the order differs)."""
    csr = adj.tocsr()
    lib = _load()
    if lib is None:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(
            reverse_cuthill_mckee(csr, symmetric_mode=True), dtype=np.int32)
    n = csr.shape[0]
    ip, ix = _as_csr_idx(csr)
    perm = np.empty(n, dtype=np.int32)
    lib.rcm_order(n, _p64(ip), _p32(ix), _p32(perm))
    return perm


def build_ell(adj: sp.spmatrix):
    """Padded ELL neighbor table ``int32[n, dmax]`` (row ``i`` holds node
    ``i``'s neighbors in CSR order, then zeros) and its validity mask
    ``bool[n, dmax]``; ``dmax`` is at least 1. Without the library, the
    same table from a Python loop over the rows."""
    csr = adj.tocsr()
    n = csr.shape[0]
    degs = np.diff(csr.indptr)
    dmax = max(1, int(degs.max()))
    lib = _load()
    table = np.zeros((n, dmax), dtype=np.int32)
    valid = np.zeros((n, dmax), dtype=np.uint8)
    if lib is None:
        for i in range(n):
            nbrs = csr.indices[csr.indptr[i]:csr.indptr[i + 1]]
            table[i, : len(nbrs)] = nbrs
            valid[i, : len(nbrs)] = 1
    else:
        ip, ix = _as_csr_idx(csr)
        lib.build_ell(n, _p64(ip), _p32(ix), dmax, _p32(table), _pu8(valid))
    return table, valid.astype(bool)
