"""Build and bind the port's CUDA kernels.

The sources in ``h2gcn_tpu_torch/csrc/*.cu`` (and the ``*.cuh`` headers
they share) include no PyTorch header and export plain ``extern "C"``
launchers. At first use each source is compiled by its own ``nvcc -c``, all
of them at once, and one more ``nvcc`` links the objects into
``h2gcn_tpu_torch/_build/libh2gcn_kernels_<hash>.so`` (``<hash>`` covers the
sources' and headers' contents, so an edit rebuilds), which is loaded with
:mod:`ctypes`. Nothing here runs at import time: a CPU-only machine imports
the port without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argument types; every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    "h2gcn_gscatter_spmm": [_P, _P, _I] + [_P] * 5 + [_I, _P]
                           + [_I] * 6 + [_P],
    "h2gcn_bsr_spmm": [_P, _I] + [_P] * 3 + [_I, _P, _I, _I, _I, _P],
    "h2gcn_cootile_spmm": [_P] * 7 + [_I, _P] + [_I] * 8 + [_P],
    "h2gcn_gat_fwd": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    "h2gcn_gat_bwd_row": [_P] * 11 + [_I, _I, _I, _I, _F, _P],
    "h2gcn_gat_bwd_col": [_P] * 13 + [_I, _I, _I, _I, _F, _P],
    "h2gcn_gat_coo_fwd": [_P] * 13 + [_I] * 4 + [_F, _I, _I, _P],
    "h2gcn_gat_coo_bwd_row": [_P] * 14 + [_I] * 7 + [_F, _I, _P],
    "h2gcn_gat_coo_bwd_col": [_P] * 16 + [_I] * 4 + [_F, _I, _I, _P],
    "h2gcn_gscatter_weighted": [_P, _P, _I] + [_P] * 5
                               + [_L, _L, _I, _P, _P, _I, _I, _P, _I, _P]
                               + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([cuda_home] if cuda_home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libh2gcn_kernels_{h.hexdigest()[:16]}.so"


_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]


def _compile(so: Path) -> str:
    """Compile every source into an object at once, then link ``so``.
    Returns the compilers' output; raises if any step fails."""
    nvcc = _nvcc()
    stem = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc] + _ARCH + ["-c", "-Xcompiler", "-fPIC", "-Xptxas=-v",
                                "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc] + _ARCH + ["-shared", "-o", str(so)] + [str(o) for o in objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    (BUILD_DIR / "nvcc.log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
    return text


@functools.lru_cache(maxsize=1)
def library():
    """Build the kernels if this source hash has no library yet; load it.

    Returns ``(lib, build_seconds)``; ``build_seconds`` is 0.0 when the
    library was already built.
    """
    so = library_path()
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        try:
            _compile(tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        seconds = time.perf_counter() - t0
        os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.h2gcn_error_string.argtypes = [ctypes.c_int]
    lib.h2gcn_error_string.restype = ctypes.c_char_p
    return lib, seconds


def check(lib, err: int, what: str) -> None:
    """Raise if a launcher returned anything but cudaSuccess (0)."""
    if err != 0:
        msg = lib.h2gcn_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")
