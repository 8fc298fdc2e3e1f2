"""The yardstick's arithmetic: the card's published peaks, the least time
of a piece of work, and the operations and bytes of the kernels the
per-layer metrics time, all from shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 67 TFLOP/s in float32
outside the tensor cores (the configurations run float32 with TF32 off)
and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> tuple:
    """``(seconds, bound)``: the larger of the operations at the float32
    peak and the bytes at the memory peak, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def spmm(nnz: int, n_out: int, n_in: int, f: int) -> tuple:
    """``(flops, bytes)`` of ``y = A x``, A [n_out, n_in] with ``nnz``
    entries, x [n_in, f], float32: a multiply-add an entry and feature;
    A read once as CSR (a float32 value and an int32 column an entry, an
    int32 row pointer a row), x read once and y written once."""
    return (2.0 * nnz * f,
            8.0 * nnz + 4.0 * (n_out + 1) + 4.0 * n_in * f + 4.0 * n_out * f)


def attention_forward(n: int, edges: int, heads: int, feat: int) -> tuple:
    """``(flops, bytes)`` of one multi-head graph attention forward over
    ``edges`` (self loops included): an edge and head takes the logit (an
    add), LeakyReLU, the exponential and the denominator's add (4), and
    a multiply-add a feature (2 feat); a node and head the division
    (feat). The support read once as CSR (an int32 column an edge, an
    int32 row pointer a row), f1 and f2 [n, heads] and h [n, heads *
    feat] read once, the output [n, heads * feat] written once."""
    flops = edges * heads * (2.0 * feat + 4.0) + n * heads * feat
    nbytes = (4.0 * edges + 4.0 * (n + 1) + 8.0 * n * heads
              + 8.0 * n * heads * feat)
    return flops, nbytes


def dense(m: int, k: int, n: int) -> tuple:
    """``(flops, bytes)`` of ``[m, k] @ [k, n]`` in float32."""
    return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)


def add(*works) -> tuple:
    return (sum(w[0] for w in works), sum(w[1] for w in works))


def scale(work: tuple, times: float) -> tuple:
    return (work[0] * times, work[1] * times)
