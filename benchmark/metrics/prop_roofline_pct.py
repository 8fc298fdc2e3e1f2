"""GCNII's propagation's share of its roofline: the program's public
``sparse.spmm`` on the support it holds (Ã, ``adj_hops[0]``) at the
model's width F = 64, forward, device time by CUDA events over 20 calls;
the bound from :func:`benchmark.work.spmm` with the entries counted by the
benchmark from the graph (2E + n: both directions and the self loops)."""

from pathlib import Path

import torch

from benchmark import harness, work

_kt = harness.load_module(Path(__file__).with_name("_kernel_time.py"),
                          "bench_kernel_time")

F = 64


def read(run):
    hops = run.program.tensors.get("adj_hops")
    if (run.program.device.type != "cuda" or not isinstance(hops, list)
            or not hops):
        return None
    from h2gcn_tpu_torch.sparse import spmm

    g, dev = run.graph, run.program.device
    a = hops[0]
    x = torch.randn(g.n, F, device=dev)
    with torch.no_grad():
        ms = _kt.ms_per_call(lambda: spmm(a, x))
    nnz = 2 * len(g.src) + g.n
    least, _ = work.least_seconds(*work.spmm(nnz, g.n, g.n, F))
    return 100.0 * least / (ms / 1e3)
