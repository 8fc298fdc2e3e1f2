"""The hop SpMM's share of its roofline: the program's public
``sparse.spmm`` on the cell's widest hop matrix (the last of the
``--adj_nhood`` groups, Â₂ for H2GCN-2) at F = 128, the epoch's widest
call, forward, device time by CUDA events over 20 calls; the bound from
:func:`benchmark.work.spmm` with the entries counted by the benchmark."""

from pathlib import Path

import torch

from benchmark import harness, reference, work

_kt = harness.load_module(Path(__file__).with_name("_kernel_time.py"),
                          "bench_kernel_time")

F = 128


def read(run):
    hops = run.program.tensors.get("adj_hops")
    if (run.program.device.type != "cuda" or not isinstance(hops, list)
            or not hops):
        return None
    from h2gcn_tpu_torch.sparse import spmm

    g, dev = run.graph, run.program.device
    _, (r2, _) = reference.exact_hops(g.src, g.dst, g.n, dev)
    a = hops[-1]
    x = torch.randn(g.n, F, device=dev)
    with torch.no_grad():
        ms = _kt.ms_per_call(lambda: spmm(a, x))
    least, _ = work.least_seconds(*work.spmm(int(r2.numel()), g.n, g.n, F))
    return 100.0 * least / (ms / 1e3)
