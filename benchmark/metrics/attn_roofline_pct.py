"""The fused attention's share of its roofline: the call GAT's first
layer makes on the cell's payload (the gather payload, else the
COO-chunk or BSR one, whichever the program built), forward, device time
by CUDA events over 20 calls; the bound from
:func:`benchmark.work.attention_forward` on the cell's edges (self loops
included), heads and widths."""

from pathlib import Path

import torch

from benchmark import harness, work

_kt = harness.load_module(Path(__file__).with_name("_kernel_time.py"),
                          "bench_kernel_time")


def _first(cli, flag):
    return int(cli[cli.index(flag) + 1])


def read(run):
    adj = run.program.tensors.get("adj")
    attn, bsr = getattr(adj, "attn", None), getattr(adj, "bsr", None)
    if run.program.device.type != "cuda" or (attn is None and bsr is None):
        return None
    from h2gcn_tpu_torch.sparse.attention import gat_attention
    from h2gcn_tpu_torch.sparse.attention_coo import gat_attention_coo
    from h2gcn_tpu_torch.sparse.attention_gather import (GatherAttn,
                                                         gat_attention_gather)

    cli = run.config["cli"]
    heads, feat = _first(cli, "--n_heads"), _first(cli, "--hid_units")
    prec = cli[cli.index("--fused_precision") + 1]
    g, dev = run.graph, run.program.device
    gen = torch.Generator(device=dev).manual_seed(0)
    f1 = 0.5 * torch.randn(g.n, heads, device=dev, generator=gen)
    f2 = 0.5 * torch.randn(g.n, heads, device=dev, generator=gen)
    h = torch.randn(g.n, heads * feat, device=dev, generator=gen)
    kw = dict(num_heads=heads, feat=feat, n_out=g.n)
    if isinstance(attn, GatherAttn):
        def call():
            return gat_attention_gather(attn, f1, f2, h, precision=prec, **kw)
    elif attn is not None:
        def call():
            return gat_attention_coo(attn, f1, f2, h, precision=prec, **kw)
    else:
        def call():
            return gat_attention(bsr, f1, f2, h, **kw)
    with torch.no_grad():
        ms = _kt.ms_per_call(call)
    edges = 2 * len(g.src) + g.n
    least, _ = work.least_seconds(*work.attention_forward(g.n, edges, heads,
                                                          feat))
    return 100.0 * least / (ms / 1e3)
