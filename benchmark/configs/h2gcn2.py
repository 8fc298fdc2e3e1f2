"""Plain reference of ``h2gcn2.json``: H2GCN-2 (Zhu et al., NeurIPS 2020,
"Beyond Homophily in Graph Neural Networks"), the network setup
``M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO``:

    r0 = relu(X W0)                           (no bias)
    r1 = [A1 r0 | A2 r0]
    r2 = [A1 r1 | A2 r1]
    h  = dropout([r2 | r0 | r1], 0.5)
    logits = h W1                             (no bias)

A1, A2 are the exact-1-hop and exact-2-hop matrices of the self-loop-free
graph, each symmetrically normalized; X is row-normalized. The loss is the
masked cross-entropy plus keras's L2, ``5e-4 * (|W0|^2 + |W1|^2)``.
Parameters carry the program's names (``kernels.<layer index>``) and are
drawn as the program's CLI draws them: glorot-uniform from a CPU
generator seeded with the run's seed, in layer order.
"""

from __future__ import annotations

import torch

from benchmark import reference as R

SETUP = "M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO"


class Model:
    def __init__(self, config: dict, graph, inputs: R.Inputs,
                 precision: str = "highest"):
        cli = config["cli"]
        if cli[cli.index("--network_setup") + 1] != SETUP:
            raise ValueError("this reference implements " + SETUP)
        self.hidden = 64
        self.dropout = 0.5
        self.l2_weight = float(cli[cli.index("--l2_regularize_weight") + 1])
        self.precision = precision
        self.x = inputs.features
        (r1, c1), (r2, c2) = R.exact_hops(graph.src, graph.dst, graph.n,
                                          inputs.device)
        self.hops = [R.sym_normalized(r1, c1, graph.n, inputs.device),
                     R.sym_normalized(r2, c2, graph.n, inputs.device)]
        self.hop_nnz = [int(r1.numel()), int(r2.numel())]
        self.classes = inputs.classes

    def init_params(self, seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        din = self.x.shape[1]
        w0 = R.glorot(din, self.hidden, gen)
        w1 = R.glorot(7 * self.hidden, self.classes, gen)
        return {"kernels.0": w0, "kernels.9": w1}

    def _graph(self, x):
        return torch.cat([torch.sparse.mm(a, x) for a in self.hops], dim=1)

    def forward(self, p, training, gen):
        r0 = torch.relu(R.matmul(self.x, p["kernels.0"], self.precision))
        r1 = self._graph(r0)
        r2 = self._graph(r1)
        h = R.dropout(torch.cat([r2, r0, r1], dim=1), self.dropout, gen,
                      training)
        return R.matmul(h, p["kernels.9"], self.precision)

    def l2(self, p):
        return self.l2_weight * (p["kernels.0"].square().sum()
                                 + p["kernels.9"].square().sum())


def epoch_work(graph, device) -> tuple:
    """``(flops, bytes)`` an epoch needs at least: a training forward, its
    backward and an evaluation forward, counting the dense products and
    the hop products (each SpMM reads its matrix once; the backward's are
    the same products, the hop matrices being symmetric). Elementwise work
    and the optimizer are left out, which only lowers the count."""
    from benchmark import work as W

    (r1, _), (r2, _) = R.exact_hops(graph.src, graph.dst, graph.n, device)
    n, din, hid = graph.n, graph.features.shape[1], 64
    c = graph.classes
    hops = [int(r1.numel()), int(r2.numel())]

    def graph_layer(f):
        return W.add(*(W.spmm(z, n, n, f) for z in hops))

    fwd = W.add(W.dense(n, din, hid), graph_layer(hid),
                graph_layer(2 * hid), W.dense(n, 7 * hid, c))
    bwd = W.add(W.dense(din, n, hid), graph_layer(hid), graph_layer(2 * hid),
                W.dense(7 * hid, n, c), W.dense(n, c, 7 * hid))
    return W.add(W.scale(fwd, 2), bwd)
