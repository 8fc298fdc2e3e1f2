"""Plain reference of ``gcnii.json``: GCNII (Chen, Wei, Huang, Ding and Li,
ICML 2020, "Simple and Deep Graph Convolutional Networks"), the
non-variant model of the official code without the extra residual:

    Ã   = D̃^-1/2 (A + I) D̃^-1/2
    h0  = relu(dropout(X) W_in + b_in)
    for l = 1 .. L:
        s = (1 - α) Ã dropout(h) + α h0          (h = h0 at l = 1)
        β = ln(λ / l + 1)
        h = relu(β s W_l + (1 - β) s)             (no bias)
    logits = dropout(h) W_out + b_out

X is row-normalized. The loss is the masked cross-entropy plus
``(wd1 / 2) Σ_l |W_l|² + (wd2 / 2) (|W_in|² + |b_in|² + |W_out|² +
|b_out|²)``, the L2 terms whose gradients are torch's coupled
``weight_decay`` (the official code's, biases of the dense layers
included). Parameters carry the program's names (``w_in``, ``b_in``,
``convs.<l - 1>``, ``w_out``, ``b_out``) and are drawn in that order from a
CPU generator seeded with the run's seed; the dropout masks are drawn in
the forward's order (X, then each layer's input, then the output layer's
input: L + 2 masks).

Departures from the paper's code, as the program makes them:

- the keras-rule Adam (eps 1e-7, :class:`benchmark.reference.KerasAdam`)
  in place of torch's Adam (eps 1e-8);
- the initial weights from the seeded generator above, by the published
  rules: a convolution uniform in ±1/√hidden (the official
  ``reset_parameters``), a dense layer's weight and bias in ±1/√fan_in
  (``nn.Linear``'s).
"""

from __future__ import annotations

import math

import torch

from benchmark import reference as R


def _arg(cli, flag, kind=float):
    return kind(cli[cli.index(flag) + 1])


def _uniform(shape, bound, gen):
    return (torch.rand(*shape, generator=gen) * 2 - 1) * bound


class Model:
    def __init__(self, config: dict, graph, inputs: R.Inputs,
                 precision: str = "highest"):
        cli = config["cli"]
        self.layers = _arg(cli, "--layers", int)
        self.hidden = _arg(cli, "--hidden", int)
        self.alpha = _arg(cli, "--alpha")
        self.lamda = _arg(cli, "--lamda")
        self.dropout = _arg(cli, "--dropout")
        self.wd1 = _arg(cli, "--wd1")
        self.wd2 = _arg(cli, "--wd2")
        self.precision = precision
        self.x = inputs.features
        self.classes = inputs.classes
        n, dev = graph.n, inputs.device
        eye = torch.arange(n, device=dev)
        rows = torch.cat([torch.as_tensor(graph.src, device=dev),
                          torch.as_tensor(graph.dst, device=dev), eye])
        cols = torch.cat([torch.as_tensor(graph.dst, device=dev),
                          torch.as_tensor(graph.src, device=dev), eye])
        self.adj = R.sym_normalized(rows, cols, n, dev)

    def init_params(self, seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        din, hid = self.x.shape[1], self.hidden
        b_in, b_hid = 1.0 / math.sqrt(din), 1.0 / math.sqrt(hid)
        p = {"w_in": _uniform((din, hid), b_in, gen),
             "b_in": _uniform((hid,), b_in, gen)}
        for l in range(self.layers):
            p[f"convs.{l}"] = _uniform((hid, hid), b_hid, gen)
        p["w_out"] = _uniform((hid, self.classes), b_hid, gen)
        p["b_out"] = _uniform((self.classes,), b_hid, gen)
        return p

    def forward(self, p, training, gen):
        x = R.dropout(self.x, self.dropout, gen, training)
        h0 = torch.relu(R.matmul(x, p["w_in"], self.precision) + p["b_in"])
        h = h0
        for l in range(1, self.layers + 1):
            z = R.dropout(h, self.dropout, gen, training)
            s = ((1 - self.alpha) * torch.sparse.mm(self.adj, z)
                 + self.alpha * h0)
            beta = math.log(self.lamda / l + 1)
            h = torch.relu(beta * R.matmul(s, p[f"convs.{l - 1}"],
                                           self.precision)
                           + (1 - beta) * s)
        h = R.dropout(h, self.dropout, gen, training)
        return R.matmul(h, p["w_out"], self.precision) + p["b_out"]

    def l2(self, p):
        convs = sum(p[f"convs.{l}"].square().sum()
                    for l in range(self.layers))
        dense = sum(p[k].square().sum()
                    for k in ("w_in", "b_in", "w_out", "b_out"))
        return 0.5 * self.wd1 * convs + 0.5 * self.wd2 * dense


def epoch_work(graph, device) -> tuple:
    """``(flops, bytes)`` an epoch needs at least: a training forward, its
    backward and an evaluation forward. A forward is the input layer, the
    64 propagations over Ã (2E + n entries, read once a call) and the 64
    [hidden, hidden] products, and the output layer; the backward the same
    propagations (Ã is symmetric), each product's weight and input
    gradients, and the dense layers' gradients (X takes none). Elementwise
    work and the optimizer are left out, which only lowers the count."""
    from benchmark import work as W

    n, din, c = graph.n, graph.features.shape[1], graph.classes
    hid, layers = 64, 64
    nnz = 2 * len(graph.src) + n
    prop = W.spmm(nnz, n, n, hid)
    fwd = W.add(W.dense(n, din, hid),
                W.scale(W.add(prop, W.dense(n, hid, hid)), layers),
                W.dense(n, hid, c))
    bwd = W.add(W.dense(din, n, hid),
                W.scale(W.add(prop, W.dense(hid, n, hid),
                              W.dense(n, hid, hid)), layers),
                W.dense(hid, n, c), W.dense(n, c, hid))
    return W.add(W.scale(fwd, 2), bwd)
