"""Plain reference of ``gat.json``: GAT (Velickovic et al., ICLR 2018) with
the published Cora setup: a layer of 8 heads of 8 units (ELU, heads
concatenated), then one output head; attention over the self-looped graph,
per head

    h = dropout(x, in_drop) W
    e_ij = leaky_relu(h_i a1 + b1 + h_j a2 + b2, 0.2)
    alpha = softmax_j(e_ij), then dropout(alpha, attn_drop)
    out_i = sum_j alpha_ij dropout(h, in_drop)_j + bias

The loss is the masked cross-entropy plus ``l2_coef * sum(|p|^2) / 2``
over every parameter. Parameters carry the program's names
(``layers.<layer>.<head>.<W|a1|a2|b1|b2|bias>``) and are drawn as the
program's CLI draws them: glorot-uniform ``W``, ``a1``, ``a2`` head by head
from a CPU generator seeded with the run's seed. The dropout masks are
drawn in the order of the program's fused attention layer: per head the
input's mask then the projected features' mask, then one [edges, heads]
mask of the coefficients, edges in (row, column) order.
"""

from __future__ import annotations

import torch

from benchmark import reference as R


def _arg(cli, flag, kind=float, many=False):
    i = cli.index(flag)
    if not many:
        return kind(cli[i + 1])
    out = []
    for tok in cli[i + 1:]:
        if tok.startswith("--"):
            break
        out.append(kind(tok))
    return out


class Model:
    def __init__(self, config: dict, graph, inputs: R.Inputs,
                 precision: str = "highest"):
        cli = config["cli"]
        self.hid = _arg(cli, "--hid_units", int, many=True)
        self.heads = _arg(cli, "--n_heads", int, many=True)
        self.in_drop = _arg(cli, "--in_drop")
        self.attn_drop = _arg(cli, "--attn_drop")
        self.l2_coef = _arg(cli, "--l2_coef")
        self.precision = precision
        self.x = inputs.features
        self.classes = inputs.classes
        n, dev = graph.n, inputs.device
        eye = torch.arange(n, device=dev)
        r = torch.cat([torch.as_tensor(graph.src, device=dev),
                       torch.as_tensor(graph.dst, device=dev), eye])
        c = torch.cat([torch.as_tensor(graph.dst, device=dev),
                       torch.as_tensor(graph.src, device=dev), eye])
        order = torch.argsort(r * n + c)
        self.rows, self.cols = r[order], c[order]
        self.n = n

    def init_params(self, seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        dims = [self.x.shape[1]] + [h * k for h, k in
                                    zip(self.hid, self.heads[:-1])]
        outs = self.hid + [self.classes]
        p = {}
        for li, (din, dout) in enumerate(zip(dims, outs)):
            for hi in range(self.heads[li]):
                key = f"layers.{li}.{hi}."
                p[key + "W"] = R.glorot(din, dout, gen)
                p[key + "a1"] = R.glorot(dout, 1, gen)[:, 0]
                p[key + "a2"] = R.glorot(dout, 1, gen)[:, 0]
                p[key + "b1"] = torch.zeros(())
                p[key + "b2"] = torch.zeros(())
                p[key + "bias"] = torch.zeros(dout)
        return p

    def _layer(self, p, li, x, training, gen):
        nh = self.heads[li]
        hs, f1s, f2s = [], [], []
        for hi in range(nh):
            key = f"layers.{li}.{hi}."
            xd = R.dropout(x, self.in_drop, gen, training)
            h = R.matmul(xd, p[key + "W"], self.precision)
            f1s.append(h @ p[key + "a1"] + p[key + "b1"])
            f2s.append(h @ p[key + "a2"] + p[key + "b2"])
            hs.append(R.dropout(h, self.in_drop, gen, training))
        f1, f2 = torch.stack(f1s, 1), torch.stack(f2s, 1)     # [n, H]
        e = torch.nn.functional.leaky_relu(f1[self.rows] + f2[self.cols],
                                           0.2)               # [E, H]
        idx = self.rows[:, None].expand(-1, nh)
        rmax = torch.full((self.n, nh), -torch.inf, device=e.device)
        rmax = rmax.scatter_reduce(0, idx, e.detach(), reduce="amax")
        ex = torch.exp(e - rmax[self.rows])
        den = torch.zeros(self.n, nh, device=e.device).index_add(
            0, self.rows, ex)
        alpha = R.dropout(ex / den[self.rows], self.attn_drop, gen, training)
        feat = hs[0].shape[1]
        hcat = torch.stack(hs, 1)                             # [n, H, F]
        out = torch.zeros(self.n, nh, feat, device=e.device).index_add(
            0, self.rows, alpha[:, :, None] * hcat[self.cols])
        return [out[:, k] + p[f"layers.{li}.{k}.bias"] for k in range(nh)]

    def forward(self, p, training, gen):
        h = self.x
        n_layers = len(self.heads)
        for li in range(n_layers):
            outs = self._layer(p, li, h, training, gen)
            if li < n_layers - 1:
                h = torch.cat([torch.nn.functional.elu(o) for o in outs], 1)
            else:
                h = sum(outs) / len(outs)
        return h

    def l2(self, p):
        return self.l2_coef * 0.5 * sum(v.square().sum() for v in p.values())


def epoch_work(graph, device) -> tuple:
    """``(flops, bytes)`` an epoch needs at least: a training forward, its
    backward and an evaluation forward. A layer's forward is its
    projection (all heads as one product), the two attention scores a
    head, and the attention (:func:`benchmark.work.attention_forward`); its
    backward the projection's weight gradient (and, past the first layer,
    its input gradient) and twice the attention's work. Elementwise work
    and the optimizer are left out, which only lowers the count."""
    from benchmark import work as W

    n, din = graph.n, graph.features.shape[1]
    edges = 2 * len(graph.src) + n
    layers = [(din, 8, 8), (64, 1, graph.classes)]
    fwd, bwd = [], []
    for li, (d, h, f) in enumerate(layers):
        att = W.attention_forward(n, edges, h, f)
        fwd += [W.dense(n, d, h * f), W.dense(n, h * f, 2), att]
        bwd += [W.dense(d, n, h * f), W.scale(att, 2)]
        if li:
            bwd.append(W.dense(n, h * f, d))
    return W.add(W.scale(W.add(*fwd), 2), *bwd)
