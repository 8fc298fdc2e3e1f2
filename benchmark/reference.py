"""The plain reference's shared parts: plain PyTorch in float32, imported by
each configuration's reference (``benchmark/configs/<name>.py``).

It imports nothing of the program under test. What the program derives
from the generated graph (normalized features, the exact-hop matrices, the
attention support, the initial weights, the dropout masks) is worked out
here again from the graph and the seed alone.

``precision`` is ``"highest"`` (float32 products, TF32 off) or ``"tf32"``,
the control: every dense matmul's operands rounded to TF32 (10 mantissa
bits, round to nearest even) with float32 sums, which is what the card's
TF32 mode computes, made explicit so that it reads the same on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with TF32 operands and float32 sums, forward and backward
    (the card's TF32 mode rounds the backward's products' operands too)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return (torch.matmul(g, tf32_round(b).transpose(-1, -2)),
                torch.matmul(tf32_round(a).transpose(-1, -2), g))


def matmul(a, b, precision: str):
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    if precision != "highest":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)


def glorot(fan_in: int, fan_out: int, gen: torch.Generator) -> torch.Tensor:
    """Glorot-uniform [fan_in, fan_out] drawn on the CPU from ``gen``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(fan_in, fan_out, generator=gen) * 2 - 1) * limit


def dropout(x, rate: float, gen, training: bool):
    """Inverted dropout: keep where ``rand < 1 - rate``, scale by
    ``1 / (1 - rate)``; the mask drawn from ``gen`` on ``x``'s device in one
    call of ``x``'s shape."""
    if not training or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


def row_normalize(x: torch.Tensor) -> torch.Tensor:
    s = x.sum(dim=1)
    inv = torch.where(s == 0, torch.zeros((), device=x.device), 1.0 / s)
    return x * inv[:, None]


def sym_normalized(rows, cols, n: int, device) -> torch.Tensor:
    """D^-1/2 A D^-1/2 of the 0/1 pattern ``(rows, cols)`` as a coalesced
    float32 sparse COO tensor (degrees from the pattern; zero degree: 0)."""
    deg = torch.bincount(rows, minlength=n).to(torch.float64)
    d = torch.where(deg > 0, deg.rsqrt(), torch.zeros((), dtype=torch.float64,
                                                       device=device))
    vals = (d[rows] * d[cols]).to(torch.float32)
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                   device=device,
                                   check_invariants=False).coalesce()


def exact_hops(src: np.ndarray, dst: np.ndarray, n: int, device):
    """``(rows, cols)`` of the exact-1-hop and exact-2-hop patterns of the
    undirected graph ``src``-``dst`` (no self loops): ``A1 = A``, and
    ``A2[i, j] = 1`` where ``(A + I)^2`` reaches ``j`` from ``i`` but
    ``A + I`` does not. Computed on ``device`` a block of columns at a time,
    as a sparse times dense product of integer counts (exact in float32)."""
    s = torch.as_tensor(np.concatenate([src, dst]), device=device)
    d = torch.as_tensor(np.concatenate([dst, src]), device=device)
    eye = torch.arange(n, device=device)
    ai_r, ai_c = torch.cat([s, eye]), torch.cat([d, eye])
    ai = torch.sparse_coo_tensor(torch.stack([ai_r, ai_c]),
                                 torch.ones(ai_r.numel(), device=device),
                                 (n, n), check_invariants=False).coalesce()
    block = max(1, min(n, (1 << 26) // n))
    r2, c2 = [], []
    for j0 in range(0, n, block):
        j1 = min(n, j0 + block)
        sel = (ai_c >= j0) & (ai_c < j1)
        dense = torch.zeros(n, j1 - j0, device=device)
        dense[ai_r[sel], ai_c[sel] - j0] = 1.0
        reach = torch.sparse.mm(ai, dense)
        i, j = torch.nonzero((reach > 0) & (dense == 0), as_tuple=True)
        r2.append(i)
        c2.append(j + j0)
    r2, c2 = torch.cat(r2), torch.cat(c2)
    order = torch.argsort(r2 * n + c2)
    return (s, d), (r2[order], c2[order])


def masked_cross_entropy(logits, y, mask):
    """Softmax cross-entropy of one-hot ``y`` averaged over ``mask``."""
    m = mask.to(torch.float32)
    m = m / m.sum()
    logz = torch.logsumexp(logits, dim=-1)
    ce = y.sum(dim=-1) * logz - (y * logits).sum(dim=-1)
    return (ce * m).sum()


class KerasAdam:
    """Adam with keras's rule: ``alpha_t = lr sqrt(1 - b2^t) / (1 - b1^t)``
    (in float32), ``p -= alpha_t m / (sqrt(v) + eps)``, eps 1e-7."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-7):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        t = torch.tensor(float(self.t), dtype=torch.float32)
        alpha = float(self.lr * torch.sqrt(1.0 - self.b2 ** t)
                      / (1.0 - self.b1 ** t))
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            p.add_(self.m[k] * -alpha / (torch.sqrt(self.v[k]) + self.eps))


class Inputs:
    """What both models read of the graph, on ``device``: row-normalized
    features, one-hot labels per split and the split masks."""

    def __init__(self, graph, device, fault=None):
        n, c = graph.n, graph.classes
        self.n, self.classes, self.device = n, c, device
        x = torch.as_tensor(graph.dense_features(), device=device)
        self.features = row_normalize(x)
        y = torch.zeros(n, c, device=device)
        y[torch.arange(n, device=device),
          torch.as_tensor(graph.labels, device=device)] = 1.0
        self.masks = {}
        for scope, idx in (("train", graph.idx_train), ("val", graph.idx_val),
                           ("test", graph.idx_test)):
            m = torch.zeros(n, dtype=torch.bool, device=device)
            m[torch.as_tensor(idx, device=device)] = True
            self.masks[scope] = m
        self.y = y
        self.train_mask = self.masks["train"]
        if fault == "half_batch":
            # half of the training nodes left out, the mean over the rest
            idx = torch.nonzero(self.train_mask).ravel()
            self.train_mask = self.train_mask.clone()
            self.train_mask[idx[1::2]] = False
        # one training and one validation node's answers altered
        self.altered = ([int(graph.idx_train[0]), int(graph.idx_val[0])]
                        if fault == "answer" else None)


def follow(model, inputs: Inputs, params: dict, lr: float, seed: int,
           steps: int = 3) -> dict:
    """Train ``model`` (a configuration's reference) from ``params`` for
    ``steps`` full-batch steps, each followed by an evaluation, with the
    dropout stream of seed ``seed + 1`` on ``inputs.device``.

    Returns ``loss`` and ``eval_loss`` (one a step: the training loss
    before the update, the validation loss after it), ``grad1`` (the norm
    of each leaf's first gradient) and ``delta3`` (the norm of each leaf's
    change over the steps)."""
    dev = inputs.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = {k: v.detach().to(dev).clone().requires_grad_(True)
              for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = KerasAdam(params, lr)
    out = {"loss": [], "eval_loss": [], "grad1": {}, "delta3": {}}
    y = inputs.y
    for step in range(steps):
        logits = _altered(model.forward(params, True, gen), inputs)
        loss = (masked_cross_entropy(logits, y, inputs.train_mask)
                + model.l2(params))
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        if step == 0:
            out["grad1"] = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(params, grads)
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            logits = _altered(model.forward(params, False, None), inputs)
            out["eval_loss"].append(float(
                masked_cross_entropy(logits, y, inputs.masks["val"])
                + model.l2(params)))
    out["delta3"] = {k: float((params[k].detach() - start[k]).norm())
                     for k in params}
    return out


def _altered(logits, inputs):
    if inputs.altered is None:
        return logits
    bump = torch.zeros_like(logits)
    bump[inputs.altered, 0] = 1.0
    return logits + bump
