"""The namespace a DSL ``lambda`` layer is evaluated in.

Network setups write their lambdas against ``jnp`` (``jax.numpy``) and
``nn`` (``jax.nn``), e.g. ``[lambda x: nn.gelu(jnp.tanh(x))]``. The port
evaluates the same string against the two objects below, which map the
listed functions onto torch with the JAX defaults and argument names
(``axis=``, ``keepdims=``, ``gelu``'s tanh approximation). A name that is
not listed raises ``AttributeError`` instead of computing something else.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _pair(a, b):
    """Two operands as tensors; a Python scalar takes the other's dtype."""
    if isinstance(a, torch.Tensor):
        return a, _tensor(b, a)
    b = _tensor(b, torch.empty(0))
    return _tensor(a, b), b


def _reduce(fn_all, fn_dim):
    def reduce(x, axis=None, keepdims=False):
        if axis is None:
            out = fn_all(x)
            if keepdims:
                out = out.reshape((1,) * x.dim())
            return out
        return fn_dim(x, dim=axis, keepdim=keepdims)

    return reduce


def _single_axis(axis):
    if not isinstance(axis, int):
        raise TypeError(f"axis must be one int here, not {axis!r}")
    return axis


def _clip(x, min=None, max=None):  # noqa: A002 (jnp.clip's names)
    return torch.clamp(x, min=min, max=max)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) everywhere (torch's switches to
    # x above a threshold)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


jnp = types.SimpleNamespace(
    abs=torch.abs,
    exp=torch.exp,
    log=torch.log,
    log1p=torch.log1p,
    expm1=torch.expm1,
    sqrt=torch.sqrt,
    square=torch.square,
    tanh=torch.tanh,
    sin=torch.sin,
    cos=torch.cos,
    sign=torch.sign,
    floor=torch.floor,
    ceil=torch.ceil,
    negative=torch.negative,
    maximum=lambda a, b: torch.maximum(*_pair(a, b)),
    minimum=lambda a, b: torch.minimum(*_pair(a, b)),
    power=lambda a, b: torch.pow(*_pair(a, b)),
    where=lambda cond, a, b: torch.where(cond, *_pair(a, b)),
    clip=_clip,
    sum=_reduce(torch.sum, torch.sum),
    mean=_reduce(torch.mean, torch.mean),
    max=_reduce(torch.amax, torch.amax),
    min=_reduce(torch.amin, torch.amin),
    concatenate=lambda arrays, axis=0: torch.cat(list(arrays), dim=axis),
    stack=lambda arrays, axis=0: torch.stack(list(arrays), dim=axis),
    reshape=lambda x, shape: torch.reshape(x, shape),
    matmul=torch.matmul,
)

nn = types.SimpleNamespace(
    relu=torch.relu,
    relu6=F.relu6,
    elu=lambda x, alpha=1.0: F.elu(x, alpha=alpha),
    celu=lambda x, alpha=1.0: F.celu(x, alpha=alpha),
    selu=F.selu,
    leaky_relu=lambda x, negative_slope=0.01: F.leaky_relu(x, negative_slope),
    gelu=lambda x, approximate=True: F.gelu(
        x, approximate="tanh" if approximate else "none"),
    sigmoid=torch.sigmoid,
    log_sigmoid=F.logsigmoid,
    softplus=_softplus,
    silu=F.silu,
    swish=F.silu,
    mish=F.mish,
    soft_sign=F.softsign,
    hard_tanh=F.hardtanh,
    tanh=torch.tanh,
    softmax=lambda x, axis=-1: torch.softmax(x, dim=_single_axis(axis)),
    log_softmax=lambda x, axis=-1: torch.log_softmax(
        x, dim=_single_axis(axis)),
)
