"""The collectives of the distributed layer, with their backwards.

JAX transposes its collectives itself inside ``shard_map``; in torch a rank
is a process and each collective that carries a gradient is a
``torch.autograd.Function`` whose backward is the transposed collective:

* :func:`all_gather` (tiled on dim 0): backward a reduce-scatter sum
  (``reduce_scatter_tensor`` on NCCL; gloo has none, so an
  ``all_to_all`` plus a sum in rank order, as
  ``torch.distributed.nn.functional`` does);
* :func:`all_to_all_start` (equal splits of dim 0): backward the
  ``all_to_all`` of the gradients;
* :func:`permute_start` (to rank + shift): backward the permute the other
  way, over ``batch_isend_irecv``.

The ``*_start`` forms issue the collective asynchronously and return the
output with a :class:`Pending` to ``wait()`` on before the output is read:
the caller reduces what needs no exchanged data in between. Every rank
must issue the same collectives in the same order, forward and backward;
the steps of :mod:`.train` do, since every rank runs the same graph.
:func:`all_reduce` (a sum, no gradient) serves losses, metrics, the mask
normaliser and the gradients themselves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Pending:
    """An issued collective: :meth:`wait` before reading its output."""

    def __init__(self, works):
        self._works = list(works)

    def wait(self) -> None:
        for work in self._works:
            work.wait()
        self._works = []


def _gather(x, mesh):
    x = x.contiguous()
    if mesh.backend == "nccl":
        out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _reduce_scatter(g, mesh):
    g = g.contiguous()
    n = g.shape[0] // mesh.size
    rest = tuple(g.shape[1:])
    if mesh.backend == "nccl":
        out = g.new_empty((n,) + rest)
        dist.reduce_scatter_tensor(out, g)
        return out
    recv = torch.empty_like(g)
    dist.all_to_all_single(recv, g)
    return recv.reshape((mesh.size, n) + rest).sum(dim=0)


def _all_to_all(x, mesh, async_op):
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x.contiguous(),
                                  async_op=async_op)
    return out, work


def _permute(x, mesh, shift, async_op=True):
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      (mesh.rank + shift) % mesh.size),
           dist.P2POp(dist.irecv, out, (mesh.rank - shift) % mesh.size)]
    pending = Pending(dist.batch_isend_irecv(ops))
    if not async_op:
        pending.wait()
    return out, pending


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, issued):
        ctx.mesh = mesh
        out, work = _all_to_all(x, mesh, async_op=True)
        issued.append(Pending([work]))
        return out

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, async_op=False)[0], None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift, issued):
        ctx.mesh, ctx.shift = mesh, shift
        out, pending = _permute(x, mesh, shift)
        issued.append(pending)
        return out

    @staticmethod
    def backward(ctx, g):
        return (_permute(g, ctx.mesh, -ctx.shift, async_op=False)[0], None,
                None, None)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] stacked in rank order: [D * n, ...]."""
    return _AllGather.apply(x, mesh)


def all_to_all_start(x: torch.Tensor, mesh):
    """Issue the exchange of ``x`` [D * h, ...]: rows ``d*h:(d+1)*h`` go
    to rank ``d``, and row ``s*h + i`` of the output is rank ``s``'s row
    ``d*h + i`` (``d`` this rank). Returns ``(output, Pending)``."""
    issued = []
    out = _AllToAll.apply(x, mesh, issued)
    return out, issued[0]


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    out, pending = all_to_all_start(x, mesh)
    pending.wait()
    return out


def permute_start(x: torch.Tensor, mesh, shift: int = 1):
    """Issue the ring step: ``x`` goes to rank ``rank + shift``, the output
    is rank ``rank - shift``'s ``x``. Returns ``(output, Pending)``."""
    issued = []
    out = _Permute.apply(x, mesh, shift, issued)
    return out, issued[0]


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, in place (no gradient)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows in rank order, outside autograd (logits)."""
    return _gather(x.detach(), mesh)
