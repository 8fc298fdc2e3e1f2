"""Distributed GAT: dest-stripe-sharded gather attention.

The port of ``h2gcn_tpu.parallel.attention``, on the port's gather payload
(:mod:`h2gcn_tpu_torch.sparse.attention_gather`, whose combines run
``csrc/gscatter_weighted.cu`` on the card). The partition is the halo
SpMM's:

* nodes are padded to ``n_pad = D·n_local`` and row-sharded: rank ``d``
  owns destination rows ``[d·n_local, (d+1)·n_local)`` and the matching
  slice of the features;
* each rank owns ALL attention edges targeting its rows; their source
  columns are remapped into the concatenated source space ``[local rows |
  halo receive buffer]`` (``n_cat = n_local + D·h_pad``);
* per layer, each rank projects its own rows (``h = xW``, ``f1 = h·a1``,
  ``f2 = h·a2``) and exchanges only the boundary rows of ``[f2 | h]`` in
  one ``all_to_all`` (:func:`halo_concat`): ``D·h_pad·(H + H·feat)``
  floats a rank, the hidden width, not the input features;
* the local attention is one rectangular gather-attention call over
  ``[n_local × n_cat]`` tables: the softmax of an owned row is exact
  because every in-edge of it is local by construction. Its backward runs
  unchanged, and the ``all_to_all``'s backward routes the halo rows'
  gradients to their owners.

Every shard's tables are built on the host and padded to one step count
(plus one all-zero dead step) and one edge count, with a leading device
axis (:class:`StackedGatherTables`), as the JAX package stacks them;
``local(mesh)`` takes a rank's own. Padding edges point at slots of the
dead step, which no slot maps back to an edge: they are inert.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..models.GAT import GATNetwork
from ..nn.ops import dropout
from ..sparse.attention_gather import (GATHER_TILE, GatherAttn, _SMS,
                                       build_gatherattn, combine_items,
                                       gat_attention_gather)
from ..sparse.gscatter import GScatter, GScatterSegment
from . import _collectives
from .dist import _halo_partition, _send_table
from .mesh import Mesh


@dataclasses.dataclass
class StackedGatherTables:
    """One orientation's gscatter tables for every shard, padded to one
    step count, leading axis the device: the arrays of the JAX package's
    ``StackedGatherTables``, plus each edge's slot (padding edges: the
    dead step's first slot)."""

    ctr: np.ndarray    # [D, nsteps] int32
    rows: np.ndarray   # [D, nsteps*kb, e_b] int32
    cols: np.ndarray   # [D, nsteps*kb*e_b] int32
    vals: np.ndarray   # [D, nsteps*kb, e_b] float32
    s2e: np.ndarray    # [D, nsteps*kb*e_b] int32 slot -> edge (pad: e_pad)
    slot: np.ndarray   # [D, e_pad] int64 edge -> slot
    n_rows: int
    n_cols: int
    rb: int

    def local(self, rank, tile, e_b, kb, device) -> GScatter:
        """Shard ``rank``'s tables as a one-segment :class:`GScatter`."""
        ctr = self.ctr[rank]
        chunk_ptr = (np.searchsorted(ctr, np.arange(self.rb + 1))
                     * kb).astype(np.int32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        seg = GScatterSegment(
            ctr=dev(ctr), rows=dev(self.rows[rank]), cols=dev(self.cols[rank]),
            vals=dev(self.vals[rank]), chunk_ptr=dev(chunk_ptr), rb_lo=0,
            rb_hi=self.rb, slot_lo=0, slot_hi=int(self.cols.shape[-1]))
        return GScatter(segments=(seg,), tile=tile, e_b=e_b, kb=kb,
                        n_rows=self.n_rows, n_cols=self.n_cols)


def _pack_shard_tables(gas, orient: str, n_rows: int, n_cols: int,
                       e_pad: int, kb: int, e_b: int) -> StackedGatherTables:
    """Pad each shard's one-segment tables to a uniform step count, plus
    one all-zero DEAD step (repeating the last stripe, so it accumulates
    nothing) where padding edges point, and stack them."""
    gss = [getattr(ga, orient) for ga in gas]
    for gs in gss:
        if len(gs.segments) != 1:
            raise ValueError(
                "distributed gather attention needs single-segment shard "
                f"tables ({len(gs.segments)} segments built); use more "
                "shards or a larger gscatter step cap")
    segs = [gs.segments[0] for gs in gss]
    rb = segs[0].rb_hi
    assert all(s.rb_lo == 0 and s.rb_hi == rb for s in segs)
    nsteps = max(int(s.ctr.shape[0]) for s in segs) + 1  # +1: dead step
    D = len(segs)
    ctr = np.zeros((D, nsteps), np.int32)
    rows = np.zeros((D, nsteps * kb, e_b), np.int32)
    cols = np.zeros((D, nsteps * kb * e_b), np.int32)
    vals = np.zeros((D, nsteps * kb, e_b), np.float32)
    s2e = np.full((D, nsteps * kb * e_b), e_pad, np.int32)
    slot = np.empty((D, e_pad), np.int64)
    for d, (ga, seg) in enumerate(zip(gas, segs)):
        k = int(seg.ctr.shape[0])
        ctr[d, :k] = seg.ctr.cpu().numpy()
        ctr[d, k:] = ctr[d, k - 1]  # repeat-last: accumulates zeros
        rows[d, :k * kb] = seg.rows.cpu().numpy()
        cols[d, :k * kb * e_b] = seg.cols.cpu().numpy()
        vals[d, :k * kb] = seg.vals.cpu().numpy()
        # slot -> edge in the uniform slot space: padding and dead slots
        # read the sentinel zero row (index e_pad)
        edge_slot = (ga.slot_fwd if orient == "fwd" else ga.slot_bwd).cpu()
        s2e[d, edge_slot.numpy()] = np.arange(len(edge_slot), dtype=np.int32)
        slot[d] = (nsteps - 1) * kb * e_b  # the dead step's first slot
        slot[d, :len(edge_slot)] = edge_slot.numpy()
    return StackedGatherTables(ctr=ctr, rows=rows, cols=cols, vals=vals,
                               s2e=s2e, slot=slot, n_rows=n_rows,
                               n_cols=n_cols, rb=rb)


@dataclasses.dataclass
class DistAttnShard:
    """A rank's view: the rectangular local :class:`GatherAttn` plus its
    halo send table. Carries ``.attn``, so :class:`DistGATNetwork`'s
    forward takes the fused path."""

    attn: GatherAttn
    send_idx: torch.Tensor  # [D * h_pad] int64 local rows sent to each rank
    n_local: int
    mesh: Mesh


@dataclasses.dataclass
class DistGatherAttn:
    """Host container: every shard's attention tables, leading axis the
    device; ``local(mesh)`` builds a rank's :class:`DistAttnShard`."""

    send_idx: np.ndarray          # [D(owner), D(dest), h_pad] int32
    fwd: StackedGatherTables      # [n_local × n_cat] dest-stripe tables
    bwd: StackedGatherTables      # the transpose: [n_cat × n_local]
    rows_e: np.ndarray            # [D, e_pad] int32 local dest row per edge
    cols_e: np.ndarray            # [D, e_pad] int32 concat-space source col
    n_local: int
    n_cat: int
    h_pad: int
    e_pad: int
    tile: int = GATHER_TILE
    e_b: int = 128
    kb: int = 8

    def local(self, mesh: Mesh) -> DistAttnShard:
        r, device = mesh.rank, mesh.device
        fwd = self.fwd.local(r, self.tile, self.e_b, self.kb, device)
        bwd = self.bwd.local(r, self.tile, self.e_b, self.kb, device)
        sms = (torch.cuda.get_device_properties(device).multi_processor_count
               if device.type == "cuda" else _SMS)

        def dev(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        ga = GatherAttn(
            fwd=fwd, bwd=bwd, rows=dev(self.rows_e[r], torch.int64),
            cols=dev(self.cols_e[r], torch.int64),
            slot_fwd=dev(self.fwd.slot[r]), slot_bwd=dev(self.bwd.slot[r]),
            slot2edge_fwd=dev(self.fwd.s2e[r]),
            slot2edge_bwd=dev(self.bwd.s2e[r]),
            items_fwd=combine_items(fwd, sms),
            items_bwd=combine_items(bwd, sms),
            n=self.n_local, num_edges=self.e_pad, n_src=self.n_cat)
        return DistAttnShard(
            attn=ga, send_idx=dev(self.send_idx[r].reshape(-1), torch.int64),
            n_local=self.n_local, mesh=mesh)


def shard_attention_gather(support, num_shards: int,
                           tile: int = GATHER_TILE, e_b: int = 128,
                           kb: int = 8) -> Tuple[DistGatherAttn, int]:
    """Row-partition the (self-looped) attention support into dest-stripe
    shards with halo-exchange tables (host precompute). Any stored entry
    is an edge (:func:`~h2gcn_tpu_torch.sparse.attention_gather.
    build_gatherattn`'s mask). Returns ``(payload, n_pad)``."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(support)
    if csr.shape[1] != csr.shape[0]:
        raise ValueError("attention support must be square")
    D = num_shards
    blocks, needed, n_local, n_pad, h_pad = _halo_partition(csr, D)
    n_cat = n_local + D * h_pad

    gas = []
    for d, block in enumerate(blocks):
        src = block.col // n_local
        remapped = np.where(src == d, block.col - d * n_local,
                            0).astype(np.int64)
        for s in range(D):
            sel = src == s
            if s == d or not sel.any():
                continue
            remapped[sel] = (n_local + s * h_pad
                             + np.searchsorted(needed[d][s], block.col[sel]))
        local = sp.csr_matrix(
            (np.ones(block.nnz, np.float32), (block.row, remapped)),
            shape=(n_local, n_cat))
        local.sum_duplicates()
        gas.append(build_gatherattn(local, tile=tile, e_b=e_b, kb=kb))

    e_pad = max(int(math.ceil(max(ga.num_edges for ga in gas) / 8)) * 8, 8)
    rows_e = np.zeros((D, e_pad), np.int32)
    cols_e = np.zeros((D, e_pad), np.int32)
    for d, ga in enumerate(gas):
        E = int(ga.num_edges)
        rows_e[d, :E] = ga.rows.numpy()
        cols_e[d, :E] = ga.cols.numpy()
    return DistGatherAttn(
        send_idx=_send_table(needed, n_local, h_pad),
        fwd=_pack_shard_tables(gas, "fwd", n_local, n_cat, e_pad, kb, e_b),
        bwd=_pack_shard_tables(gas, "bwd", n_cat, n_local, e_pad, kb, e_b),
        rows_e=rows_e, cols_e=cols_e, n_local=n_local, n_cat=n_cat,
        h_pad=h_pad, e_pad=e_pad, tile=tile, e_b=e_b, kb=kb,     ), n_pad


def halo_concat(shard: DistAttnShard, payload: torch.Tensor) -> torch.Tensor:
    """Boundary exchange: local payload rows -> ``[n_cat, W]``: the rank's
    own rows, then row ``s·h_pad + pos`` the ``pos``-th row rank ``s``
    sends it, the layout its remapped columns index. Differentiable: the
    backward exchange routes the halo rows' gradients to their owners."""
    recv = _collectives.all_to_all(payload[shard.send_idx], shard.mesh)
    return torch.cat([payload, recv], dim=0)


class DistGATNetwork(GATNetwork):
    """A :class:`~h2gcn_tpu_torch.models.GAT.GATNetwork` whose fused layers
    run dest-stripe-sharded attention: ``x`` is this rank's rows, and each
    layer exchanges only the boundary rows of the projected ``[f2 | h]``
    before one rectangular attention call. Same parameters, same math as
    the single-device gather payload."""

    def __init__(self, *a, **kw):
        kw["fused_attention"] = True  # the distributed path IS the fused one
        super().__init__(*a, **kw)

    @classmethod
    def from_single(cls, model: GATNetwork) -> "DistGATNetwork":
        """A distributed twin of a configured single-device model that
        shares its parameters (the same tensors: an optimizer over
        ``model.parameters()`` steps both)."""
        twin = cls(model.num_classes, hid_units=model.hid_units,
                   n_heads=model.n_heads, in_drop=model.in_drop,
                   attn_drop=model.attn_drop, residual=model.residual,
                   l2_coef=model.l2_coef,
                   fused_precision=model.fused_precision)
        twin.layers = model.layers
        return twin

    def _fused_layer(self, heads, x, adj, *, training, generator,
                     residual=False, capture_alpha=None):
        if capture_alpha is not None:
            raise NotImplementedError(
                "attention-coefficient capture is single-device only "
                "(run without --mesh_shards)")
        h_parts, f1_parts, f2_parts, xd_parts = [], [], [], []
        for p in heads:
            # the dropout structure of the single-device fused layer
            xd = dropout(x, self.in_drop, generator, training=training)
            xd_parts.append(xd)
            hk, f1, f2 = self._logits(p, xd)
            f1_parts.append(f1)
            f2_parts.append(f2)
            h_parts.append(dropout(hk, self.in_drop, generator,
                                   training=training))
        feat = h_parts[0].shape[1]
        nh = len(heads)
        f1s = torch.stack(f1_parts, dim=1)  # [n_local, H]: stays local
        # ONE exchange carries both the source factor f2 and the projected
        # features h of the boundary rows
        cat = halo_concat(adj, torch.cat([torch.stack(f2_parts, dim=1),
                                          torch.cat(h_parts, dim=1)], dim=1))
        out = gat_attention_gather(
            adj.attn, f1s, cat[:, :nh], cat[:, nh:], num_heads=nh,
            feat=feat, n_out=adj.n_local, precision=self.fused_precision,
            attn_drop=self.attn_drop if training else 0.0,
            generator=generator)
        outs = []
        for k, p in enumerate(heads):
            o = out[:, k * feat:(k + 1) * feat] + p["bias"]
            if residual:
                o = self._residual(p, xd_parts[k], o)
            outs.append(o)
        return outs

    def get_embeddings(self, adj, x, adjhops=()):
        h = x
        n_layers = len(self.layers)
        for li, heads in enumerate(self.layers[:-1]):
            outs = self._fused_layer(
                heads, h, adj, training=False, generator=None,
                residual=self.residual and li < n_layers - 1)
            h = torch.cat([torch.nn.functional.elu(o) for o in outs], dim=1)
        return h
