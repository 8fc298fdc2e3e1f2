#!/usr/bin/env python3
"""On-card end-to-end gate of the PyTorch/CUDA port (h2gcn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc; exits non-zero without them, before it prints
anything. Run it after ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py``, which holds every kernel against its
plain version at each kernel's edge cases; this script holds them on the
payloads the program trains on, then drives the CLI and the runtime's
other entry points on the card. It

1. prints the card's name and power limit (nvidia-smi), builds the CUDA
   kernels from ``h2gcn_tpu_torch/csrc`` with nvcc, and fails unless the
   native host library (exact-hop split, RCM order) loads: the host path
   would otherwise be scipy's;
2. (``holds``) holds every kernel against its plain version on the same
   inputs, each call's launches counted, at TOL (the COO-chunk passes'
   bf16 mode at BF16_TOL): #1-#3 on the 10K graph's Â₁, Â₂ and RW Â₁ and
   at the baselines' widths on their supports, forward and backward; #4-#10
   on the self-looped 10K and Cora-shaped supports; #3 and #10 on the
   D = 4 shards of the distributed routes; #3 on the 250K graph's
   cluster-ordered Â₁ and Â₂. A line a case with its error, tolerance and
   launches;
3. (``cli``) trains H2GCN-2 through the CLI
   (``h2gcn_tpu_torch.run_experiments.main``) on bench.py's 10K-node
   synthetic graph written as planetoid files, with ``--sparse_backend
   gscatter`` and ``bsr``;
4. (``gat_cli``) trains GAT (Cora's published configuration) on a
   Cora-shaped graph (2,708 nodes, 5,429 edges) with ``--fused_attention
   --attn_drop 0`` (training and eval launch the three BSR attention
   kernels) and with the published ``--attn_drop 0.6`` (training takes the
   segment path, eval launches the forward kernel);
5. (``gat_scale_cli``) trains GAT on the 10K graph, past the BSR budget:
   ``auto`` with ``--attn_drop 0.6`` and ``0`` (the gather payload, trained
   fused) and ``--attn_impl coo --attn_drop 0``;
6. (``cootile_cli``) trains H2GCN-2 with ``--sparse_backend cootile`` on
   the 10K graph, and on the 250K-node graph of the JAX package's
   bench_large.py with ``--reorder cluster --sparse_features`` (its logits
   mapped back to the original node order and held against the
   un-reordered graph);
7. (``baselines_cli``) trains each baseline at its published width on the
   Cora-shaped graph (1,433 features): GCN's ``gcn`` through gscatter, BSR
   and COO-tile, ``cheby``, ``concat2``, ``cheby_concat2``, ``bp`` and
   ``mlp``; MixHop through gscatter and BSR; GraphSAGE sampled (5, 5) and
   full-neighbor (0, 0); H2GCN's setup without graph layers; and GCN on
   the 10K graph. MixHop also writes ``architecture.json``;
8. (``paths``) drives the runtime's entry points beyond a training run:
   blocked epochs (``--epochs_per_block 5``) against per-epoch ones through
   gscatter and cootile (every epoch's stats, the best epoch, its
   parameters and Adam counts; a steady block syncs only at its
   readback); a recorded run (``--use_signac --save_activations
   --deg_acc_monitor``, cluster-ordered) whose ``results.json`` and stored
   arrays are checked in the original node order, then ``python -m
   h2gcn_tpu_torch.predict`` from its checkpoint; a network setup with
   every new DSL kind (``DSL_SETUP``) and its ``embed_step``; GAT's
   ``attn_step`` through the gather payload; and the GeomGCN (squirrel's
   size) and SparseGraph loaders on files written here from a seed;
9. (``experiments``) drives ``python -m h2gcn_tpu_torch.experiments`` at
   the published syn-products config cut to two graphs (h = 0.0 and 0.9)
   and split index 0, in a project under ``chiprun_out/experiments``:
   init and generate, a sweep of 8 children on the card, a second sweep
   that spawns none, summarize, one child through cootile with
   ``--precompute_workers 4``, a child's stored logits against an
   in-process run of its argv, and the exact-hop split at 4 host workers
   against 1 at 10K and 250K nodes;
10. (``distributed``) the distributed runtime on this card at world size
    1 over NCCL: the dry run in its five modes, then H2GCN-2 through the
    CLI in each ``--halo_mode`` and GAT at Cora's widths, each against the
    one-device run on the same route; last, ``--mesh_shards`` one past the
    card count fails before it spawns.

Each training run is EPOCHS epochs unless its step says otherwise, and is
checked for its route, its kernels' launches (none where it aggregates
through no kernel), finite losses, a checkpoint, and its trained logits
within TOL of the same weights through the segment path (``index_add_``).
Each phase ends with a line ``{"phase": ..., "s": ...}``; the last line is
``{"ok": true, "device": ...}``. Any failure raises.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4  # max |kernel - plain| <= TOL * max(1, max |plain|)
EPOCHS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_graph(n=10_000, m_edges=60_000, seed=0, skew=0.6):
    """bench.py's synthetic graph: preferential-attachment-flavored
    endpoints (node i drawn with weight (i + 1) ** -skew; skew 0 draws
    them uniformly), symmetric, binary, no self loops."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 1.0) ** -skew
    w /= w.sum()
    src = rng.choice(n, size=m_edges, p=w)
    dst = rng.choice(n, size=m_edges, p=w)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    r = np.concatenate([src, dst])
    c = np.concatenate([dst, src])
    A = sp.csr_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))
    A.sum_duplicates()
    A.data[:] = 1.0
    return A


def write_planetoid(path, name, adj, seed=0, n_feat=1433, feats_per_row=18,
                    n_classes=7, train_per_class=20, n_test=1000):
    """Write ``adj`` as planetoid pickles ``ind.<name>.*`` with sparse binary
    features, random classes, ``train_per_class`` training nodes per class
    (the first nodes) and the last ``n_test`` nodes as the test set."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = adj.shape[0]
    n_train = train_per_class * n_classes
    labels = rng.integers(0, n_classes, n)
    labels[:n_train] = rng.permutation(np.repeat(np.arange(n_classes),
                                                 train_per_class))
    onehot = np.eye(n_classes, dtype=np.float64)[labels]
    cols = rng.integers(0, n_feat, (n, feats_per_row))
    feats = sp.csr_matrix(
        (np.ones(cols.size, np.float32),
         (np.repeat(np.arange(n), feats_per_row), cols.ravel())),
        shape=(n, n_feat))
    feats.data[:] = 1.0
    n_allx = n - n_test
    test_idx = rng.permutation(np.arange(n_allx, n))
    csr = adj.tocsr()
    graph = {i: csr.indices[csr.indptr[i]:csr.indptr[i + 1]].tolist()
             for i in range(n)}
    objects = {
        "x": feats[:n_train], "y": onehot[:n_train],
        "allx": feats[:n_allx], "ally": onehot[:n_allx],
        "tx": feats[test_idx], "ty": onehot[test_idx],
        "graph": graph,
    }
    os.makedirs(path, exist_ok=True)
    for key, obj in objects.items():
        with open(os.path.join(path, f"ind.{name}.{key}"), "wb") as f:
            pickle.dump(obj, f)
    with open(os.path.join(path, f"ind.{name}.test.index"), "w") as f:
        f.write("\n".join(str(i) for i in test_idx) + "\n")


def scale_graph():
    """The JAX package's at-scale graph (bench_large.py's defaults): 250,000
    nodes, 400,000 drawn edges; 799,540 adjacency entries and 24,999,792 in
    its exact-2-hop matrix."""
    return build_graph(n=250_000, m_edges=400_000, seed=0)


def cora_graph(seed=1, skew=0.6):
    """A Cora-shaped graph: 2,708 nodes, 5,429 undirected edges drawn as
    build_graph draws them."""
    return build_graph(n=2708, m_edges=5429, seed=seed, skew=skew)


def self_looped(adj):
    import scipy.sparse as sp

    return ((adj + sp.eye(adj.shape[0])) > 0).astype(np.float32).tocsr()


# --------------------------------------------------------------------------
# One CLI run and its checks
# --------------------------------------------------------------------------

# the SpMM kernels' launch counters
_SPMM_WRAPPERS = ("gscatter_spmm", "bsr_spmm", "cootile_spmm")


def _launch_counts(wrappers):
    """Each named kernel wrapper's launches so far in this process (the
    program's ``launches.<wrapper>`` counters)."""
    from h2gcn_tpu_torch import tracing

    return {k: tracing.counter("launches." + k) for k in wrappers}


def _launched_since(before):
    """The launches of each wrapper of ``before`` since it was taken."""
    return {k: v - before[k] for k, v in _launch_counts(before).items()}


def _cli(argv, counters=_SPMM_WRAPPERS):
    """One run of ``run_experiments.main(argv)``: (args, the launches of
    each wrapper of ``counters`` in the run)."""
    import gc

    import torch

    from h2gcn_tpu_torch import run_experiments

    gc.collect()  # earlier runs' training state (reference cycles)
    torch.cuda.empty_cache()
    before = _launch_counts(counters)
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    return args, _launched_since(before)


def _gate(tag, what, got, ref):
    """max |got - ref| <= TOL * max(1, max |ref|); returns (err, tol)."""
    err = float((got - ref).abs().max())
    tol = TOL * max(1.0, float(ref.abs().max()))
    if not err <= tol:
        raise AssertionError(f"{tag}: {what} differ by {err} > {tol}")
    return err, tol


def _finite(tag, stats):
    for key in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(float(stats[key])):
            raise AssertionError(f"{tag}: {key} = {float(stats[key])}")


def _trained(tag, args, ckpt_dir):
    """The run's last losses are finite and it wrote a checkpoint."""
    _finite(tag, args.objects["epoch_stats"])
    if not glob.glob(os.path.join(ckpt_dir, "*", "ckpt.pt")):
        raise AssertionError(f"{tag}: no checkpoint under {ckpt_dir}")


def _logit_gate(tag, args, logits, ref):
    """The trained logits are [n, classes] and finite, and (where ``ref``
    is given) within the gate of ``ref``; returns (err, tol)."""
    import torch

    n, n_classes = args.objects["tensors"]["y_all"].shape
    if tuple(logits.shape) != (n, n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"{tag}: bad logits {tuple(logits.shape)}")
    if ref is None:
        return None, None
    return _gate(tag, "logits through the kernels and the segment path",
                 logits, ref)


def _segment_tensors(tensors, device):
    """The run's tensors with every matrix the model aggregates over on the
    ``segment`` path (index_add_), for the logit gate."""
    import dataclasses

    from h2gcn_tpu_torch.sparse import SparseMatrix

    def seg(m):
        return (None if m is None else SparseMatrix.from_scipy(
            m.to_scipy(), backend="segment", device=device))

    ref = dict(tensors)
    hops = tensors.get("adj_hops")
    if isinstance(hops, list):
        ref["adj_hops"] = [seg(h) for h in hops]
    adj = tensors["adj"]
    if hasattr(adj, "mean_adj"):  # GraphSAGE's ELL graph
        ref["adj"] = dataclasses.replace(adj, mean_adj=seg(adj.mean_adj),
                                         mean_adj_gcn=seg(adj.mean_adj_gcn))
    return ref


def _segment_logits(args, device):
    """The trained model's logits with every hop matrix on the segment
    path (index_add_), beside its logits through the run's kernels."""
    import torch

    tensors = args.objects["tensors"]
    with torch.no_grad():
        logits = args.objects["predict_step"](**tensors)
        ref_t = _segment_tensors(tensors, device)
        ref = args.objects["model"](ref_t["adj"], ref_t["features"],
                                    ref_t["adj_hops"])
    return logits, ref


# --------------------------------------------------------------------------
# Phase holds: each kernel against its plain version on the same inputs
# --------------------------------------------------------------------------

BF16_TOL = 3e-2  # the COO-chunk passes in "default": bf16 contraction operands
GAT_WIDTHS = ((8, 8), (1, 7))  # (heads, features a head) of GAT's layers
DIST_SHARDS = 4  # the shards of the distributed routes' payloads


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _hold(wrapper, case, run, plain, rel=TOL):
    """``run()``, which must launch ``wrapper``, against ``plain()`` on the
    same inputs: each output finite and of the plain one's shape, equal
    where the plain one holds the sentinel row max, and elsewhere within
    ``rel`` * max(1, max |plain|). Emits the case's line; raises if not."""
    import torch

    from h2gcn_tpu_torch.sparse.attention import NEG_INF

    before = _launch_counts((wrapper,))
    got = _tuple(run())
    torch.cuda.synchronize()
    line = {"hold": wrapper, "case": case,
            "launches": _launched_since(before)[wrapper],
            "max_abs_err": [], "tol": []}
    for a, b in zip(got, _tuple(plain()), strict=True):
        live = b > NEG_INF / 2
        if (a.shape != b.shape or not torch.isfinite(a).all()
                or not torch.equal(a[~live], b[~live])):
            raise AssertionError(f"{wrapper} {case}: bad output "
                                 f"{tuple(a.shape)}")
        line["max_abs_err"].append(
            float((a[live] - b[live]).abs().max()) if live.any() else 0.0)
        line["tol"].append(rel * max(1.0, float(b[live].abs().max())
                                     if live.any() else 0.0))
    emit(line)
    if line["launches"] == 0:
        raise AssertionError(f"{wrapper} {case}: the kernel was never "
                             f"launched")
    if not all(e <= t for e, t in zip(line["max_abs_err"], line["tol"])):
        raise AssertionError(f"{wrapper} {case} disagrees with its plain "
                             f"version: {line}")


def _spmm_plain(sm, x):
    """The plain version of the kernel ``spmm`` launches on ``sm``."""
    from h2gcn_tpu_torch.sparse.bsr_spmm import bsr_spmm_plain
    from h2gcn_tpu_torch.sparse.cootile import cootile_spmm_plain
    from h2gcn_tpu_torch.sparse.gscatter import gscatter_rows_plain

    if sm.backend == "gscatter":
        return gscatter_rows_plain(sm.gsc, x, precision=sm.precision)
    if sm.backend == "bsr":
        return bsr_spmm_plain(sm.bsr, x, n_out=sm.shape[0],
                              precision=sm.precision)
    return cootile_spmm_plain(sm.coot, x, precision=sm.precision)


def hold_spmm(mname, mat, backends, widths, precisions, device, gen):
    """#1-#3 (``backends``) on ``mat`` through ``spmm``: the forward and
    the autograd backward (the transpose view's payload) against the plain
    version at each width and precision."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix, spmm

    n, m = mat.shape
    for backend in backends:
        for precision in precisions:
            sm = SparseMatrix.from_scipy(mat, backend=backend,
                                         precision=precision, device=device)
            for F in widths:
                case = f"{mname} F={F} {precision}"
                x = torch.randn(m, F, generator=gen, device=device)
                g = torch.randn(n, F, generator=gen, device=device)
                _hold(f"{backend}_spmm", case + " forward",
                      lambda: spmm(sm, x), lambda: _spmm_plain(sm, x))
                xr = x.clone().requires_grad_(True)
                y = spmm(sm, xr)
                _hold(f"{backend}_spmm", case + " backward",
                      lambda: torch.autograd.grad(y, xr, g)[0],
                      lambda: _spmm_plain(sm.transpose_view(), g))
            del sm
            torch.cuda.empty_cache()


def hold_combines(ga, case, f1, f2, h, H, F, gen):
    """#10 in the four combines of a training step on ``ga``'s tables (the
    forward, and the backward's dh, df1 and df2) on edge weights from
    ``f1`` and ``f2`` under a dropout mask, against its plain version."""
    import torch

    from h2gcn_tpu_torch.sparse import attention_gather as gat

    device = f1.device
    s_, p, live = gat._edge_terms(ga, f1, f2, 0.2)
    mask = torch.where(torch.rand(p.shape, generator=gen, device=device)
                       < 0.4, 2.5, 0.0)
    q = torch.where(s_ >= 0, 1.0, 0.2) * torch.where(live, p, 0.0)
    pm, qm = (p * mask).contiguous(), (q * mask).contiguous()
    g = torch.randn(f1.shape[0], H * F, generator=gen, device=device)
    gl = torch.randn(f1.shape[0], H, generator=gen, device=device)
    hx = gat._augx(h, torch.ones(h.shape[0], H, device=device), H, F)
    for cname, fwd, wf, x, wl in (
            ("forward", True, pm, hx, p), ("dh", False, pm, g, None),
            ("df1", True, qm, hx, q),
            ("df2", False, qm, gat._augx(g, gl, H, F), q)):
        gs, s2e, items = ((ga.fwd, ga.slot2edge_fwd, ga.items_fwd) if fwd
                          else (ga.bwd, ga.slot2edge_bwd, ga.items_bwd))
        _hold("gscatter_weighted", f"{case} {cname}",
              lambda: gat.gscatter_weighted(gs, s2e, wf, x, num_heads=H,
                                            wl=wl, items=items),
              lambda: gat.gscatter_weighted_plain(gs, s2e, wf, x,
                                                  num_heads=H, wl=wl))


def hold_attention(gname, support, device, gen):
    """GAT's passes on ``support`` at both layers' widths: #4-#6 on its
    256-block BSR mask, #7-#9 on its COO chunks (also in "default", at
    BF16_TOL against the f32 plain version), #10 on its gather tables."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix
    from h2gcn_tpu_torch.sparse import attention as att
    from h2gcn_tpu_torch.sparse import attention_coo as coo
    from h2gcn_tpu_torch.sparse import attention_gather as gat

    n = support.shape[0]
    bsr = SparseMatrix.from_scipy(support, backend="bsr", block_size=256,
                                  device=device).bsr
    ac = coo.build_attn_coo(support, device=device)
    ga = gat.build_gatherattn(support, device=device)
    for H, F in GAT_WIDTHS:
        case, kw = f"{gname} H={H} F={F}", dict(num_heads=H, feat=F)
        f1, f2 = (torch.randn(n, H, generator=gen, device=device)
                  for _ in range(2))
        h, g = (torch.randn(n, H * F, generator=gen, device=device)
                for _ in range(2))
        for prefix, mod, payload, n_pad, precisions in (
                ("gat", att, bsr, bsr.n_row_blocks * bsr.block_size, ({},)),
                ("coo", coo, ac, ac.n_tiles * ac.tile,
                 ({}, {"precision": "default"}))):
            f1p, f2p, hp, gp = (att.pad_rows(t, n_pad) for t in (f1, f2, h, g))
            # the stats and D of the plain forward feed both backward passes
            out0, m0, l0 = getattr(mod, prefix + "_fwd_stats_plain")(
                payload, f1p, f2p, hp, **kw)
            d = att.head_dots(gp, out0, H, F)
            bwd = (payload, f1p, f2p, hp, gp, m0, l0, d)
            for pk in precisions:
                for name, a in (("fwd_stats", bwd[:4]), ("bwd_row", bwd),
                                ("bwd_col", bwd)):
                    kernel = f"{prefix}_{name}"
                    _hold(kernel, " ".join([case, *pk.values()]),
                          lambda: getattr(mod, kernel)(*a, **kw, **pk),
                          lambda: getattr(mod, kernel + "_plain")(*a, **kw),
                          BF16_TOL if pk else TOL)
        hold_combines(ga, case, f1, f2, h, H, F, gen)


def hold_dist(mats, support, device, gen):
    """The payloads of the distributed routes' D = 4 shards: #3 on each
    halo-cootile shard's interior and halo of ``mats`` at F = 64 and 128,
    forward and transpose, and #10 on each dest-stripe GAT shard of
    ``support`` at GAT's first layer."""
    import torch

    from h2gcn_tpu_torch.parallel import attention as pattn
    from h2gcn_tpu_torch.parallel import dist as pdist
    from h2gcn_tpu_torch.parallel.mesh import Mesh
    from h2gcn_tpu_torch.sparse.cootile import cootile_spmm, cootile_spmm_plain

    D = DIST_SHARDS
    for mname, mat in mats.items():
        hcm, _ = pdist.shard_matrix_halo_cootile(mat, D)
        for d in range(D):
            sh = hcm.local(Mesh(rank=d, size=D, device=device))
            for part, sm in (("interior", sh.interior),
                             ("halo", sh.halo_mat)):
                for F in (64, 128):
                    for way, t in (("", sm), (" transpose",
                                              sm.transpose_view())):
                        x = torch.randn(t.shape[1], F, generator=gen,
                                        device=device)
                        _hold("cootile_spmm",
                              f"{mname} shard {d} {part} F={F}{way}",
                              lambda: cootile_spmm(t.coot, x),
                              lambda: cootile_spmm_plain(t.coot, x))
    dga, _ = pattn.shard_attention_gather(support, D)
    H, F = GAT_WIDTHS[0]
    for d in range(D):
        ga = dga.local(Mesh(rank=d, size=D, device=device)).attn
        f1 = torch.randn(dga.n_local, H, generator=gen, device=device)
        f2 = torch.randn(dga.n_cat, H, generator=gen, device=device)
        h = torch.randn(dga.n_cat, H * F, generator=gen, device=device)
        hold_combines(ga, f"dist shard {d} H={H} F={F}", f1, f2, h, H, F,
                      gen)


def check_holds(device):
    """Phase ``holds``: every kernel against its plain version on the
    payloads the CLI phases train on. #1-#3 on the 10K graph's Â₁, Â₂ and
    RW Â₁ at F = 64 and 128 in both precisions, and at the baselines'
    widths on their supports (sym_norm(A+I) and D⁻¹A of the 10K graph, the
    Cora-shaped graph's Chebyshev T_3 with negative values and explicit
    zeros); #4-#10 on the self-looped 10K and Cora-shaped supports; the
    distributed routes' shards of the 10K graph; #3 on the 250K graph's
    cluster-ordered Â₁ and Â₂ at F = 64 and 128 in both precisions."""
    import scipy.sparse as sp
    import torch

    from h2gcn_tpu_torch.sparse import transforms as tt

    gen = torch.Generator(device=device).manual_seed(0)
    both = ("highest", "default")
    adj = build_graph()
    split = tt.nhood_split(adj, 2)
    mats = {"A1": tt.normalize(split[1]).tocsr(),
            "A2": tt.normalize(split[2]).tocsr(),
            "A1_rw": tt.normalize(split[1], tt.NType.RW_NORMALIZED).tocsr()}
    for mname, mat in mats.items():
        hold_spmm(mname, mat, ("gscatter", "bsr", "cootile"), (64, 128),
                  both, device, gen)
    t3 = tt.chebyshev_polynomials(cora_graph(), 3, eigenvalue=2)[3]
    for mname, mat, widths in (
            ("A_self_looped", tt.normalize(tt.add_eye(adj)).tocsr(),
             (7, 16, 1433)),
            ("A_rw", tt.normalize(adj, tt.NType.RW_NORMALIZED).tocsr(),
             (7, 128, 1433)),
            ("T3_cora", sp.csr_matrix(t3, dtype=np.float32), (16,))):
        hold_spmm(mname, mat, ("gscatter", "bsr", "cootile"), widths,
                  ("highest",), device, gen)
    support = self_looped(adj)
    hold_attention("syn10k", support, device, gen)
    hold_attention("cora_shaped", self_looped(cora_graph()), device, gen)
    hold_dist({k: mats[k] for k in ("A1", "A2")}, support, device, gen)
    split = tt.nhood_split(scale_graph(), 2)
    a1, a2 = (tt.normalize(split[k]).tocsr() for k in (1, 2))
    del split
    perm = tt.cluster_order(abs(a1) + abs(a2))
    for mname, mat in (("A1c_250k", a1), ("A2c_250k", a2)):
        hold_spmm(mname, tt.permute_graph(mat, perm), ("cootile",),
                  (64, 128), both, device, gen)


# --------------------------------------------------------------------------
# Phases cli, cootile_cli: H2GCN-2 through each SpMM kernel
# --------------------------------------------------------------------------

def run_cli(backend, data_dir, name, device, extra=()):
    """H2GCN-2 for EPOCHS epochs through the CLI with ``--sparse_backend
    backend`` and the ``extra`` flags."""
    import torch

    tag = " ".join([name, backend, *extra])
    ckpt_dir = os.path.join(data_dir, f"ckpt_{name}_{backend}")
    args, launches = _cli(
        ["H2GCN", "planetoid", "--dataset", f"ind.{name}", "--dataset_path",
         data_dir, "--sparse_backend", backend, "--epochs", str(EPOCHS),
         "--timing", "--random_seed", "123", "--checkpoint_dir", ckpt_dir,
         *extra])
    kernel = f"{backend}_spmm"
    if launches[kernel] == 0:
        raise AssertionError(f"{tag}: {kernel} was never launched")
    _trained(tag, args, ckpt_dir)

    # the trained weights through the kernels and through index_add_; a
    # reordered run's logits go back to the original node order and meet
    # the un-reordered graph
    tensors = args.objects["tensors"]
    with torch.no_grad():
        logits = args.objects["original_order"](
            args.objects["predict_step"](**tensors))
        if "node_perm" in tensors:
            ref_t = vars(args.objects["dataset"].get_tensors(
                get_adj_norm_hops=args.adj_nhood, backend="segment",
                sparse_features=args.sparse_features, device=device))
        else:
            ref_t = _segment_tensors(tensors, device)
        ref = args.objects["model"](ref_t["adj"], ref_t["features"],
                                    ref_t["adj_hops"])
        del ref_t
    logit_err, logit_tol = _logit_gate(tag, args, logits, ref)
    stats = args.objects["epoch_stats"]
    emit({"cli": backend, "graph": name, "flags": list(extra),
          "n": int(tensors["y_all"].shape[0]),
          "hop_nnz": [h.nnz for h in tensors["adj_hops"]],
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches, "logit_err": logit_err,
          "logit_tol": logit_tol})


def check_cli(data_dir, device):
    """Phase ``cli``: H2GCN-2 on the 10K graph through gscatter and BSR."""
    write_planetoid(data_dir, "syn10k", build_graph())
    for backend in ("gscatter", "bsr"):
        run_cli(backend, data_dir, "syn10k", device)


def check_cootile_cli(data_dir, device):
    """Phase ``cootile_cli``: H2GCN-2 through COO-tile on the 10K graph,
    then on the 250K graph cluster-ordered with sparse features."""
    run_cli("cootile", data_dir, "syn10k", device)
    write_planetoid(data_dir, "syn250k", scale_graph())
    run_cli("cootile", data_dir, "syn250k", device,
            extra=("--reorder", "cluster", "--sparse_features"))


# --------------------------------------------------------------------------
# Phases gat_cli, gat_scale_cli: GAT through each attention payload
# --------------------------------------------------------------------------

# the attention kernels' launch counters by route
_GAT_ROUTES = {
    "bsr": ("gat_fwd_stats", "gat_bwd_row", "gat_bwd_col"),
    "coo": ("coo_fwd_stats", "coo_bwd_row", "coo_bwd_col"),
    "gather": ("gscatter_weighted",),
}


def run_gat_cli(data_dir, name, device, attn_drop, route="bsr",
                attn_impl=None):
    """GAT for EPOCHS epochs through the CLI with ``--fused_attention``
    (and ``--attn_impl``), expecting the ``route`` payload."""
    import torch

    from h2gcn_tpu_torch.sparse import attention_coo as coo
    from h2gcn_tpu_torch.sparse import attention_gather as gat

    run = f"{name}_{attn_impl or 'auto'}_{attn_drop}"
    tag = f"GAT {run}"
    ckpt_dir = os.path.join(data_dir, f"ckpt_gat_{run}")
    argv = ["GAT", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--fused_attention",
            "--attn_drop", str(attn_drop), "--epochs", str(EPOCHS),
            "--timing", "--random_seed", "123", "--checkpoint_dir", ckpt_dir]
    if attn_impl:
        argv += ["--attn_impl", attn_impl]
    args, launches = _cli(
        argv, [k for names in _GAT_ROUTES.values() for k in names])
    adj = args.objects["tensors"]["adj"]
    payload = {"bsr": adj.bsr is not None,
               "coo": isinstance(adj.attn, coo.AttnCoo),
               "gather": isinstance(adj.attn, gat.GatherAttn)}
    if not payload[route]:
        raise AssertionError(f"{tag}: the support took no {route} "
                             f"payload (backend {adj.backend})")
    for kernel, count in launches.items():
        if route == "bsr":
            # attention dropout needs per-edge alpha: training then takes
            # the segment path, and only the evaluations run the forward
            want = kernel in _GAT_ROUTES["bsr"] and (
                attn_drop == 0 or kernel == "gat_fwd_stats")
        else:
            want = kernel in _GAT_ROUTES[route]
        if (count > 0) != want:
            raise AssertionError(f"{tag}: {kernel} launched {count} times")
    if route == "gather" and launches["gscatter_weighted"] < 8 * EPOCHS:
        # training runs fused: a forward and three backward combines a
        # layer and step
        raise AssertionError(f"{tag}: the combine launched only "
                             f"{launches['gscatter_weighted']} times")
    _trained(tag, args, ckpt_dir)

    # the trained weights through the kernels and through the segment path
    tensors = args.objects["tensors"]
    model = args.objects["model"]
    with torch.no_grad():
        logits = args.objects["predict_step"](**tensors)
        model.fused_attention = False
        ref = model(tensors["adj"], tensors["features"], [])
        model.fused_attention = True
    logit_err, logit_tol = _logit_gate(tag, args, logits, ref)
    stats = args.objects["epoch_stats"]
    emit({"cli": "GAT", "graph": name, "route": route,
          "attn_impl": attn_impl or "auto", "attn_drop": attn_drop,
          "support_nnz": tensors["adj"].nnz,
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches, "logit_err": logit_err,
          "logit_tol": logit_tol})


def check_gat_cli(data_dir, device):
    """Phase ``gat_cli``: GAT on the Cora-shaped graph, BSR payload."""
    write_planetoid(data_dir, "syncora", cora_graph())
    run_gat_cli(data_dir, "syncora", device, 0)
    run_gat_cli(data_dir, "syncora", device, 0.6)


def check_gat_scale_cli(data_dir, device):
    """Phase ``gat_scale_cli``: GAT on the 10K graph, past the BSR budget:
    ``auto`` takes the gather payload, which trains fused with the
    published attention dropout."""
    run_gat_cli(data_dir, "syn10k", device, 0.6, route="gather")
    run_gat_cli(data_dir, "syn10k", device, 0, route="gather")
    run_gat_cli(data_dir, "syn10k", device, 0, route="coo", attn_impl="coo")


# --------------------------------------------------------------------------
# Phase baselines_cli: the baselines at their published widths
# --------------------------------------------------------------------------

# (label, graph, model, --sparse_backend or None for the model's default,
# flags, the kernel its aggregations launch or None)
MIXHOP_CORA = ("--adj_pows", "0:24:0,1:18:7,2:18:7", "--hidden_dims_csv",
               "60", "--learn_rate", "0.5", "--l2reg", "5e-3")
BASELINE_RUNS = (
    ("gcn", "syncora", "GCN", "gscatter", ("--variant", "gcn"),
     "gscatter_spmm"),
    ("gcn", "syncora", "GCN", "bsr", ("--variant", "gcn"), "bsr_spmm"),
    ("gcn", "syncora", "GCN", "cootile", ("--variant", "gcn"),
     "cootile_spmm"),
    ("cheby", "syncora", "GCN", "gscatter",
     ("--variant", "cheby", "--max_degree", "3"), "gscatter_spmm"),
    ("concat2", "syncora", "GCN", "gscatter", ("--variant", "concat2"),
     "gscatter_spmm"),
    ("cheby_concat2", "syncora", "GCN", "gscatter",
     ("--variant", "cheby_concat2", "--max_degree", "3"), "gscatter_spmm"),
    ("bp", "syncora", "GCN", "gscatter",
     ("--variant", "bp", "--feature_configs", "labels"), "gscatter_spmm"),
    # two dense layers: no aggregation
    ("mlp", "syncora", "GCN", "gscatter", ("--variant", "mlp"), None),
    ("mixhop", "syncora", "MIXHOP", "gscatter", MIXHOP_CORA,
     "gscatter_spmm"),
    ("mixhop", "syncora", "MIXHOP", "bsr", MIXHOP_CORA, "bsr_spmm"),
    # the sampled mean gathers a random draw: no SpMM, no logit gate
    ("graphsage_sampled", "syncora", "GRAPHSAGE", None,
     ("--num_samples", "5", "5"), None),
    # the full-neighbor mean: D^-1 A through auto's CUDA route
    ("graphsage_full", "syncora", "GRAPHSAGE", None,
     ("--num_samples", "0", "0"), "gscatter_spmm"),
    # a setup without graph layers
    ("h2gcn_mlp", "syncora", "H2GCN", None,
     ("--network_setup", "M64-R-D0.5-MO"), None),
    ("gcn", "syn10k", "GCN", "gscatter", ("--variant", "gcn"),
     "gscatter_spmm"),
)


def run_baseline_cli(label, data_dir, name, device, model_name, backend,
                     flags, kernel):
    """One baseline for EPOCHS epochs through the CLI; checks its launches
    (``kernel`` launched, or no SpMM kernel at all where it is None),
    finite losses, a checkpoint, and (where ``kernel`` is set) the trained
    logits through the kernels against the segment path."""
    import torch

    route = backend or "auto"
    tag = f"{model_name} {label} {name} {route}"
    ckpt_dir = os.path.join(data_dir, f"ckpt_{label}_{name}_{route}")
    argv = [model_name, "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--epochs", str(EPOCHS), "--timing",
            "--random_seed", "123", "--checkpoint_dir", ckpt_dir, *flags]
    if backend:
        argv += ["--sparse_backend", backend]
    args, launches = _cli(argv)
    if kernel is None and any(launches.values()):
        raise AssertionError(f"{tag}: launched {launches}, expected none")
    if kernel is not None and launches[kernel] == 0:
        raise AssertionError(f"{tag}: {kernel} was never launched")
    _trained(tag, args, ckpt_dir)
    if model_name == "MIXHOP" and not os.path.exists(
            os.path.join(ckpt_dir, "architecture.json")):
        raise AssertionError(f"{tag}: no architecture.json")

    if kernel is None:
        with torch.no_grad():
            logits = args.objects["predict_step"](**args.objects["tensors"])
        ref = None
    else:
        logits, ref = _segment_logits(args, device)
    logit_err, logit_tol = _logit_gate(tag, args, logits, ref)
    stats = args.objects["epoch_stats"]
    hops = args.objects["tensors"].get("adj_hops")
    emit({"baselines_cli": label, "model": model_name, "graph": name,
          "route": route, "flags": list(flags),
          "n": int(logits.shape[0]),
          "support_nnz": ([h.nnz for h in hops] if isinstance(hops, list)
                          else None),
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches,
          "launches_per_epoch": {k: v / EPOCHS for k, v in launches.items()},
          "logit_err": logit_err, "logit_tol": logit_tol})


def check_baselines_cli(data_dir, device):
    """Phase ``baselines_cli``: every run of :data:`BASELINE_RUNS`."""
    for run in BASELINE_RUNS:
        run_baseline_cli(run[0], data_dir, run[1], device, *run[2:])


# --------------------------------------------------------------------------
# Phase paths: the runtime's entry points beyond a training run
# --------------------------------------------------------------------------

# the per-epoch stats the blocked and per-epoch runs are held to
_PATH_STATS = ("train_loss", "train_acc", "val_acc", "test_accuracy",
               "val_loss", "test_loss")
# H2GCN-2's full width with every new DSL kind; "scale" is the X layer
# the phase registers
DSL_SETUP = ("M64-E-R-T1-G-V-T2-G-V-C1-C2-[lambda x: jnp.tanh(x)]-SG-"
             "S_0_128-I-Xscale_2-D0.5-MO")
# squirrel's size in the Geom-GCN paper's dataset table
SQUIRREL = dict(n=5201, edges=198_493, n_feat=2089, n_classes=5)


class RecordedEpochs:
    """Records every epoch line the CLI prints (the per-epoch and blocked
    loops both print through ``EpochStatsPrinter``) as floats."""

    def __enter__(self):
        from h2gcn_tpu_torch.modules import logger

        self.epochs = []
        self._cls = logger.EpochStatsPrinter
        self._orig = self._cls.__call__
        orig, epochs = self._orig, self.epochs

        def record(printer, epoch, stats):
            epochs.append((epoch, {k: float(stats[k]) for k in _PATH_STATS}))
            orig(printer, epoch, stats)

        self._cls.__call__ = record
        return self

    def __exit__(self, *exc):
        self._cls.__call__ = self._orig


def paths_blocked(data_dir, name, backend):
    """H2GCN-2 per-epoch and with ``--epochs_per_block 5`` through
    ``backend``; per-epoch stats, the best epoch and the best parameters
    agree; then one more block of the blocked run under
    ``torch.cuda.set_sync_debug_mode("warn")`` counts its host syncs: only
    its one readback."""
    import torch

    tag = f"paths blocked {name} {backend}"
    base = ["H2GCN", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--sparse_backend", backend,
            "--epochs", "10", "--best_val_criteria", "val_loss",
            "--dropout", "0", "--timing", "--random_seed", "123"]
    runs = {}
    for mode, extra in (("per_epoch", []), ("blocked",
                                            ["--epochs_per_block", "5"])):
        with RecordedEpochs() as rec:
            args, launches = _cli(
                base + extra + ["--checkpoint_dir", os.path.join(
                    data_dir, f"ckpt_paths_{backend}_{mode}")])
        if launches[f"{backend}_spmm"] == 0:
            raise AssertionError(f"{tag} {mode}: {backend}_spmm never "
                                 "launched")
        runs[mode] = (args, launches, rec.epochs)
    (pa, la, ea), (ba, lb, eb) = runs["per_epoch"], runs["blocked"]
    if [e for e, _ in ea] != [e for e, _ in eb] or len(ea) != 10:
        raise AssertionError(f"{tag}: epochs {[e for e, _ in ea]} != "
                             f"{[e for e, _ in eb]}")
    stat_err = 0.0
    for (epoch, sa), (_, sb) in zip(ea, eb):
        _finite(f"{tag} epoch {epoch}", sb)
        for key in _PATH_STATS:
            err = abs(sa[key] - sb[key])
            if err > TOL * max(1.0, abs(sa[key])):
                raise AssertionError(f"{tag}: epoch {epoch} {key} "
                                     f"{sb[key]} != {sa[key]}")
            stat_err = max(stat_err, err)
    best_a = pa.objects["best_val_stats"]["epoch"]
    best_b = ba.objects["best_val_stats"]["epoch"]
    if best_a != best_b:
        raise AssertionError(f"{tag}: best epoch {best_b} != {best_a}")
    param_err = 0.0
    pa_best = pa.objects["best_state"]["params"]
    pb_best = ba.objects["best_state"]["params"]
    for key, ref in pa_best.items():
        param_err = max(param_err, _gate(tag, f"best {key}", pb_best[key],
                                         ref)[0])
    counts = [st["count"] for st in
              ba.objects["best_state"]["opt_state"]["state"].values()]
    if counts != [best_a] * len(counts):
        raise AssertionError(f"{tag}: the best state's Adam counts "
                             f"{counts} != {best_a}")

    # one more block: its only host sync is the readback of its stats
    tensors = ba.objects["tensors"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ba.objects["train_block"](5, 11, **tensors)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if str(w.message).startswith("called a synchronizing")]
    if len(syncs) != 1:
        raise AssertionError(f"{tag}: a steady block synchronized at "
                             f"{syncs}, not only at its one readback")
    emit({"paths": "blocked", "graph": name, "route": backend,
          "epochs": 10, "block": 5, "best_epoch": best_b,
          "max_stat_err": stat_err, "max_param_err": param_err,
          "steady_block_syncs": syncs,
          "launches_per_epoch_run": la, "launches_blocked_run": lb})


def paths_store_and_predict(data_dir, name, root):
    """A recorded run (``--use_signac``, cluster-ordered so the original
    order is not the training order) with saved activations, predictions
    and degree-accuracy records; every stored array against the restored
    model in the original node order; then ``python -m
    h2gcn_tpu_torch.predict`` from the run's checkpoint."""
    import torch

    from h2gcn_tpu_torch.modules.runstore import get_project

    tag = f"paths store {name}"
    argv = ["H2GCN", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--sparse_backend", "gscatter",
            "--epochs", "10", "--best_val_criteria", "val_loss",
            "--dropout", "0", "--random_seed", "123", "--reorder",
            "cluster", "--use_signac", "--signac_root", root,
            "--save_activations", "--deg_acc_monitor", "2", "5",
            "--run_id", "paths"]
    args, launches = _cli(argv)
    job = args.objects["signac_job"]
    if [j.id for j in get_project(root).find_jobs({"run_id": "paths"})] \
            != [job.id]:
        raise AssertionError(f"{tag}: the project does not find its job")
    with open(job.fn("results.json")) as f:
        results = json.load(f)
    best = args.objects["best_val_stats"]
    for key in _PATH_STATS[1:] + ("epoch",):
        if abs(results[key] - float(best[key])) > 1e-6:
            raise AssertionError(f"{tag}: results.json {key}")
    tensors = args.objects["tensors"]
    unperm = args.objects["original_order"]
    capture = {}
    with torch.no_grad():
        logits = args.objects["predict_step"](**tensors)
        args.objects["model"](tensors["adj"], tensors["features"],
                              tensors["adj_hops"], capture=capture)
    keys = set(job.data.keys())
    want = set(capture) | {"predicted_prob", "train_mask", "val_mask",
                           "test_mask"} | {
        f"deg_acc/{s}/{k}" for s in ("train", "val", "test")
        for k in ("bins", "counts", "acc")}
    if keys != want:
        raise AssertionError(f"{tag}: stored keys {sorted(keys ^ want)} "
                             "differ")
    for key, value in list(capture.items()) + [("predicted_prob", logits)]:
        _gate(tag, key, torch.from_numpy(job.data[key]),
              unperm(value).cpu())
    dataset = args.objects["dataset"]
    for scope in ("train", "val", "test"):
        if not np.array_equal(job.data[f"{scope}_mask"],
                              np.asarray(getattr(dataset, f"{scope}_mask"),
                                         np.float32)):
            raise AssertionError(f"{tag}: {scope}_mask not in the original "
                                 "node order")

    # the inference entry point from the recorded run's checkpoint
    ckpts = glob.glob(os.path.join(job.workspace(), "checkpoints", "*",
                                   "ckpt.pt"))
    if len(ckpts) != 1:
        raise AssertionError(f"{tag}: checkpoints {ckpts} in the job")
    out = os.path.join(root, "preds.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "h2gcn_tpu_torch.predict", "H2GCN",
         "planetoid", "--dataset", f"ind.{name}", "--dataset_path",
         data_dir, "--sparse_backend", "gscatter", "--reorder", "cluster",
         "--restore_checkpoint", ckpts[0], "--output", out,
         "--checkpoint_dir", os.path.join(root, "ckpt_predict")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
        raise AssertionError(f"{tag}: predict exited {proc.returncode}")
    preds = np.load(out)
    err, tol = _gate(tag, "predict's logits",
                     torch.from_numpy(preds["logits"]), logits.cpu())
    if not np.array_equal(preds["predicted_label"],
                          logits.argmax(1).cpu().numpy()):
        raise AssertionError(f"{tag}: predicted labels differ")
    emit({"paths": "store_predict", "graph": name, "job": job.id,
          "stored_keys": len(keys), "predict_logit_err": err,
          "predict_logit_tol": tol, "launches": launches})


def _scale_factory(conf, output_dim):
    factor = float(conf)

    def fn(params, adj, x, adjhops, tagged):
        return x * factor

    return fn


def paths_dsl(data_dir, name, device):
    """A network setup with every new DSL kind (an E-marked dense, a
    lambda, SG, a slice, I and a registered X layer) trained EPOCHS epochs
    through gscatter; its logits against the segment path; embed_step
    against the E layer's output."""
    import torch

    from h2gcn_tpu_torch.nn.model import experimental_registry

    tag = f"paths dsl {name}"
    experimental_registry["scale"] = _scale_factory
    try:
        args, launches = _cli(
            ["H2GCN", "planetoid", "--dataset", f"ind.{name}",
             "--dataset_path", data_dir, "--sparse_backend", "gscatter",
             "--network_setup", DSL_SETUP, "--epochs", str(EPOCHS),
             "--timing", "--random_seed", "123", "--checkpoint_dir",
             os.path.join(data_dir, "ckpt_paths_dsl")])
        if launches["gscatter_spmm"] == 0:
            raise AssertionError(f"{tag}: gscatter_spmm never launched")
        _finite(tag, args.objects["epoch_stats"])
        logits, ref = _segment_logits(args, device)
        logit_err, logit_tol = _gate(tag, "logits", logits, ref)
        tensors = args.objects["tensors"]
        model = args.objects["model"]
        with torch.no_grad():
            emb = args.objects["embed_step"](**tensors)
            want = torch.matmul(tensors["features"], model.kernels["0"])
        emb_err, _ = _gate(tag, "embeddings", emb, want)
        names = model.names
    finally:
        del experimental_registry["scale"]
    emit({"paths": "dsl", "graph": name, "setup": DSL_SETUP,
          "layers": names, "logit_err": logit_err, "logit_tol": logit_tol,
          "embed_err": emb_err, "launches": launches})


def paths_attn(data_dir, name):
    """GAT on the 10K graph through the gather payload (``auto`` past the
    BSR budget); attn_step's coefficients through the payload (its call
    launches the weighted combine) sum to 1 over each row's edges and
    agree with the segment path's."""
    import torch

    from h2gcn_tpu_torch.sparse import attention_gather as gat

    tag = f"paths attn {name}"
    counters = ("gscatter_weighted",)
    args, launches = _cli(
        ["GAT", "planetoid", "--dataset", f"ind.{name}", "--dataset_path",
         data_dir, "--fused_attention", "--epochs", "2", "--random_seed",
         "123", "--checkpoint_dir", os.path.join(data_dir,
                                                 "ckpt_paths_attn")],
        counters)
    tensors = args.objects["tensors"]
    adj, model = tensors["adj"], args.objects["model"]
    ga = adj.attn
    if not isinstance(ga, gat.GatherAttn):
        raise AssertionError(f"{tag}: the support took no gather payload")
    before = _launch_counts(counters)
    coefs = args.objects["attn_step"](**tensors)
    torch.cuda.synchronize()
    attn_launches = _launched_since(before)["gscatter_weighted"]
    if attn_launches == 0:
        raise AssertionError(f"{tag}: attn_step launched no combine")
    model.fused_attention = False
    try:
        ref = args.objects["attn_step"](**tensors)
    finally:
        model.fused_attention = True
    nnz = adj.nnz
    if not (torch.equal(adj.rows[:nnz].long(), ga.rows.long())
            and torch.equal(adj.cols[:nnz].long(), ga.cols.long())):
        raise AssertionError(f"{tag}: the payload's edges are not in the "
                             "support's order")
    sum_err = alpha_err = 0.0
    for layer, (a, r) in enumerate(zip(coefs, ref)):
        sums = torch.zeros(adj.shape[0], a.shape[0], device=a.device)
        sums.index_add_(0, ga.rows.long(), a.T)
        sum_err = max(sum_err, float((sums - 1).abs().max()))
        alpha_err = max(alpha_err, _gate(tag, f"layer {layer} alpha", a,
                                         r[:, :nnz])[0])
    if sum_err > TOL:
        raise AssertionError(f"{tag}: alpha rows sum to 1 +- {sum_err}")
    emit({"paths": "attn", "graph": name, "route": "gather",
          "edges": nnz, "heads": [int(a.shape[0]) for a in coefs],
          "row_sum_err": sum_err, "alpha_err": alpha_err,
          "attn_step_launches": {"gscatter_weighted": attn_launches},
          "train_launches": launches})


def write_geomgcn(path, seed=0, n=SQUIRREL["n"], edges=SQUIRREL["edges"],
                  n_feat=SQUIRREL["n_feat"], n_classes=SQUIRREL["n_classes"],
                  feats_per_row=40):
    """A synthetic GeomGCN dataset at squirrel's size: ``edges`` distinct
    undirected edges drawn as build_graph draws them (every node in at
    least one), ``feats_per_row`` set bits of ``n_feat`` binary features a
    node, random classes, and a 60/20/20 split file. Returns the split
    file's path."""
    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 1.0) ** -0.6
    w /= w.sum()
    # a chain puts every node in the edge file (a missing node is dropped)
    pairs = {(i, i + 1) for i in range(n - 1)}
    while len(pairs) < edges:
        u, v = rng.choice(n, size=(2, edges), p=w)
        for a, b in zip(np.minimum(u, v), np.maximum(u, v)):
            if a != b:
                pairs.add((int(a), int(b)))
                if len(pairs) == edges:
                    break
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "out1_graph_edges.txt"), "w") as f:
        f.write("node_id\tnode_id\n")
        f.write("".join(f"{a}\t{b}\n" for a, b in sorted(pairs)))
    feats = np.zeros((n, n_feat), np.uint8)
    feats[np.repeat(np.arange(n), feats_per_row),
          rng.integers(0, n_feat, n * feats_per_row)] = 1
    labels = rng.integers(0, n_classes, n)
    digits = np.where(feats, "1", "0")
    with open(os.path.join(path, "out1_node_feature_label.txt"), "w") as f:
        f.write("node_id\tfeature\tlabel\n")
        f.write("".join(f"{i}\t{','.join(digits[i])}\t{labels[i]}\n"
                        for i in range(n)))
    order = rng.permutation(n)
    masks = {}
    for key, (lo, hi) in (("train_mask", (0, 0.6)), ("val_mask", (0.6, 0.8)),
                          ("test_mask", (0.8, 1.0))):
        m = np.zeros(n, np.int64)
        m[order[int(lo * n):int(hi * n)]] = 1
        masks[key] = m
    split = os.path.join(path, "squirrel_split_0.6_0.2_0.npz")
    np.savez(split, **masks)
    return split


def write_sparsegraph(path, name, adj, seed=0, n_feat=1433, feats_per_row=18,
                      n_classes=7):
    """``adj`` as a SparseGraph npz with sparse binary features and random
    classes."""
    import scipy.sparse as sp

    from h2gcn_tpu_torch.datasets import sparsegraph

    rng = np.random.default_rng(seed)
    n = adj.shape[0]
    cols = rng.integers(0, n_feat, (n, feats_per_row))
    feats = sp.csr_matrix(
        (np.ones(cols.size, np.float32),
         (np.repeat(np.arange(n), feats_per_row), cols.ravel())),
        shape=(n, n_feat))
    feats.data[:] = 1.0
    sparsegraph.save_sparse_graph_to_npz(
        os.path.join(path, name),
        sparsegraph.SparseGraph(adj, feats, rng.integers(0, n_classes, n)))


def paths_loader(fmt, dataset, data_path, extra, device):
    """H2GCN-2 EPOCHS epochs through gscatter on a ``fmt`` dataset; finite
    losses, logits against the segment path."""
    tag = f"paths loader {fmt} {dataset}"
    args, launches = _cli(
        ["H2GCN", fmt, "--dataset", dataset, "--dataset_path", data_path,
         "--sparse_backend", "gscatter", "--epochs", str(EPOCHS), "--timing",
         "--random_seed", "123", "--checkpoint_dir",
         os.path.join(data_path, f"ckpt_paths_{fmt}"), *extra])
    if launches["gscatter_spmm"] == 0:
        raise AssertionError(f"{tag}: gscatter_spmm never launched")
    _finite(tag, args.objects["epoch_stats"])
    logits, ref = _segment_logits(args, device)
    logit_err, logit_tol = _gate(tag, "logits", logits, ref)
    tensors = args.objects["tensors"]
    emit({"paths": "loader", "format": fmt, "dataset": dataset,
          "n": int(tensors["y_all"].shape[0]),
          "features": int(args.objects["dataset"].feature_dim),
          "hop_nnz": [h.nnz for h in tensors["adj_hops"]],
          "train_nodes": int(tensors["train_mask"].sum()),
          "logit_err": logit_err, "logit_tol": logit_tol,
          "launches": launches})


def check_paths(data_dir, device):
    """Phase ``paths`` on the 10K graph (``syn10k`` planetoid files, written
    by an earlier phase), the synthetic squirrel-sized GeomGCN files and
    the 10K graph as a SparseGraph npz, both written here from a seed."""
    paths_blocked(data_dir, "syn10k", "gscatter")
    paths_blocked(data_dir, "syn10k", "cootile")
    root = tempfile.mkdtemp(prefix="store_", dir=data_dir)
    paths_store_and_predict(data_dir, "syn10k", root)
    paths_dsl(data_dir, "syn10k", device)
    paths_attn(data_dir, "syn10k")
    geom = os.path.join(data_dir, "geomgcn")
    split = write_geomgcn(geom)
    sgdir = os.path.join(data_dir, "sparsegraph")
    os.makedirs(sgdir, exist_ok=True)
    write_sparsegraph(sgdir, "syn10k", build_graph())
    paths_loader("geomgcn", "squirrel", geom,
                 ("--splits_file_path", split), device)
    paths_loader("sparsegraph", "syn10k", sgdir,
                 ("--setting", "gcn", "--split_seed", "15"), device)


# --------------------------------------------------------------------------
# Phase experiments: the experiments pipeline at syn-products' config
# --------------------------------------------------------------------------

# the two graphs of the published syn-products config the phase sweeps
# (graph_index 1), with its split index 0
EXP_H = (0.0, 0.9)
# the setup whose child is run again in-process (H2GCN-2 with dropout)
EXP_SETUP = "M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO"
# the extra child: the same setup through #3 with the sharded precompute
EXP_EXTRA = ("H2GCN --network_setup " + EXP_SETUP + " --adj_nhood 1 2 "
             "--sparse_backend cootile --precompute_workers 4")


def experiments_config():
    """``configs/syn-products/generation.json`` cut to the graphs at EXP_H
    (``graph_index`` 1) and split index 0: 10,000 nodes, 10 classes of
    1,000, m = 3, m0 = 30, ``naive_npz`` features, split 0.25p__0.5p."""
    with open(os.path.join(REPO, "configs", "syn-products",
                           "generation.json")) as f:
        conf = json.load(f)
    conf["graphs"] = [g for g in conf["graphs"]
                      if g["h"] in EXP_H and g["graph_index"] == 1]
    conf["splits"] = [s for s in conf["splits"] if s["split_index"] == 0]
    return conf


def _exp_state(root, config):
    """Every (graph job, model args, run job) of ``config``'s runs in the
    project, and the bytes of the splits' child logs."""
    from pathlib import Path

    from h2gcn_tpu_torch.experiments import workflow
    from h2gcn_tpu_torch.modules.runstore import get_project

    runs, log_bytes = [], 0
    for graph_job in get_project(root):
        if not workflow._graph_matches(graph_job,
                                       config.get("graph_filter_dict")):
            continue
        for split_job, fg_name, _, args, run_id in workflow.iter_runs(
                graph_job, config):
            ws = Path(split_job.workspace()) / workflow.WORKSPACE_ROOT
            log = ws / "terminal_output.log"
            log_bytes += log.stat().st_size if log.exists() else 0
            if ws.exists():
                runs += [(graph_job, split_job, fg_name, args, run_id, job)
                         for job in get_project(str(ws)).find_jobs(
                             {"run_id": run_id})]
    return runs, log_bytes


def _exp_children(tag, runs, kernel):
    """Gate and print each child of a sweep: it succeeded, wrote finite
    accuracies, and launched ``kernel`` (its ``--timing`` record)."""
    for graph_job, _, _, args, _, job in runs:
        path = job.fn("results.json")
        if not (job.doc.get("succeeded") and os.path.exists(path)):
            raise AssertionError(f"{tag}: {args} on h={graph_job.sp.h} "
                                 "did not succeed")
        with open(path) as f:
            results = json.load(f)
        accs = [float(results[k]) for k in ("train_acc", "val_acc",
                                            "test_accuracy")]
        if not all(np.isfinite(accs)):
            raise AssertionError(f"{tag}: {args}: accuracies {accs}")
        launches = job.doc["timing"]["launches"]
        if launches.get(kernel, 0) == 0:
            raise AssertionError(f"{tag}: {args} on h={graph_job.sp.h} "
                                 f"never launched {kernel}: {launches}")
        emit({"experiments": tag, "h": graph_job.sp.h,
              "setup": args.split()[2], "launches": launches,
              "train_acc": accs[0], "val_acc": accs[1],
              "test_accuracy": accs[2]})


def exp_split_check(name, adj):
    """The exact-hop split [I, A1, A2] over 4 host workers (threads, the
    path of ``--precompute_workers 4``) against one worker, entry for
    entry; the halo volumes."""
    from h2gcn_tpu_torch.parallel.spgemm import dist_nhood_split
    from h2gcn_tpu_torch.sparse import transforms

    one = transforms.nhood_split(adj, 2)
    four, stats = dist_nhood_split(adj, 2, n_workers=4, return_stats=True)
    if len(four) != len(one):
        raise AssertionError(f"split {name}: {len(four)} hops, not "
                             f"{len(one)}")
    for hop, (a, b) in enumerate(zip(one, four)):
        a, b = a.tocsr().sorted_indices(), b.tocsr().sorted_indices()
        if not (np.array_equal(a.indptr, b.indptr)
                and np.array_equal(a.indices, b.indices)
                and np.array_equal(a.data, b.data)):
            raise AssertionError(f"split {name}: hop {hop} differs at 4 "
                                 "workers")
    emit({"experiments": "split", "graph": name, "n": adj.shape[0],
          "hop_nnz": [int(m.nnz) for m in one], "rounds": stats.rounds,
          "halo_rows": stats.halo_rows, "halo_bytes": stats.halo_bytes,
          "total_halo_bytes": stats.total_halo_bytes,
          "shard_nnz": stats.shard_nnz})


def check_experiments(device):
    """Phase ``experiments``: ``python -m h2gcn_tpu_torch.experiments`` at
    the published syn-products config (two of its graphs, h = 0.0 and 0.9,
    split index 0) on the card: init and generate; a sweep of
    ``configs/syn-products/h2gcn.json`` (its four H2GCN setups at hidden
    64) with ``-p 2 --epochs 5 --extra_args --timing``: 8 children through
    #1 (``auto``); a second sweep that spawns none; summarize (8 rows); one
    extra child through #3 with ``--precompute_workers 4``; the stored
    logits of the h = 0.9 EXP_SETUP child against an in-process run of its
    argv and that run's segment path; the split at 4 workers against 1 on
    the 10K and 250K graphs. The project stays under
    ``chiprun_out/experiments``."""
    import csv

    import torch

    from h2gcn_tpu_torch.experiments import generation, workflow
    from h2gcn_tpu_torch.experiments.__main__ import main as exp_main
    from h2gcn_tpu_torch.experiments.graphgen import adj_lists_to_scipy
    from h2gcn_tpu_torch.modules.runstore import get_project

    base = os.path.join(REPO, "chiprun_out", "experiments")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    root = os.path.join(base, "syn-products")
    gen_cfg = os.path.join(base, "generation.json")
    with open(gen_cfg, "w") as f:
        json.dump(experiments_config(), f)
    sweep_cfg = os.path.join(REPO, "configs", "syn-products", "h2gcn.json")
    config = workflow.load_config(sweep_cfg)

    # step 1: the graphs, their statistics, the features and the split
    exp_main(["init", root, "-c", gen_cfg])
    exp_main(["generate", root])
    graphs = sorted(get_project(root), key=lambda j: j.sp.h)
    if [j.sp.h for j in graphs] != list(EXP_H):
        raise AssertionError(f"experiments: graphs at {[j.sp.h for j in graphs]}")
    for job in graphs:
        if job.doc["numNodes"] != 10_000 or not generation.split_generated(job):
            raise AssertionError(f"experiments: {job.sp.graphName} has "
                                 f"{job.doc['numNodes']} nodes or no split")
    ratios = [job.doc["homoEdgeRatio"] for job in graphs]
    if not ratios[1] > ratios[0]:
        raise AssertionError(f"experiments: homoEdgeRatio {ratios} does "
                             f"not order as h {EXP_H}")
    emit({"experiments": "generate", "graphs": [
        {"graph": j.sp.graphName, "h": j.sp.h, "numEdges": j.doc["numEdges"],
         "homoEdgeRatio": j.doc["homoEdgeRatio"]} for j in graphs]})

    # step 2: the sweep, 8 children on the card through #1
    exp_main(["sweep", root, "-c", sweep_cfg, "-p", "2", "--epochs",
              str(EPOCHS), "--extra_args=--timing"])
    runs, log_bytes = _exp_state(root, config)
    if len(runs) != 2 * len(config["model_args"]):
        raise AssertionError(f"experiments: the sweep spawned {len(runs)} "
                             "children, not 8")
    _exp_children("sweep_child", runs, "gscatter_spmm")

    # step 3: a second sweep finds every run done and spawns nothing (a
    # child would add a run or, run again, append to its split's log)
    exp_main(["sweep", root, "-c", sweep_cfg, "-p", "2", "--epochs",
              str(EPOCHS), "--extra_args=--timing"])
    again, again_bytes = _exp_state(root, config)
    if len(again) != len(runs) or again_bytes != log_bytes:
        raise AssertionError("experiments: the second sweep spawned a child")

    # step 4: summarize
    out_csv = os.path.join(base, "results.csv")
    exp_main(["summarize", root, "-f", sweep_cfg, "-o", out_csv])
    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != len(runs):
        raise AssertionError(f"experiments: summarize wrote {len(rows)} "
                             f"rows, not {len(runs)}")
    emit({"experiments": "summarize", "rows": len(rows),
          "columns": list(rows[0])})

    # step 5: the extra child, through #3 with the sharded precompute
    extra = {"model_args": [EXP_EXTRA], "graph_filter_dict": {"h": EXP_H[1]}}
    extra_cfg = os.path.join(base, "extra.json")
    with open(extra_cfg, "w") as f:
        json.dump(extra, f)
    exp_main(["sweep", root, "-c", extra_cfg, "--epochs", str(EPOCHS),
              "--extra_args=--timing"])
    extra_runs, _ = _exp_state(root, extra)
    if len(extra_runs) != 1:
        raise AssertionError(f"experiments: {len(extra_runs)} extra runs")
    _exp_children("extra_child", extra_runs, "cootile_spmm")

    # step 6: the h = 0.9 EXP_SETUP child's stored logits against the same
    # argv run in-process (its own store) and that run's segment path
    (_, split_job, fg_name, args_str, run_id, job), = [
        r for r in runs if r[0].sp.h == EXP_H[1] and EXP_SETUP in r[3]]
    argv = workflow.dataset_args(args_str, split_job, fg_name, run_id)
    argv[argv.index("--signac_root") + 1] = os.path.join(base, "in_process")
    argv += ["--epochs", str(EPOCHS), "--timing"]
    args, launches = _cli(argv)
    if launches["gscatter_spmm"] == 0:
        raise AssertionError("experiments in-process: gscatter_spmm never "
                             "launched")
    stored = torch.as_tensor(job.data["predicted_prob"], device=device)
    logits, ref = _segment_logits(args, device)
    run_err, run_tol = _gate("experiments in-process", "stored logits",
                             stored, logits)
    seg_err, seg_tol = _gate("experiments segment", "stored logits",
                             stored, ref)
    emit({"experiments": "logits", "h": EXP_H[1], "setup": EXP_SETUP,
          "in_process_err": run_err, "segment_err": seg_err,
          "tol": max(run_tol, seg_tol), "launches": launches})

    # step 7: the split at 4 workers against 1, at 10K and 250K nodes
    adj_lists, _, _ = generation.load_graph_artifacts(graphs[1])
    exp_split_check(graphs[1].sp.graphName, adj_lists_to_scipy(adj_lists))
    exp_split_check("syn250k", scale_graph())


# --------------------------------------------------------------------------
# Phase distributed: the distributed runtime on one card
# --------------------------------------------------------------------------

DIST_MODES = ("ring", "allgather", "halo", "halo-cootile")
# the kernels of the distributed phase's routes
_DIST_WRAPPERS = ("cootile_spmm", "gscatter_spmm", "gscatter_weighted")


def _dist_run(tag, argv):
    """One CLI run for the phase: (its logits, its line)."""
    import torch

    args, launches = _cli(argv, _DIST_WRAPPERS)
    stats = args.objects["epoch_stats"]
    _finite(tag, stats)
    with torch.no_grad():
        logits = args.objects["predict_step"](**args.objects["tensors"])
    return logits, {"launches": launches,
                    "final_val_acc": float(stats["val_acc"])}


@contextlib.contextmanager
def world_of_one():
    """Inside, the CLI's runs register the distributed runtime at world
    size 1 on the joined group: ``initialize_model`` draws the parameters
    and calls ``_initialize_distributed(..., mesh_shards=1)``, as it does
    itself for ``--mesh_shards N`` > 1 (the CLI's gate)."""
    from h2gcn_tpu_torch.models import _runtime

    one_device = _runtime.initialize_model

    def initialize_model(args, model, optimizer_name, lr, early_stopping,
                         seed=None, es_metric="val_loss"):
        optimizer, device, seed = _runtime.init_parameters(
            args, model, optimizer_name, lr, seed)
        _runtime._initialize_distributed(args, model, optimizer, device,
                                         seed, early_stopping, es_metric,
                                         mesh_shards=1)

    _runtime.initialize_model = initialize_model
    try:
        yield
    finally:
        _runtime.initialize_model = one_device


def dist_runtime(data_dir, name, device):
    """The distributed runtime on this card at world size 1 over NCCL (a
    ``file://`` rendezvous): the dry run in its five modes; H2GCN-2 for
    EPOCHS epochs in each halo mode through the CLI (in
    :func:`world_of_one`) against the one-device run on the same route
    (segment for the flat-COO modes, cootile for halo-cootile), and GAT at
    Cora's widths (``--attn_drop 0``) against the one-device gather run.
    The logits are gated at TOL."""
    import torch.distributed as tdist

    from h2gcn_tpu_torch.parallel import dryrun
    from h2gcn_tpu_torch.parallel.mesh import init_group

    rendezvous = tempfile.mkdtemp(prefix="rendezvous_", dir=data_dir)
    mesh = init_group(f"file://{os.path.join(rendezvous, 'store')}", 1, 0,
                      device.type)
    emit({"dist_world": mesh.size, "backend": mesh.backend,
          "device": str(mesh.device)})
    try:
        for mode in DIST_MODES + ("gat",):
            out = dryrun.run(1, mode=mode)
            emit({"dist_dryrun": mode, "loss": out["loss"],
                  "acc": out["acc"]})

        base = ["planetoid", "--dataset", f"ind.{name}", "--dataset_path",
                data_dir, "--device", device.type, "--epochs", str(EPOCHS),
                "--timing", "--random_seed", "123"]
        refs = {}
        runs = [(mode, "H2GCN", ["--sparse_backend",
                                 "cootile" if mode == "halo-cootile"
                                 else "segment"], mode)
                for mode in DIST_MODES]
        runs.append(("gat", "GAT", ["--fused_attention", "--attn_impl",
                                    "gather", "--attn_drop", "0"], "ring"))
        for tag, model, flags, mode in runs:
            route = flags[1] if model == "H2GCN" else "gather"
            if route not in refs:
                ck = os.path.join(data_dir, f"ckpt_dist_ref_{route}")
                refs[route] = _dist_run(
                    f"{model} {route}", [model, *base, *flags,
                                         "--checkpoint_dir", ck])
                emit({"dist_ref": route, "model": model, **refs[route][1]})
            ck = os.path.join(data_dir, f"ckpt_dist_{tag}")
            with world_of_one():
                logits, line = _dist_run(
                    f"{model} world of one {tag}",
                    [model, *base, *flags, "--halo_mode", mode,
                     "--checkpoint_dir", ck])
            err, tol = _gate(f"distributed {tag}", "logits", logits,
                             refs[route][0])
            kernel = {"halo-cootile": "cootile_spmm",
                      "gat": "gscatter_weighted"}.get(tag)
            if kernel and line["launches"][kernel] == 0:
                raise AssertionError(f"distributed {tag}: {kernel} was "
                                     "never launched")
            emit({"dist_cli": tag, "model": model, "route": route,
                  "logit_err": err, "logit_tol": tol, **line})
    finally:
        tdist.destroy_process_group()


def dist_one_card(data_dir, name):
    """``--mesh_shards`` one past the card count with ``--device cuda``
    fails before it spawns a rank."""
    import torch

    n = torch.cuda.device_count() + 1
    proc = subprocess.run(
        [sys.executable, "-m", "h2gcn_tpu_torch.run_experiments", "H2GCN",
         "planetoid", "--dataset", f"ind.{name}", "--dataset_path", data_dir,
         "--mesh_shards", str(n), "--device", "cuda"],
        capture_output=True, text=True, timeout=300)
    want = f"requested {n} devices, have {n - 1}"
    if proc.returncode == 0 or want not in proc.stderr:
        raise AssertionError(f"--mesh_shards {n}: exit {proc.returncode}, "
                             f"stderr {proc.stderr[-2000:]}")
    emit({"dist_one_card": n, "exit": proc.returncode, "message": want})


def check_distributed(data_dir, device):
    """Phase ``distributed``: the runtime at world size 1 over NCCL on the
    10K graph's planetoid files, and the one-card contract of
    ``--mesh_shards``."""
    dist_runtime(data_dir, "syn10k", device)
    dist_one_card(data_dir, "syn10k")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    # fails in a directory without the package, before any result
    from h2gcn_tpu_torch import native
    from h2gcn_tpu_torch.run_experiments import resolve_device
    from h2gcn_tpu_torch.sparse import _build

    device = resolve_device("cuda")  # also turns TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    gpu_name, power_limit = [s.strip() for s in smi_line.split(",", 1)]
    emit({"gpu": gpu_name, "power_limit": power_limit})

    t0 = time.perf_counter()
    _build.library()
    # the host path of the exact-hop split and the cluster order: the
    # port's native library, not scipy's (whose RCM order differs)
    if not native.available():
        raise AssertionError("the native graph library did not build or "
                             "load: the host path would be scipy's")
    emit({"phase": "build", "library": _build.library_path().name,
          "host_library": native.library_path().name,
          "openmp_threads": native.openmp_threads(),
          "s": time.perf_counter() - t0})

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=_build.BUILD_DIR)
    try:
        for name, phase, *args in (
                ("holds", check_holds, device),
                ("cli", check_cli, data_dir, device),
                ("gat_cli", check_gat_cli, data_dir, device),
                ("gat_scale_cli", check_gat_scale_cli, data_dir, device),
                ("cootile_cli", check_cootile_cli, data_dir, device),
                ("baselines_cli", check_baselines_cli, data_dir, device),
                ("paths", check_paths, data_dir, device),
                ("experiments", check_experiments, device),
                ("distributed", check_distributed, data_dir, device)):
            t0 = time.perf_counter()
            phase(*args)
            emit({"phase": name, "s": time.perf_counter() - t0})
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    emit({"phase": "total", "s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
