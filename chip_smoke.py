#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (h2gcn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc; exits non-zero without them. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``h2gcn_tpu_torch/csrc`` with nvcc, and the
   native host library (exact-hop split, RCM order) with g++, and fails if
   the host path would be scipy's;
3. holds each kernel (gscatter_spmm, bsr_spmm) against its plain PyTorch
   version on the card, forward and autograd backward, in both precisions,
   at the shapes of the main path: the 10K-node synthetic graph of
   bench.py (exact-hop split, symmetric normalization: A1 and A2) at the
   widths H2GCN-2 aggregates (64 and 128), plus the random-walk normalized
   A1, whose transpose payload the backward reads. Each case prints its
   error, its tolerance, the kernel's, plain version's and
   ``torch.sparse.mm``'s times beside the card's lower bound (for BSR also
   the bound of its dense blocks), and the work items the kernel launched
   with the entries (gscatter, and its split rows) or blocks (BSR) per
   item; then the gscatter sweep at A2, F = 128 (entries a work item);
4. trains H2GCN-2 for 5 epochs through the CLI
   (``h2gcn_tpu_torch.run_experiments.main``) on the same graph written as
   planetoid files, once with ``--sparse_backend gscatter`` and once with
   ``bsr``, and checks that the run launched its kernel, that losses are
   finite, that a checkpoint was written, and that the trained model's
   logits agree with the same weights run through the plain
   ``index_add_`` SpMM;
5. holds the three GAT attention kernels (gat_fwd_stats, gat_bwd_row,
   gat_bwd_col) against their plain versions and times them, on a
   Cora-shaped synthetic graph (2,708 nodes, 5,429 edges, self-looped,
   256-blocks) at both GAT layers' widths (8 heads of 8, 1 head of 7), and
   as timing shapes on its hub-free twin and on the 10K graph forced to
   256-blocks; the kernels walk per-row (forward, row pass) and per-column
   (column pass) edge lists built once from one scan of the mask: each
   graph's line prints the lists' build seconds (``row_list_build_s``,
   with the scan; ``col_list_build_s``), and each case its work items,
   whether its rows allow 16-byte loads, and its device time in a CUDA
   graph beside the eager call's; at the Cora-shaped graph's layer 1 the
   forward's and row pass's sweep (``mask_row_sweep`` lines: 64, 128 and
   256 edges an item at 4 warps, row cost 16);
6. trains GAT (Cora's published configuration) for 5 epochs through the
   CLI on the Cora-shaped graph written as planetoid files, with
   ``--fused_attention --attn_drop 0`` (training and eval launch all three
   kernels) and with the published ``--attn_drop 0.6`` (training takes the
   segment path, eval launches the forward kernel), and checks launches,
   finite losses, a checkpoint, and the trained logits through the kernels
   against the same weights through the segment path;
7. (``gat_scale_kernels``) holds the payloads past the BSR budget against
   their plain versions and times them, on the 10K graph (self-looped,
   128,602 edges) and the Cora-shaped graph at both GAT widths: the three
   COO-chunk attention kernels (gat_coo_fwd, gat_coo_bwd_row,
   gat_coo_bwd_col) in f32 and, against the f32 plain version at a looser
   bound, in bf16 ("default"), and the weighted gather-scatter combine
   (gscatter_weighted) in the four combines of a training step, each case
   with the combine's work items and its largest item's slots and its
   device time in a CUDA graph beside the eager call's, and at the
   10K graph's layer 1 the combine's sweep (``combine_sweep`` lines: the
   gather tables' tile x the warps of a thread block, forward and dh);
   the three COO-chunk kernels walk work items over per-row (forward, row
   pass) and per-column (column pass) edge lists: each of their cases also
   prints its items (edges an item, warps a block, a row's cost, how many,
   the split rows and their pieces, the workspace bytes) and its device
   time in a CUDA graph beside the eager call's, and at the 10K graph's
   layer 1 their sweep (``coo_sweep`` lines: edges an item x warps a block,
   then a row's cost); then times one attention layer forward and forward
   + backward
   through each of the BSR, COO-chunk and gather payloads on the same
   inputs (the crossover the BSR budget waits for);
8. (``gat_scale_cli``) trains GAT for 5 epochs through the CLI on the 10K
   graph (past the BSR budget) with ``--fused_attention``: ``auto`` with
   the published ``--attn_drop 0.6`` (routes to the gather payload and
   trains fused), ``auto`` with ``--attn_drop 0``, and ``--attn_impl coo
   --attn_drop 0``, and checks each run's route and launches, finite
   losses, a checkpoint, and the trained logits against the segment path;
9. (``cootile_kernels``) holds the COO-tile SpMM (cootile_spmm) against its
   plain version on the card, forward and autograd backward, in both
   precisions at F = 64 and 128, on the 10K graph's A2 and RW-normalized A1
   (whose backward reads the transpose tables) and on the 250K-node graph
   of the JAX package's bench_large.py (``scale_graph``: 799,540 adjacency
   and 24,999,792 A2 entries) with its A1 and A2 cluster-ordered; prints
   each case's error, tolerance, times and bound, each matrix's heaviest
   tile row, the kernel's chunk ranges (``ranges``) and the runs of one
   destination row inside a chunk (``row_runs``), and the sweep that set
   the default geometry and schedule (``cootile_sweep`` lines, "highest":
   tile 128 and 256 x 64 and 128 features a thread block x the groups a
   warp walks before the next warp's (0 or 4) and the slots of a block's
   range (16,384 or 65,536), at the 10K A2, F = 128, the 250K A2, F = 64
   and 128, and the 250K A1, F = 128);
10. (``cootile_cli``) trains H2GCN-2 for 5 epochs through the CLI with
   ``--sparse_backend cootile`` on the 10K graph, and on the 250K graph
   written as planetoid files with ``--reorder cluster --sparse_features``;
   checks the launches, finite losses, a checkpoint and the trained logits
   (at 250K mapped back to the original node order, against the same
   weights through the segment SpMM on the un-reordered graph), and prints
   the epoch time, the host set-up seconds and the peak device memory;
11. (``baseline_kernels``) holds the three SpMM kernels (gscatter, BSR,
   COO-tile) against their plain versions, forward and transpose,
   "highest", at the baselines' widths and matrices: the 10K graph's
   self-looped sym_norm(A+I) at F = 7, 16 and 1433 (GCN's classes and
   hidden units, cheby's raw features), its row-normalized D^-1 A (not
   symmetric; bp and GraphSAGE's full-neighbor mean) at F = 7, 128 and
   1433, and the Cora-shaped graph's Chebyshev T_3 (negative values) at
   F = 16; each case with its eager time, its device time in a CUDA
   graph (``device_ms``: at narrow widths the eager call measures the
   wrapper), the plain version's time, its bound and ``torch.sparse.mm``'s
   time;
12. (``baselines_cli``) trains each baseline for 5 epochs through the CLI
   at its published width on the Cora-shaped graph (1,433 features): GCN
   (``gcn`` through gscatter, BSR and COO-tile; ``cheby`` and
   ``cheby_concat2`` with max degree 3, ``concat2`` and ``bp`` on one-hot
   label priors through gscatter; ``mlp``, which aggregates nothing),
   MixHop's published Cora setup through gscatter and BSR, GraphSAGE
   sampled (5, 5) and full-neighbor (0, 0), and H2GCN's setup without graph
   layers (``M64-R-D0.5-MO``); and GCN on the 10K graph. Each line holds
   the launches (and per epoch), finite losses, a checkpoint, the epoch
   time (mean and median), the host set-up seconds and the peak device
   memory, and where the run aggregates through a kernel the trained
   logits against the segment path; sampled GraphSAGE (a random draw),
   GCN's ``mlp`` and H2GCN's setup without graph layers launch no SpMM
   kernel, and are checked to launch none;
13. (``paths``) drives the runtime's entry points beyond a plain training
   run on the card: H2GCN-2 on the 10K graph per-epoch and with
   ``--epochs_per_block 5`` through gscatter and cootile (every epoch's
   stats, the best epoch and its parameters and Adam counts agree; one
   more block under ``torch.cuda.set_sync_debug_mode("warn")`` syncs only
   at its readback; per-epoch and blocked ms an epoch); a recorded run
   (``--use_signac --save_activations --deg_acc_monitor``, cluster-ordered)
   whose ``results.json`` and every stored array are checked in the
   original node order, then ``python -m h2gcn_tpu_torch.predict`` from
   its checkpoint (logits within the gate of the trained model's); a
   network setup with every new DSL kind (``DSL_SETUP``, its X layer
   registered here) for 5 epochs, its logits against the segment path
   and ``embed_step`` against the E layer's output; ``attn_step`` of GAT
   on the 10K graph through the gather payload (rows sum to 1, the
   coefficients against the segment path's); and H2GCN-2 for 5 epochs on
   a synthetic GeomGCN dataset at squirrel's published size and on the
   10K graph as a SparseGraph npz, both written here from a seed (logits
   against the segment path, epoch time, ``prep_s``, peak memory);
14. (``experiments``) drives ``python -m h2gcn_tpu_torch.experiments``
   (its ``main``) at the published syn-products config, cut to two of its
   graphs (h = 0.0 and 0.9, 10,000 nodes each) and split index 0, in a
   project under ``chiprun_out/experiments``: ``init`` and ``generate``
   (the graphs have 10,000 nodes and their homoEdgeRatio orders as h; the
   seconds of each operation a graph), a ``sweep`` of
   ``configs/syn-products/h2gcn.json`` with ``-p 2 --epochs 5
   --extra_args=--timing`` that spawns 8 children on the card (each
   succeeded, wrote finite accuracies and launched gscatter; a line each
   with its seconds from start to exit beside its epoch ms), a second
   sweep that spawns none, ``summarize`` (8 rows), one extra child with
   ``--sparse_backend cootile --precompute_workers 4`` (launched cootile),
   the stored logits of the h = 0.9 H2GCN-2 child against an in-process
   run of its argv and that run's segment path, and the exact-hop split
   at 4 host workers against 1 on the h = 0.9 graph and the 250K graph
   (entry for entry; the seconds of each, the halo rows and bytes);
15. (``distributed``) the distributed layer (``h2gcn_tpu_torch.parallel``)
   on the card: B3 through every shard of the 10K graph's A1 and A2 cut
   into 4 halo-cootile shards at F = 64 and 128 (each shard's interior
   and halo reduce, forward and transpose, against the plain version,
   with the receive buffers built from the send tables; the shards' A x
   against scipy; a ``dist_spmm`` line a shard with its halo, bytes,
   entries, chunks and device time in a CUDA graph), and #10's four
   combines on every shard of the self-looped 10K support cut into 4
   dest-stripe GAT shards at Cora's layer 1 (``dist_gat`` lines); then,
   in a world of one rank over NCCL, the dry run in its five modes and
   H2GCN-2 for 5 epochs through the CLI in each ``--halo_mode`` and GAT
   at Cora's widths (``--attn_drop 0``), each against the one-device run
   on the same route (logits at TOL; launches, epoch ms), and a trace of
   epochs 3-5 of the world-of-one halo-cootile run and of its one-device
   run (``dist_profile``); last, ``--mesh_shards`` one past the card
   count fails before it spawns (``dist_one_card``);
16. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Every phase line carries its seconds (``"s"``). Any failure raises.

    python3 chip_smoke.py --ab DIR

compares this tree with another commit unpacked at DIR (``git archive``),
in turns DIR, this, this, DIR, twice: the COO-chunk kernels at the 10K
graph's layer 1, B5's three kernels at the Cora-shaped graph's layer 1,
the Cora-shaped BSR GAT epoch (``--attn_drop 0``) and the ``--attn_impl
coo`` GAT epoch at 10K, then one profiled epoch window (``--profile_dir``,
summarized by ``trace_summary``) of each epoch in each tree.
"""

from __future__ import annotations

import contextlib
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # dense, 700 W
TOL = 1e-4  # max |kernel - plain| <= TOL * max(1, max |plain|)
# the COO-chunk kernels in "default" precision (bf16 contraction operands)
# against the f32 plain version: the JAX package's bound for its bf16 mode
BF16_TOL = 3e-2
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


def time_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` calls, after 2 warm-ups."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters=20, reps=5):
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times after a warm-up, so no host work sits
    between the launches (a wrapper's Python costs tens of microseconds,
    more than a small kernel takes)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_csr(mat, device):
    """``mat`` as a torch sparse CSR tensor on ``device``: the operand of
    the library call each SpMM kernel is timed beside."""
    import torch

    coo = mat.tocoo()
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.from_numpy(np.vstack([coo.row, coo.col]).astype(np.int64)),
            torch.from_numpy(coo.data.astype(np.float32)),
            mat.shape, check_invariants=True).to(device).to_sparse_csr()


def _spmm_fns(kernel):
    """(run, plain) of one SpMM kernel: ``run(sm, x)`` launches the kernel
    on ``sm``'s payload, ``plain(sm, x, precision)`` its plain version on
    the same payload."""
    from h2gcn_tpu_torch.sparse.bsr_spmm import bsr_spmm, bsr_spmm_plain
    from h2gcn_tpu_torch.sparse.cootile import cootile_spmm, cootile_spmm_plain
    from h2gcn_tpu_torch.sparse.gscatter import gscatter_rows_plain, gscatter_spmm

    if kernel == "gscatter_spmm":
        return (lambda a, v: gscatter_spmm(a.gsc, v, precision=a.precision),
                lambda a, v, prec: gscatter_rows_plain(a.gsc, v,
                                                       precision=prec))
    if kernel == "bsr_spmm":
        return (lambda a, v: bsr_spmm(a.bsr, v, n_out=a.shape[0],
                                      precision=a.precision),
                lambda a, v, prec: bsr_spmm_plain(a.bsr, v, n_out=a.shape[0],
                                                  precision=prec))
    return (lambda a, v: cootile_spmm(a.coot, v, precision=a.precision),
            lambda a, v, prec: cootile_spmm_plain(a.coot, v, precision=prec))


def hold_spmm(kernel, mname, sm, F, gen, lib_a, device_time=False, **extra):
    """One SpMM case: ``spmm`` through ``kernel`` forward and autograd
    backward (the transpose view's payload) against the plain version on
    the same payload, the forward timed beside its bound and the library
    call (with ``device_time`` also in a CUDA graph: at narrow widths the
    eager call measures the wrapper's host work); each direction emitted
    as a line with ``extra``. Returns the two case dicts; raises if a
    direction disagrees."""
    import torch

    from h2gcn_tpu_torch.sparse import spmm

    t0 = time.perf_counter()
    n, m = sm.shape
    device = sm.rows.device
    run, plain = _spmm_fns(kernel)
    x = torch.randn(m, F, generator=gen, device=device)
    g = torch.randn(n, F, generator=gen, device=device)
    xr = x.clone().requires_grad_(True)
    y = spmm(sm, xr)
    y.backward(g)
    torch.cuda.synchronize()
    cases = []
    for direction, got, ref in (
            ("forward", y.detach(), plain(sm, x, sm.precision)),
            ("backward", xr.grad, plain(sm.transpose_view(), g,
                                        sm.precision))):
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(
                f"{kernel} {mname} F={F} {sm.precision} {direction}: bad "
                f"output {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        tol = TOL * max(1.0, float(ref.abs().max()))
        case = dict(kernel=kernel, matrix=mname, nnz=sm.nnz, F=F,
                    precision=sm.precision, direction=direction,
                    max_abs_err=err, tol=tol, **extra)
        if err > tol:
            emit(case)
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version: {case}")
        if direction == "forward":
            case.update(_times(kernel, sm, x, lambda: run(sm, x),
                               lambda a, v: plain(a, v, sm.precision),
                               lib_a, sm.precision))
            if device_time:
                case["device_ms"] = time_graph_ms(lambda: run(sm, x))
        case["s"] = time.perf_counter() - t0
        emit(case)
        cases.append(case)
    return cases


def check_kernels(device):
    """Phase 3: every kernel against its plain version at the path's
    shapes. Returns {kernel: [case dicts]}."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix, transforms

    adj = build_graph()
    split = transforms.nhood_split(adj, 2)
    mats = {
        "A1": transforms.normalize(split[1]).tocsr(),
        "A2": transforms.normalize(split[2]).tocsr(),
        "A1_rw": transforms.normalize(
            split[1], transforms.NType.RW_NORMALIZED).tocsr(),
    }
    gen = torch.Generator(device=device).manual_seed(0)
    results = {"gscatter_spmm": [], "bsr_spmm": []}
    for mname, mat in mats.items():
        lib_a = _library_csr(mat, device)
        for kernel in ("gscatter_spmm", "bsr_spmm"):
            for precision in ("highest", "default"):
                sm = SparseMatrix.from_scipy(mat, backend=kernel.split("_")[0],
                                             precision=precision,
                                             device=device)
                for F in (64, 128):
                    results[kernel] += hold_spmm(kernel, mname, sm, F, gen,
                                                 lib_a)
        if mname == "A2":
            gscatter_sweep(mat, device, gen)
    return results


def baseline_matrices():
    """The baselines' supports (phase 11): the 10K graph's self-looped
    sym_norm(A+I) (GCN, MixHop) and row-normalized D^-1 A (bp, GraphSAGE's
    full-neighbor mean; not symmetric), and the Chebyshev T_3 of the
    Cora-shaped graph at eigenvalue 2 (negative values, the explicit zeros
    scipy keeps, much denser than A), each with the widths the baselines
    aggregate it at."""
    import scipy.sparse as sp

    from h2gcn_tpu_torch.sparse import transforms

    adj = build_graph()
    t3 = transforms.chebyshev_polynomials(cora_graph(), 3, eigenvalue=2)[3]
    return {
        "A_self_looped": (transforms.normalize(
            transforms.add_eye(adj)).tocsr(), (7, 16, 1433)),
        "A_rw": (transforms.normalize(
            adj, transforms.NType.RW_NORMALIZED).tocsr(), (7, 128, 1433)),
        "T3_cora": (sp.csr_matrix(t3, dtype=np.float32), (16,)),
    }


def check_baseline_kernels(device):
    """Phase 11: the three SpMM kernels against their plain versions at the
    baselines' widths and matrices (:func:`baseline_matrices`), forward and
    transpose, "highest". Returns {kernel: [case dicts]}."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix

    gen = torch.Generator(device=device).manual_seed(13)
    results = {k: [] for k in ("gscatter_spmm", "bsr_spmm", "cootile_spmm")}
    for mname, (mat, widths) in baseline_matrices().items():
        t0 = time.perf_counter()
        lib_a = _library_csr(mat, device)
        emit({"baseline_matrix": mname, "n": mat.shape[0], "nnz": mat.nnz,
              "negative": int((mat.data < 0).sum()),
              "explicit_zeros": int((mat.data == 0).sum()),
              "s": time.perf_counter() - t0})
        for kernel in results:
            sm = SparseMatrix.from_scipy(mat, backend=kernel.split("_")[0],
                                         device=device)
            for F in widths:
                results[kernel] += hold_spmm(kernel, mname, sm, F, gen,
                                             lib_a, device_time=True,
                                             baseline=True)
            del sm
        torch.cuda.empty_cache()
    return results


# #1's sweep: the entries a work item sums
SWEEP_GSCATTER = (128, 256, 512, 1024, 2048, 4096)


def gscatter_sweep(mat, device, gen):
    """#1 at the 10K A2, F = 128, "highest", over the entries a work item
    sums: with ``scripts/gscatter_shapes.py``'s at arXiv-year's shapes, the
    sweep behind ``gscatter.MAX_ITEM_ENTRIES``."""
    import torch

    from h2gcn_tpu_torch.sparse.gscatter import build_row_major, gscatter_spmm

    x = torch.randn(mat.shape[1], 128, generator=gen, device=device)
    cols = torch.from_numpy(mat.indices.astype(np.int32)).to(device)
    vals = torch.from_numpy(mat.data.astype(np.float32)).to(device)
    for budget in SWEEP_GSCATTER:
        t0 = time.perf_counter()
        rm = build_row_major(mat.indptr, cols, vals, mat.shape[1],
                             budget=budget)
        build_s = time.perf_counter() - t0
        emit(dict(_gscatter_shape(rm), gscatter_sweep="A2", F=128,
                  precision="highest",
                  kernel_ms=time_ms(lambda: gscatter_spmm(rm, x), 20),
                  build_s=build_s, s=time.perf_counter() - t0))


def _times(kernel, sm, x, run, plain, lib_a, precision):
    import torch

    n, m = sm.shape
    F = x.shape[1]
    xbytes = 4 if precision == "highest" else 2
    dtype = "float32" if precision == "highest" else "bfloat16"
    # the least work of the SpMM, the same for both kernels: each edge read
    # once (row, col, value), x once, the output once; 2 ops per edge and
    # feature
    bound_ms, bound_by = _bound(sm.nnz * 12 + m * F * xbytes + n * F * 4,
                                2 * sm.nnz * F, dtype)
    if kernel == "gscatter_spmm":
        shape_info = _gscatter_shape(sm.gsc)
    elif kernel == "cootile_spmm":
        shape_info = _cootile_shape(sm.coot, sm.nnz, F, x.device,
                                    x_bytes=m * F * xbytes)
    else:
        # what the dense 128 x 128 blocks cost at least: the padding the
        # BSR layout adds on top of the bound
        b = sm.bsr
        dense_block_ms, _ = _bound(
            b.num_blocks * (b.block_size ** 2 * b.blocks.element_size() + 4)
            + m * F * xbytes + n * F * 4,
            2 * b.num_blocks * b.block_size ** 2 * F, dtype)
        shape_info = dict(_bsr_shape(b, F, x.device),
                          dense_block_ms=dense_block_ms)
    return dict(shape_info,
                kernel_ms=time_ms(run, 20),
                plain_ms=time_ms(lambda: plain(sm, x), 5),
                library_ms=time_ms(lambda: torch.sparse.mm(lib_a, x), 20),
                bound_ms=bound_ms, bound_by=bound_by)


def _gscatter_shape(rm):
    """What sets #1's work beside its entries: the longest row and the work
    items (each sums about a budget of entries; a longer row is split over
    several, its pieces added by the group that finishes the last)."""
    per_item = np.diff(rm.items[:, 0].cpu().numpy())
    return {"work_items": rm.n_items,
            "max_entries_per_item": int(per_item.max()),
            "mean_entries_per_item": float(per_item.mean()),
            "split_rows": rm.n_split, "pieces": rm.n_slots,
            "max_row_entries": int(rm.row_ptr.diff().max())}


def _bsr_shape(b, F, device):
    """The BSR kernel's work items: at most a budget of blocks of one
    block row each."""
    from h2gcn_tpu_torch.sparse.bsr_spmm import work_items

    per_item = np.diff(work_items(b, F, device).cpu().numpy()[:, 1:],
                       axis=1).ravel()
    return {"blocks": b.num_blocks, "work_items": int(per_item.size),
            "max_blocks_per_item": int(per_item.max()),
            "max_row_blocks": int((b.row_ptr[1:] - b.row_ptr[:-1]).max())}


_ROW_RUNS = {}  # id(CooTile) -> (CooTile, its row runs)


def _cootile_shape(ct, nnz, F, device, width=None, range_slots=None,
                   piece=None, x_bytes=None):
    """What sets a COO-tile SpMM's work beside its edges: the geometry, the
    padding slots, the heaviest tile row (spread over thread blocks), the
    thread blocks' chunk ranges and features, and the runs of one
    destination row inside a chunk (the kernel's shared-memory adds per
    feature; ``edges_per_run`` the adds each run saves)."""
    from h2gcn_tpu_torch.sparse.cootile import row_runs, work_shape

    if id(ct) not in _ROW_RUNS:  # the entry keeps ct, so its id stays
        _ROW_RUNS[id(ct)] = (ct, row_runs(ct))
    runs = _ROW_RUNS[id(ct)][1]
    w, per_block, ranges, piece = work_shape(ct, F, device, width,
                                             range_slots, piece, x_bytes)
    return {"tile": ct.tile, "e_b": ct.e_b, "chunks": ct.num_chunks,
            "slot_fill": nnz / (ct.num_chunks * ct.e_b),
            "heaviest_row_chunks": ct.heaviest_row_chunks(),
            "width": w, "chunks_per_block": per_block, "ranges": ranges,
            "piece": piece,
            "row_runs": runs, "edges_per_run": nnz / max(runs, 1)}


def cootile_matrices():
    """Phase 9's matrices: the 10K graph's A2 (the headline shape, beside
    rows 1-2 of the kernel table) and RW-normalized A1 (not symmetric: its
    backward reads the transpose tables); the 250K graph's A1 and A2,
    cluster-ordered as ``get_tensors(reorder="cluster")`` orders them (by
    the union pattern of the normalized hops)."""
    from h2gcn_tpu_torch.sparse import transforms

    split = transforms.nhood_split(build_graph(), 2)
    mats = {"A2": transforms.normalize(split[2]).tocsr(),
            "A1_rw": transforms.normalize(
                split[1], transforms.NType.RW_NORMALIZED).tocsr()}
    split = transforms.nhood_split(scale_graph(), 2)
    a1, a2 = (transforms.normalize(split[k]).tocsr() for k in (1, 2))
    perm = transforms.cluster_order(abs(a1) + abs(a2))
    mats["A1c_250k"] = transforms.permute_graph(a1, perm)
    mats["A2c_250k"] = transforms.permute_graph(a2, perm)
    return mats


# B3's geometry sweep, "highest": matrix -> its widths F; at each, the
# table tile x the features a thread block takes x the schedule (32-slot
# groups a warp walks before the next warp's, 0: one piece a warp; table
# slots a thread block walks)
SWEEP_COOTILE = {"A2": (128,), "A2c_250k": (64, 128), "A1c_250k": (128,)}
SWEEP_COOTILE_TILES = (128, 256)
SWEEP_COOTILE_WIDTHS = (64, 128)
SWEEP_COOTILE_SCHEDULES = ((0, 16384), (0, 65536), (4, 16384), (4, 65536))


def cootile_sweep(mname, mat, sm, device, gen):
    """The COO-tile kernel over the table tile, the features one thread
    block takes (tile x width f32 of shared memory) and the schedule (the
    groups a warp walks before the next warp's, the table slots of a
    block's chunk range), at ``mat``'s widths in :data:`SWEEP_COOTILE`: the
    sweep that set ``DEFAULT_TILE``, ``FEAT_WIDTH`` and the two regimes of
    ``cootile.schedule``. ``sm`` holds the tables at the default tile."""
    import torch

    from h2gcn_tpu_torch.sparse.cootile import build_cootile, cootile_spmm

    xs = {F: torch.randn(mat.shape[1], F, generator=gen, device=device)
          for F in SWEEP_COOTILE[mname]}
    for tile in SWEEP_COOTILE_TILES:
        t0 = time.perf_counter()
        ct = (sm.coot if tile == sm.coot.tile
              else build_cootile(mat, tile=tile, device=device))
        build_s = time.perf_counter() - t0
        for F, x in xs.items():
            for width in SWEEP_COOTILE_WIDTHS:
                for piece, slots in SWEEP_COOTILE_SCHEDULES:
                    if width > F:
                        continue
                    emit(dict(_cootile_shape(ct, sm.nnz, F, device, width,
                                             slots, piece),
                              cootile_sweep=mname, F=F, precision="highest",
                              range_slots=slots,
                              kernel_ms=time_ms(lambda: cootile_spmm(
                                  ct, x, width=width, range_slots=slots,
                                  piece=piece), 20),
                              build_s=build_s, s=time.perf_counter() - t0))
        del ct


def check_cootile_kernels(device):
    """Phase 9: cootile_spmm against its plain version, forward and
    backward, timed; the tile sweep. Returns [case dicts]."""
    import dataclasses

    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix

    t0 = time.perf_counter()
    mats = cootile_matrices()
    emit({"cootile_matrices": {k: v.nnz for k, v in mats.items()},
          "s": time.perf_counter() - t0})
    gen = torch.Generator(device=device).manual_seed(3)
    results = []
    for mname in list(mats):
        mat = mats.pop(mname)
        t0 = time.perf_counter()
        n, m = mat.shape
        # one table set serves both precisions
        sm = SparseMatrix.from_scipy(mat, backend="cootile", device=device)
        lib_a = _library_csr(mat, device)
        emit(dict(_cootile_shape(sm.coot, sm.nnz, 128, device),
                  matrix=mname, n=n, nnz=sm.nnz, symmetric=sm.symmetric,
                  build_s=time.perf_counter() - t0))
        for precision in ("highest", "default"):
            s = dataclasses.replace(sm, precision=precision)
            for F in (64, 128):
                results += hold_spmm("cootile_spmm", mname, s, F, gen, lib_a)
        if mname in SWEEP_COOTILE:
            cootile_sweep(mname, mat, sm, device, gen)
        _ROW_RUNS.clear()
        del sm, lib_a, mat
        torch.cuda.empty_cache()
    return results


def run_cli(backend, data_dir, name, device, extra=()):
    """Phases 4 and 10: H2GCN-2 for EPOCHS epochs through the CLI with
    ``--sparse_backend backend`` and the ``extra`` flags."""
    import glob

    import torch

    from h2gcn_tpu_torch import run_experiments
    from h2gcn_tpu_torch.sparse import SparseMatrix

    t0 = time.perf_counter()
    tag = " ".join([name, backend, *extra])
    ckpt_dir = os.path.join(data_dir, f"ckpt_{name}_{backend}")
    argv = ["H2GCN", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--sparse_backend", backend,
            "--epochs", str(EPOCHS), "--timing", "--random_seed", "123",
            "--checkpoint_dir", ckpt_dir, *extra]
    before = _launch_counts(_SPMM_WRAPPERS)
    torch.cuda.reset_peak_memory_stats(device)
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated(device)
    launches = _launched_since(before)
    kernel = f"{backend}_spmm"
    if launches[kernel] == 0:
        raise AssertionError(f"{tag}: {kernel} was never launched")
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(float(stats[key])):
            raise AssertionError(f"{tag}: {key} = {float(stats[key])}")
    if not glob.glob(os.path.join(ckpt_dir, "*", "ckpt.pt")):
        raise AssertionError(f"{tag}: no checkpoint under {ckpt_dir}")

    # the trained weights through the kernels and through index_add_; a
    # reordered run's logits go back to the original node order and meet
    # the un-reordered graph
    tensors = args.objects["tensors"]
    model = args.objects["model"]
    with torch.no_grad():
        logits = args.objects["original_order"](
            args.objects["predict_step"](**tensors))
        if "node_perm" in tensors:
            ref_t = vars(args.objects["dataset"].get_tensors(
                get_adj_norm_hops=args.adj_nhood, backend="segment",
                sparse_features=args.sparse_features, device=device))
        else:
            ref_t = dict(tensors, adj_hops=[
                SparseMatrix.from_scipy(h.to_scipy(), backend="segment",
                                        device=device)
                for h in tensors["adj_hops"]])
        ref = model(ref_t["adj"], ref_t["features"], ref_t["adj_hops"])
        del ref_t
    n, n_classes = tensors["y_all"].shape
    if tuple(logits.shape) != (n, n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"{tag}: bad logits {tuple(logits.shape)}")
    logit_err = float((logits - ref).abs().max())
    logit_tol = TOL * max(1.0, float(ref.abs().max()))
    if logit_err > logit_tol:
        raise AssertionError(f"{tag}: logits differ from the plain SpMM "
                             f"by {logit_err} > {logit_tol}")
    times = args.objects["epoch_times"]
    epoch_ms, epoch_ms_median = run_experiments.steady_epoch_ms(times)
    prep = tensors["prep_seconds"]
    emit({"cli": backend, "graph": name, "flags": list(extra),
          "n": n, "hop_nnz": [h.nnz for h in tensors["adj_hops"]],
          "epochs": len(times),
          "epoch_ms": epoch_ms, "epoch_ms_median": epoch_ms_median,
          "first_epoch_ms": 1e3 * times[0],
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches, "logit_err": logit_err,
          "logit_tol": logit_tol, "prep_s": prep,
          # loading the files, the model's set-up, the final evaluation
          "other_host_s": main_s - sum(times) - sum(prep.values()),
          "peak_mem_bytes": peak_bytes, "s": time.perf_counter() - t0})
    return launches[kernel]


# the baselines' runs of phase 12: (label, graph, model, --sparse_backend
# or None for the model's default, flags, the kernel its aggregations
# launch or None); each model at its published width
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


def run_baseline_cli(label, data_dir, name, device, model_name, backend,
                     flags, kernel):
    """Phase 12: one baseline for EPOCHS epochs through the CLI; checks its
    launches (``kernel`` launched, or no SpMM kernel at all where it is
    None), finite losses, a checkpoint, and (where ``kernel`` is set) the
    trained logits through the kernels against the segment path. Returns
    the launches."""
    import gc
    import glob

    import torch

    from h2gcn_tpu_torch import run_experiments

    t0 = time.perf_counter()
    route = backend or "auto"
    tag = f"{model_name} {label} {name} {route}"
    ckpt_dir = os.path.join(data_dir, f"ckpt_{label}_{name}_{route}")
    argv = [model_name, "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--epochs", str(EPOCHS), "--timing",
            "--random_seed", "123", "--checkpoint_dir", ckpt_dir, *flags]
    if backend:
        argv += ["--sparse_backend", backend]
    gc.collect()  # earlier runs' training state (reference cycles)
    torch.cuda.empty_cache()
    before = _launch_counts(_SPMM_WRAPPERS)
    torch.cuda.reset_peak_memory_stats(device)
    start_bytes = torch.cuda.memory_allocated(device)
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated(device)
    launches = _launched_since(before)
    if kernel is None and any(launches.values()):
        raise AssertionError(f"{tag}: launched {launches}, expected none")
    if kernel is not None and launches[kernel] == 0:
        raise AssertionError(f"{tag}: {kernel} was never launched")
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(float(stats[key])):
            raise AssertionError(f"{tag}: {key} = {float(stats[key])}")
    if not glob.glob(os.path.join(ckpt_dir, "*", "ckpt.pt")):
        raise AssertionError(f"{tag}: no checkpoint under {ckpt_dir}")
    if model_name == "MIXHOP" and not os.path.exists(
            os.path.join(ckpt_dir, "architecture.json")):
        raise AssertionError(f"{tag}: no architecture.json")

    tensors = args.objects["tensors"]
    with torch.no_grad():
        logits = args.objects["predict_step"](**tensors)
        n, n_classes = tensors["y_all"].shape
        if (tuple(logits.shape) != (n, n_classes)
                or not torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: bad logits {tuple(logits.shape)}")
        logit_err = logit_tol = None
        if kernel is not None:
            ref_t = _segment_tensors(tensors, device)
            ref = args.objects["model"](ref_t["adj"], ref_t["features"],
                                        ref_t["adj_hops"])
            del ref_t
            logit_err = float((logits - ref).abs().max())
            logit_tol = TOL * max(1.0, float(ref.abs().max()))
            if logit_err > logit_tol:
                raise AssertionError(f"{tag}: logits differ from the plain "
                                     f"SpMM by {logit_err} > {logit_tol}")
    times = args.objects["epoch_times"]
    epoch_ms, epoch_ms_median = run_experiments.steady_epoch_ms(times)
    prep = tensors["prep_seconds"]
    hops = tensors.get("adj_hops")
    emit({"baselines_cli": label, "model": model_name, "graph": name,
          "route": route, "flags": list(flags), "n": n,
          "support_nnz": ([h.nnz for h in hops] if isinstance(hops, list)
                          else None),
          "epochs": len(times), "epoch_ms": epoch_ms,
          "epoch_ms_median": epoch_ms_median,
          "first_epoch_ms": 1e3 * times[0],
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches,
          "launches_per_epoch": {k: v / len(times)
                                 for k, v in launches.items()},
          "logit_err": logit_err, "logit_tol": logit_tol, "prep_s": prep,
          "other_host_s": main_s - sum(times) - sum(prep.values()),
          # the peak over the run, and what earlier phases still held
          "peak_mem_bytes": peak_bytes, "mem_at_start_bytes": start_bytes,
          "s": time.perf_counter() - t0})
    return launches


GAT_WIDTHS = ((8, 8), (1, 7))  # (heads, features a head) of GAT's layers


def _gat_bounds(kernel, E, n, H, F):
    """The least work of one call at real size n and E support edges (each
    edge read once as row and column, 8 B; the node arrays read once and
    the outputs written once; f32 ops at the CUDA-core peak)."""
    HF = H * F
    if kernel == "gat_fwd_stats":
        nbytes = E * 8 + 4 * n * (2 * H + HF) + 4 * n * (HF + 2 * H)
        ops = E * H * (2 * F + 8)
    elif kernel == "gat_bwd_row":
        nbytes = E * 8 + 4 * n * (2 * H + 2 * HF + 3 * H) + 4 * n * H
        ops = E * H * (2 * F + 8)
    else:
        nbytes = E * 8 + 4 * n * (2 * H + 2 * HF + 3 * H) + 4 * n * (HF + H)
        ops = E * H * (4 * F + 8)
    return _bound(nbytes, ops, "float32")


def _max_err(what, got, ref, rel):
    """Max |got - ref| over the entries where the reference has no sentinel
    row max (those must match exactly), against ``rel`` * max(1, max
    |ref|) -> (err, tol); raises past it."""
    import torch

    from h2gcn_tpu_torch.sparse.attention import NEG_INF

    err, tol = 0.0, 0.0
    for a, b in zip(got, ref):
        live = b > NEG_INF / 2
        if (a.shape != b.shape or not torch.isfinite(a).all()
                or not torch.equal(a[~live], b[~live])):
            raise AssertionError(f"{what}: bad output {tuple(a.shape)}")
        e = float((a[live] - b[live]).abs().max()) if live.any() else 0.0
        t = rel * max(1.0, float(b[live].abs().max()) if live.any() else 0.0)
        if e > t:
            emit({"check": what, "max_abs_err": e, "tol": t})
            raise AssertionError(f"{what} disagrees with its plain version: "
                                 f"{e} > {t}")
        err, tol = max(err, e), max(tol, t)
    return err, tol


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


# the forward's and row pass's items over the mask's per-row lists at the
# Cora-shaped graph's layer 1: edges an item at 4 warps, row cost 16
SWEEP_MASK_ROW_BUDGETS = (64, 128, 256)


def _mask_row_run(kernel, bsr, f1, f2, h, bwd, H, F, it, warps):
    """One launch of the BSR forward's or row pass's item kernel over the
    mask's per-row lists in the items ``it`` with ``warps`` items a block:
    what the wrapper launches, at another item geometry (the sweep)."""
    import torch

    from h2gcn_tpu_torch.sparse import attention as att
    from h2gcn_tpu_torch.sparse.edge_items import launch_items

    ptr, src = att.mask_row_lists(bsr)
    n_pad, kw = h.shape[0], dict(num_heads=H, feat=F, slope=0.2,
                                 precision="highest", warps=warps)
    if kernel == "gat_fwd_stats":
        out = torch.empty(n_pad, H * F, device=h.device)
        m, l = (torch.empty(n_pad, H, device=h.device) for _ in range(2))
        launch_items(att.gat_fwd_stats, "h2gcn_gat_coo_fwd", ptr, src, it,
                     (f1, f2, h, out, m, l), H * (2 + F), **kw)
        return out, m, l
    df1 = torch.empty(n_pad, H, device=h.device)
    launch_items(att.gat_bwd_row, "h2gcn_gat_coo_bwd_row", ptr, src, it,
                 (*bwd[1:], df1), H, **kw)
    return df1


def mask_row_sweep(bsr, f1, f2, h, bwd, H, F, refs):
    """B5's forward and row pass over the mask's per-row lists at
    ``SWEEP_MASK_ROW_BUDGETS`` edges an item, 4 warps, row cost 16
    (``mask_row_sweep`` lines, device ms in a CUDA graph): whether the
    COO-chunk payload's defaults hold on the mask's lists. Each point is
    held against the plain version's ``refs`` first."""
    from h2gcn_tpu_torch.sparse import attention as att

    for kernel in ("gat_fwd_stats", "gat_bwd_row"):
        for budget in SWEEP_MASK_ROW_BUDGETS:
            t0 = time.perf_counter()
            it = att.mask_row_items(bsr, budget)

            def run(kernel=kernel, it=it):
                return _mask_row_run(kernel, bsr, f1, f2, h, bwd, H, F, it,
                                     4)

            err, tol = _max_err(f"{kernel} mask_row_sweep {budget}",
                                _tuple(run()), refs[kernel], TOL)
            emit(dict(_coo_items_shape(kernel, it, H, F, 4),
                      mask_row_sweep=kernel, graph="cora_shaped", H=H, F=F,
                      max_abs_err=err, tol=tol,
                      device_ms=time_graph_ms(run),
                      s=time.perf_counter() - t0))


def check_gat_kernels(device):
    """Phase 5: the GAT attention kernels against their plain versions,
    timed. Returns {kernel: [case dicts]}."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix
    from h2gcn_tpu_torch.sparse import attention as att

    # the same Cora shape without hubs tells the walk of a hub row (split
    # into pieces) from that of the other rows
    graphs = {"cora_shaped": self_looped(cora_graph()),
              "cora_uniform": self_looped(cora_graph(skew=0.0)),
              "syn10k": self_looped(build_graph())}
    gen = torch.Generator(device=device).manual_seed(1)
    results = {"gat_fwd_stats": [], "gat_bwd_row": [], "gat_bwd_col": []}
    for gname, support in graphs.items():
        t0 = time.perf_counter()
        sm = SparseMatrix.from_scipy(support, backend="bsr", block_size=256,
                                     device=device)
        bsr, n, E = sm.bsr, support.shape[0], support.nnz
        n_pad = bsr.n_row_blocks * bsr.block_size
        # the kernels' per-row and per-column lists, built once on the card
        # from one scan of the mask, and their work items: the row lists'
        # seconds include the scan and both lists' sorts, the column
        # lists' only their items
        t1 = time.perf_counter()
        row_items = att.mask_row_items(bsr)
        torch.cuda.synchronize()
        row_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        col_items = att.mask_col_items(bsr)
        torch.cuda.synchronize()
        col_s = time.perf_counter() - t1
        items = {"gat_fwd_stats": row_items, "gat_bwd_row": row_items,
                 "gat_bwd_col": col_items}
        emit({"graph": gname, "n": n, "support_nnz": E, "block_size": 256,
              "max_row_nnz": int(np.diff(support.indptr).max()),
              "blocks": bsr.num_blocks,
              "mask_bytes": bsr.blocks.numel() * 4,
              "row_list_build_s": row_s, "col_list_build_s": col_s,
              "row_list_edges": int(att.mask_row_lists(bsr)[1].numel()),
              "col_list_edges": int(att.mask_col_lists(bsr)[1].numel()),
              "s": time.perf_counter() - t0})
        for H, F in GAT_WIDTHS:
            t0 = time.perf_counter()
            f1, f2 = (att.pad_rows(torch.randn(n, H, generator=gen,
                                               device=device), n_pad)
                      for _ in range(2))
            h, g = (att.pad_rows(torch.randn(n, H * F, generator=gen,
                                              device=device), n_pad)
                    for _ in range(2))
            kw = dict(num_heads=H, feat=F)
            # the stats and D of the plain forward feed both backward passes
            out0, m0, l0 = att.gat_fwd_stats_plain(bsr, f1, f2, h, **kw)
            d = att.head_dots(g, out0, H, F)
            bwd = (bsr, f1, f2, h, g, m0, l0, d)
            calls = {
                "gat_fwd_stats": (
                    lambda: att.gat_fwd_stats(bsr, f1, f2, h, **kw),
                    lambda: att.gat_fwd_stats_plain(bsr, f1, f2, h, **kw)),
                "gat_bwd_row": (
                    lambda: att.gat_bwd_row(*bwd, **kw),
                    lambda: att.gat_bwd_row_plain(*bwd, **kw)),
                "gat_bwd_col": (
                    lambda: att.gat_bwd_col(*bwd, **kw),
                    lambda: att.gat_bwd_col_plain(*bwd, **kw)),
            }
            refs = {}
            for kernel, (run, plain) in calls.items():
                refs[kernel] = _tuple(plain())
                err, tol = _max_err(f"{kernel} {gname} H={H} F={F}",
                                    _tuple(run()), refs[kernel], TOL)
                torch.cuda.synchronize()
                bound_ms, bound_by = _gat_bounds(kernel, E, n, H, F)
                # each walks its lists in work items; the eager call is
                # bound by the wrapper's host work, so the device time is
                # taken in a CUDA graph
                case = dict(kernel=kernel, graph=gname, n=n, support_nnz=E,
                            H=H, F=F, max_abs_err=err, tol=tol,
                            kernel_ms=time_ms(run, 20),
                            device_ms=time_graph_ms(run),
                            plain_ms=time_ms(plain, 5),
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None,
                            # 16-byte rows: the kernels' vector loads
                            aligned16=all(t.data_ptr() % 16 == 0
                                          for t in (h, g)),
                            **_coo_items_shape(kernel, items[kernel], H, F))
                case["s"] = time.perf_counter() - t0
                emit(case)
                results[kernel].append(case)
            if gname == "cora_shaped" and H == 8:
                mask_row_sweep(bsr, f1, f2, h, bwd, H, F, refs)
    return results


def _combine_bounds(E, n_in, n_out, H, f, aug):
    """The least work of one weighted combine: each edge's row and column
    (8 B) and its weights (4 B a head, twice in the augmented form) read
    once, x read once, the output written once; 2 f32 ops an edge and
    column."""
    nbytes = E * (8 + 4 * H * (2 if aug else 1)) + 4 * (n_in + n_out) * f
    return _bound(nbytes, 2 * E * f, "float32")


def _bmm_library_ms(ga, wf, x, H, F):
    """The one PyTorch call that computes the plain combine over the
    transpose tables: a batched sparse [H, m, n] product with x as
    [H, n, F] (torch.bmm of a sparse COO batch)."""
    import torch

    E = ga.num_edges
    k = torch.arange(H, device=x.device).repeat_interleave(E)
    idx = torch.stack([k, ga.cols.repeat(H), ga.rows.repeat(H)])
    a = torch.sparse_coo_tensor(idx, wf.T.reshape(-1),
                                (H, ga.num_src, ga.n)).coalesce()
    xb = x.reshape(-1, H, F).permute(1, 0, 2).contiguous()
    return time_ms(lambda: torch.bmm(a, xb), 20)


def _combine_shape(ga, gs, f, warps=None):
    """The combine's work items over ``gs`` (``ga``'s forward or transpose
    tables; a heavy stripe is spread over several), its columns a thread
    block and warps."""
    from h2gcn_tpu_torch.sparse import attention_gather as gat

    items = ga.items_fwd if gs is ga.fwd else ga.items_bwd
    slots = np.concatenate([np.diff(ptr.cpu().numpy()) * gs.e_b
                            for ptr, _ in items])
    stripe_slots = np.concatenate([np.diff(seg.chunk_ptr.cpu().numpy())
                                   * gs.e_b for seg in gs.segments])
    return {"tile": gs.tile, "width": gat.combine_width(gs.tile, f),
            "warps": warps or gat.COMBINE_WARPS,
            "work_items": int(slots.size),
            "max_slots_per_item": int(slots.max()),
            "max_stripe_slots": int(stripe_slots.max())}


# the combine's geometry sweep at the 10K graph's layer 1: the gather
# tables' tile x the warps of a thread block
SWEEP_COMBINE_TILES = (128, 512)
SWEEP_COMBINE_WARPS = (16, 32)


def combine_sweep(support, combines, H, device):
    """The weighted combine's forward (augmented) and dh combines over the
    tables' tile and the warps a thread block: the sweep that set
    ``GATHER_TILE`` and ``COMBINE_WARPS``. ``combines`` holds each
    combine's (tables, slot map, weights, x, wl) at the default tile; the
    weights are per edge and serve any tile."""
    from h2gcn_tpu_torch.sparse import attention_gather as gat

    for tile in SWEEP_COMBINE_TILES:
        t0 = time.perf_counter()
        ga = gat.build_gatherattn(support, tile=tile, device=device)
        build_s = time.perf_counter() - t0
        for cname in ("forward", "dh"):
            _, _, wf, x, wl = combines[cname]
            gs, s2e, items = ((ga.fwd, ga.slot2edge_fwd, ga.items_fwd)
                              if cname == "forward"
                              else (ga.bwd, ga.slot2edge_bwd, ga.items_bwd))
            for warps in SWEEP_COMBINE_WARPS:
                emit(dict(_combine_shape(ga, gs, x.shape[1], warps),
                          combine_sweep=cname, graph="syn10k", H=H,
                          x_cols=x.shape[1],
                          kernel_ms=time_ms(lambda: gat.gscatter_weighted(
                              gs, s2e, wf, x, num_heads=H, wl=wl,
                              items=items, warps=warps), 20),
                          build_s=build_s, s=time.perf_counter() - t0))
        del ga


# the forward's and the column pass's work-item sweep at the 10K graph's
# layer 1: edges an item x items (warps) a thread block, then the cost of a
# row in edges at the default budget and warps
SWEEP_COO_BUDGETS = (32, 64, 128, 256)
SWEEP_COO_WARPS = (4, 8, 16)
SWEEP_COO_ROW_COSTS = (0, 8, 16, 32)
# the COO-chunk kernels, each walking per-row (per-column) lists in work
# items of this kind
_COO_ITEMS = {"coo_fwd_stats": "fwd", "coo_bwd_row": "fwd",
              "coo_bwd_col": "col"}
# the floats a split row's piece writes to the workspace at H heads of F
_PIECE_FLOATS = {"coo_fwd_stats": lambda H, F: H * (2 + F),
                 "coo_bwd_row": lambda H, F: H,
                 "coo_bwd_col": lambda H, F: H * (1 + F),
                 "gat_fwd_stats": lambda H, F: H * (2 + F),
                 "gat_bwd_row": lambda H, F: H,
                 "gat_bwd_col": lambda H, F: H * (1 + F)}


def _coo_items_shape(kernel, it, H, F, warps=None):
    """The work items ``it`` that ``kernel`` launches over: edges an item,
    items a block, a row's cost, how many, the rows cut into pieces and the
    workspace the pieces' partial states take at H heads of F."""
    from h2gcn_tpu_torch.sparse import attention_coo as coo

    per_piece = _PIECE_FLOATS[kernel](H, F)
    return {"budget": it.budget, "warps": warps or coo.ITEM_WARPS,
            "row_cost": it.row_cost, "work_items": it.n_items,
            "max_rows_per_item": int((it.items[:, 1]
                                      - it.items[:, 0]).max()),
            "split_rows": it.n_split,
            "pieces": it.n_pieces,
            "workspace_bytes": 4 * it.n_pieces * per_piece}


def coo_sweep(ac, calls, H, F):
    """The COO-chunk kernels' device times over edges an item x warps a
    block, then over the cost of a row (``coo_sweep`` lines, "highest"):
    the sweep that set ``EDGE_BUDGET``, ``ITEM_WARPS`` and ``ROW_COST``."""
    from h2gcn_tpu_torch.sparse import attention_coo as coo

    points = [(b, None, w) for b in SWEEP_COO_BUDGETS
              for w in SWEEP_COO_WARPS]
    points += [(None, c, None) for c in SWEEP_COO_ROW_COSTS
               if c != coo.ROW_COST]
    for kernel, kind in _COO_ITEMS.items():
        run = calls[kernel][0]
        for budget, cost, warps in points:
            t0 = time.perf_counter()
            it = coo.edge_items(ac, kind, budget, cost)
            emit(dict(_coo_items_shape(kernel, it, H, F, warps),
                      coo_sweep=kernel,
                      graph="syn10k", H=H, F=F,
                      device_ms=time_graph_ms(lambda: run(items=it,
                                                          warps=warps)),
                      s=time.perf_counter() - t0))


def check_gat_scale_kernels(device):
    """Phase 7: the COO-chunk attention kernels and the weighted combine
    against their plain versions, timed, at the shapes GAT takes past the
    BSR budget; and one attention layer through each payload. Returns
    ({kernel: [case dicts]}, [crossover dicts])."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix
    from h2gcn_tpu_torch.sparse import attention as att
    from h2gcn_tpu_torch.sparse import attention_coo as coo
    from h2gcn_tpu_torch.sparse import attention_gather as gat

    graphs = {"syn10k": self_looped(build_graph()),
              "cora_shaped": self_looped(cora_graph())}
    gen = torch.Generator(device=device).manual_seed(2)
    results = {"coo_fwd_stats": [], "coo_bwd_row": [], "coo_bwd_col": [],
               "gscatter_weighted": []}
    b5_name = {"coo_fwd_stats": "gat_fwd_stats",
               "coo_bwd_row": "gat_bwd_row", "coo_bwd_col": "gat_bwd_col"}
    crossover = []
    for gname, support in graphs.items():
        t0 = time.perf_counter()
        ac = coo.build_attn_coo(support, device=device)
        ga = gat.build_gatherattn(support, device=device)
        bsr = SparseMatrix.from_scipy(support, backend="bsr", block_size=256,
                                      device=device).bsr
        n, E = support.shape[0], support.nnz
        n_pad = ac.n_tiles * ac.tile
        emit({"graph": gname, "n": n, "support_nnz": E,
              "coo_chunks": ac.num_chunks,
              "gather_slots": ga.total_slots_fwd,
              "gather_items": [len(ga.items_fwd[0][1]),
                               len(ga.items_bwd[0][1])],
              "max_stripe_nnz": int(np.add.reduceat(
                  np.diff(support.indptr), np.arange(0, n, 512)).max()),
              "max_row_nnz": int(np.diff(support.indptr).max()),
              "s": time.perf_counter() - t0})
        for H, F in GAT_WIDTHS:
            t0 = time.perf_counter()
            f1, f2 = (torch.randn(n, H, generator=gen, device=device)
                      for _ in range(2))
            h, g = (torch.randn(n, H * F, generator=gen, device=device)
                    for _ in range(2))
            f1p, f2p, hp, gp = (att.pad_rows(t, n_pad) for t in (f1, f2, h, g))
            kw = dict(num_heads=H, feat=F)
            # the stats and D of the plain forward feed both backward passes
            out0, m0, l0 = coo.coo_fwd_stats_plain(ac, f1p, f2p, hp, **kw)
            d = att.head_dots(gp, out0, H, F)
            bwd = (ac, f1p, f2p, hp, gp, m0, l0, d)
            calls = {
                "coo_fwd_stats": (
                    lambda **k: coo.coo_fwd_stats(ac, f1p, f2p, hp, **kw, **k),
                    lambda: coo.coo_fwd_stats_plain(ac, f1p, f2p, hp, **kw)),
                "coo_bwd_row": (
                    lambda **k: coo.coo_bwd_row(*bwd, **kw, **k),
                    lambda: coo.coo_bwd_row_plain(*bwd, **kw)),
                "coo_bwd_col": (
                    lambda **k: coo.coo_bwd_col(*bwd, **kw, **k),
                    lambda: coo.coo_bwd_col_plain(*bwd, **kw)),
            }
            for kernel, (run, plain) in calls.items():
                what = f"{kernel} {gname} H={H} F={F}"
                ref = _tuple(plain())
                err, tol = _max_err(what, _tuple(run()), ref, TOL)
                # bf16 contraction operands against the f32 plain version
                err16, tol16 = _max_err(f"{what} default",
                                        _tuple(run(precision="default")), ref,
                                        BF16_TOL)
                torch.cuda.synchronize()
                bound_ms, bound_by = _gat_bounds(b5_name[kernel], E, n, H, F)
                case = dict(kernel=kernel, graph=gname, n=n, support_nnz=E,
                            H=H, F=F, max_abs_err=err, tol=tol,
                            default_max_abs_err=err16, default_tol=tol16,
                            kernel_ms=time_ms(run, 20),
                            default_ms=time_ms(
                                lambda: run(precision="default"), 20),
                            plain_ms=time_ms(plain, 5),
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None, s=time.perf_counter() - t0)
                if kernel in _COO_ITEMS:
                    # the wrapper's eager call above is bound by its host
                    # work; in a CUDA graph the launches run back to back
                    it = coo.edge_items(ac, _COO_ITEMS[kernel])
                    case.update(_coo_items_shape(kernel, it, H, F),
                                device_ms=time_graph_ms(run),
                                default_device_ms=time_graph_ms(
                                    lambda: run(precision="default")),
                                s=time.perf_counter() - t0)
                emit(case)
                results[kernel].append(case)
            if gname == "syn10k" and H == 8:
                coo_sweep(ac, calls, H, F)

            # the four combines of a training step, on real edge weights
            t0 = time.perf_counter()
            s_, p, live = gat._edge_terms(ga, f1, f2, 0.2)
            mask = torch.where(torch.rand(E, H, generator=gen, device=device)
                               < 0.4, 2.5, 0.0)
            q = torch.where(s_ >= 0, 1.0, 0.2) * torch.where(live, p, 0.0)
            pm, qm = (p * mask).contiguous(), (q * mask).contiguous()
            ones = torch.ones(n, H, device=device)
            gl = torch.randn(n, H, generator=gen, device=device)
            combines = {
                "forward": (ga.fwd, ga.slot2edge_fwd, pm,
                            gat._augx(h, ones, H, F), p),
                "dh": (ga.bwd, ga.slot2edge_bwd, pm, g, None),
                "df1": (ga.fwd, ga.slot2edge_fwd, qm,
                        gat._augx(h, ones, H, F), q),
                "df2": (ga.bwd, ga.slot2edge_bwd, qm,
                        gat._augx(g, gl, H, F), q),
            }
            for cname, (gs, s2e, wf, x, wl) in combines.items():
                items = ga.items_fwd if gs is ga.fwd else ga.items_bwd

                def run(gs=gs, s2e=s2e, wf=wf, x=x, wl=wl, items=items):
                    return gat.gscatter_weighted(gs, s2e, wf, x, num_heads=H,
                                                 wl=wl, items=items)

                def plain(gs=gs, s2e=s2e, wf=wf, x=x, wl=wl):
                    return gat.gscatter_weighted_plain(gs, s2e, wf, x,
                                                       num_heads=H, wl=wl)

                err, tol = _max_err(f"gscatter_weighted {cname} {gname} "
                                    f"H={H} F={F}", (run(),), (plain(),), TOL)
                torch.cuda.synchronize()
                bound_ms, bound_by = _combine_bounds(
                    E, x.shape[0], gs.n_rows, H, x.shape[1], wl is not None)
                case = dict(_combine_shape(ga, gs, x.shape[1]),
                            kernel="gscatter_weighted", combine=cname,
                            graph=gname, n=n, support_nnz=E, H=H, F=F,
                            x_cols=x.shape[1], max_abs_err=err, tol=tol,
                            kernel_ms=time_ms(run, 20),
                            # the eager call is bound by the wrapper's host
                            # work; in a CUDA graph the launches run back
                            # to back
                            device_ms=time_graph_ms(run),
                            plain_ms=time_ms(plain, 5),
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=(_bmm_library_ms(ga, wf, x, H, F)
                                        if cname == "dh" else None),
                            s=time.perf_counter() - t0)
                emit(case)
                results["gscatter_weighted"].append(case)
            if gname == "syn10k" and H == 8:
                combine_sweep(support, combines, H, device)

            # one attention layer, forward and forward + backward, through
            # each payload on the same inputs
            layers = {
                "bsr": lambda *x: att.gat_attention(bsr, *x, n_out=n, **kw),
                "coo": lambda *x: coo.gat_attention_coo(ac, *x, n_out=n,
                                                        **kw),
                "gather": lambda *x: gat.gather_attention(ga, *x, **kw),
            }
            row = dict(graph=gname, n=n, support_nnz=E, H=H, F=F)
            for payload, fn in layers.items():
                xs = [t.clone().requires_grad_(True) for t in (f1, f2, h)]

                def forward(fn=fn):
                    with torch.no_grad():
                        return fn(f1, f2, h)

                def step(fn=fn, xs=xs):
                    fn(*xs).backward(g)

                row[f"{payload}_fwd_ms"] = time_ms(forward, 10)
                row[f"{payload}_fwd_bwd_ms"] = time_ms(step, 10)
            emit(dict(row, crossover=True))
            crossover.append(row)
    return results, crossover


# the attention kernels' launch counters by route
_GAT_ROUTES = {
    "bsr": ("gat_fwd_stats", "gat_bwd_row", "gat_bwd_col"),
    "coo": ("coo_fwd_stats", "coo_bwd_row", "coo_bwd_col"),
    "gather": ("gscatter_weighted",),
}


def run_gat_cli(data_dir, name, device, attn_drop, route="bsr",
                attn_impl=None):
    """Phases 6 and 8: GAT for EPOCHS epochs through the CLI with
    ``--fused_attention`` (and ``--attn_impl``), expecting the ``route``
    payload. Returns the launch counts of the route's kernels in the run."""
    import glob

    import torch

    from h2gcn_tpu_torch import run_experiments
    from h2gcn_tpu_torch.sparse import attention_coo as coo
    from h2gcn_tpu_torch.sparse import attention_gather as gat

    t0 = time.perf_counter()
    tag = f"{name}_{attn_impl or 'auto'}_{attn_drop}"
    ckpt_dir = os.path.join(data_dir, f"ckpt_gat_{tag}")
    argv = ["GAT", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--fused_attention",
            "--attn_drop", str(attn_drop), "--epochs", str(EPOCHS),
            "--timing", "--random_seed", "123", "--checkpoint_dir", ckpt_dir]
    if attn_impl:
        argv += ["--attn_impl", attn_impl]
    before = _launch_counts(
        [k for names in _GAT_ROUTES.values() for k in names])
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    launches = _launched_since(before)
    adj = args.objects["tensors"]["adj"]
    payload = {"bsr": adj.bsr is not None,
               "coo": isinstance(adj.attn, coo.AttnCoo),
               "gather": isinstance(adj.attn, gat.GatherAttn)}
    if not payload[route]:
        raise AssertionError(f"GAT {tag}: the support took no {route} "
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
            raise AssertionError(f"GAT {tag}: {kernel} launched {count} "
                                 "times")
    if route == "gather" and launches["gscatter_weighted"] < 8 * EPOCHS:
        # training runs fused: a forward and three backward combines a
        # layer and step
        raise AssertionError(f"GAT {tag}: the combine launched only "
                             f"{launches['gscatter_weighted']} times")
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(float(stats[key])):
            raise AssertionError(f"GAT {tag}: {key} = {float(stats[key])}")
    if not glob.glob(os.path.join(ckpt_dir, "*", "ckpt.pt")):
        raise AssertionError(f"GAT {tag}: no checkpoint under {ckpt_dir}")

    # the trained weights through the kernels and through the segment path
    tensors = args.objects["tensors"]
    model = args.objects["model"]
    with torch.no_grad():
        logits = args.objects["predict_step"](**tensors)
        model.fused_attention = False
        ref = model(tensors["adj"], tensors["features"], [])
        model.fused_attention = True
    n, n_classes = tensors["y_all"].shape
    if tuple(logits.shape) != (n, n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"GAT {tag}: bad logits {tuple(logits.shape)}")
    logit_err = float((logits - ref).abs().max())
    logit_tol = TOL * max(1.0, float(ref.abs().max()))
    if logit_err > logit_tol:
        raise AssertionError(f"GAT {tag}: logits through the kernels differ "
                             f"from the segment path by {logit_err} > "
                             f"{logit_tol}")
    times = args.objects["epoch_times"]
    epoch_ms, epoch_ms_median = run_experiments.steady_epoch_ms(times)
    emit({"cli": "GAT", "graph": name, "route": route,
          "attn_impl": attn_impl or "auto", "attn_drop": attn_drop,
          "epochs": len(times), "support_nnz": tensors["adj"].nnz,
          "epoch_ms": epoch_ms, "epoch_ms_median": epoch_ms_median,
          "first_epoch_ms": 1e3 * times[0],
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches, "logit_err": logit_err,
          "logit_tol": logit_tol, "s": time.perf_counter() - t0})
    return {k: launches[k] for k in _GAT_ROUTES[route]}


# --------------------------------------------------------------------------
# Phase 13 (paths): the runtime's entry points beyond a training run
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


def _cli(argv, device, counters=None):
    """One run of ``run_experiments.main(argv)``: (args, launches, peak
    device bytes above the start, seconds)."""
    import gc

    import torch

    from h2gcn_tpu_torch import run_experiments

    gc.collect()  # earlier runs' training state (reference cycles)
    torch.cuda.empty_cache()
    before = _launch_counts(_SPMM_WRAPPERS if counters is None else counters)
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    return (args, _launched_since(before),
            torch.cuda.max_memory_allocated(device) - start,
            time.perf_counter() - t0)


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


def paths_blocked(data_dir, name, backend, device):
    """Step 1: H2GCN-2 per-epoch and with ``--epochs_per_block 5`` through
    ``backend``; per-epoch stats, the best epoch and the best parameters
    agree; then one more block of the blocked run under
    ``torch.cuda.set_sync_debug_mode("warn")`` counts its host syncs: only
    its one readback. Returns the blocked run's args and launches."""
    from h2gcn_tpu_torch.run_experiments import steady_epoch_ms

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
            args, launches, peak, secs = _cli(
                base + extra + ["--checkpoint_dir", os.path.join(
                    data_dir, f"ckpt_paths_{backend}_{mode}")], device)
        if launches[f"{backend}_spmm"] == 0:
            raise AssertionError(f"{tag} {mode}: {backend}_spmm never "
                                 "launched")
        runs[mode] = (args, launches, rec.epochs, secs)
    (pa, la, ea, _), (ba, lb, eb, _) = runs["per_epoch"], runs["blocked"]
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
    per_ms = steady_epoch_ms(pa.objects["epoch_times"])
    k0 = ba.objects["block_times"][0][0]
    blocked_ms = steady_epoch_ms(
        [t / k for k, t in ba.objects["block_times"] if k == k0])
    emit({"paths": "blocked", "graph": name, "route": backend,
          "epochs": 10, "block": 5, "best_epoch": best_b,
          "max_stat_err": stat_err, "max_param_err": param_err,
          "steady_block_syncs": syncs,
          "per_epoch_ms": per_ms[0], "per_epoch_ms_median": per_ms[1],
          "blocked_ms": blocked_ms[0], "blocked_ms_median": blocked_ms[1],
          "launches_per_epoch_run": la, "launches_blocked_run": lb})
    return ba, lb


def paths_store_and_predict(data_dir, name, device, root):
    """Step 2: a recorded run (``--use_signac``, cluster-ordered so the
    original order is not the training order) with saved activations,
    predictions and degree-accuracy records; every stored array against
    the restored model in the original node order; then
    ``python -m h2gcn_tpu_torch.predict`` from the run's checkpoint."""
    import glob
    import json as _json

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
    args, launches, peak, secs = _cli(argv, device)
    job = args.objects["signac_job"]
    if [j.id for j in get_project(root).find_jobs({"run_id": "paths"})] \
            != [job.id]:
        raise AssertionError(f"{tag}: the project does not find its job")
    with open(job.fn("results.json")) as f:
        results = _json.load(f)
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
    ckpt = ckpts[0]
    out = os.path.join(root, "preds.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "h2gcn_tpu_torch.predict", "H2GCN",
         "planetoid", "--dataset", f"ind.{name}", "--dataset_path",
         data_dir, "--sparse_backend", "gscatter", "--reorder", "cluster",
         "--restore_checkpoint", ckpt, "--output", out,
         "--checkpoint_dir", os.path.join(root, "ckpt_predict")],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    predict_s = time.perf_counter() - t0
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
          "predict_logit_tol": tol, "predict_s": predict_s,
          "launches": launches, "train_s": secs})


def _scale_factory(conf, output_dim):
    factor = float(conf)

    def fn(params, adj, x, adjhops, tagged):
        return x * factor

    return fn


def paths_dsl(data_dir, name, device):
    """Step 3: a network setup with every new DSL kind (an E-marked dense,
    a lambda, SG, a slice, I and a registered X layer) trained 5 epochs
    through gscatter; its logits against the segment path; embed_step
    against the E layer's output."""
    from h2gcn_tpu_torch.run_experiments import steady_epoch_ms

    import torch

    from h2gcn_tpu_torch.nn.model import experimental_registry

    tag = f"paths dsl {name}"
    experimental_registry["scale"] = _scale_factory
    try:
        args, launches, peak, secs = _cli(
            ["H2GCN", "planetoid", "--dataset", f"ind.{name}",
             "--dataset_path", data_dir, "--sparse_backend", "gscatter",
             "--network_setup", DSL_SETUP, "--epochs", str(EPOCHS),
             "--timing", "--random_seed", "123", "--checkpoint_dir",
             os.path.join(data_dir, "ckpt_paths_dsl")], device)
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
    ms = steady_epoch_ms(args.objects["epoch_times"])
    emit({"paths": "dsl", "graph": name, "setup": DSL_SETUP,
          "layers": names, "logit_err": logit_err, "logit_tol": logit_tol,
          "embed_err": emb_err, "epoch_ms": ms[0], "epoch_ms_median": ms[1],
          "launches": launches, "peak_mem_bytes": peak, "s": secs})


def paths_attn(data_dir, name, device):
    """Step 4: GAT on the 10K graph through the gather payload (``auto``
    past the BSR budget); attn_step's coefficients through the payload
    (its call launches the weighted combine) sum to 1 over each row's
    edges and agree with the segment path's."""
    import torch

    from h2gcn_tpu_torch.sparse import attention_gather as gat

    tag = f"paths attn {name}"
    counters = ("gscatter_weighted",)
    args, launches, peak, secs = _cli(
        ["GAT", "planetoid", "--dataset", f"ind.{name}", "--dataset_path",
         data_dir, "--fused_attention", "--epochs", "2", "--random_seed",
         "123", "--checkpoint_dir", os.path.join(data_dir,
                                                 "ckpt_paths_attn")],
        device, counters)
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
          "train_launches": launches, "s": secs})


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
    """Step 5: H2GCN-2 5 epochs through gscatter on a ``fmt`` dataset;
    finite losses, logits against the segment path, epoch time, host
    set-up seconds and peak device memory."""
    from h2gcn_tpu_torch.run_experiments import steady_epoch_ms

    tag = f"paths loader {fmt} {dataset}"
    t0 = time.perf_counter()
    args, launches, peak, secs = _cli(
        ["H2GCN", fmt, "--dataset", dataset, "--dataset_path", data_path,
         "--sparse_backend", "gscatter", "--epochs", str(EPOCHS), "--timing",
         "--random_seed", "123", "--checkpoint_dir",
         os.path.join(data_path, f"ckpt_paths_{fmt}"), *extra], device)
    if launches["gscatter_spmm"] == 0:
        raise AssertionError(f"{tag}: gscatter_spmm never launched")
    _finite(tag, args.objects["epoch_stats"])
    logits, ref = _segment_logits(args, device)
    logit_err, logit_tol = _gate(tag, "logits", logits, ref)
    tensors = args.objects["tensors"]
    ms = steady_epoch_ms(args.objects["epoch_times"])
    emit({"paths": "loader", "format": fmt, "dataset": dataset,
          "n": int(tensors["y_all"].shape[0]),
          "features": int(args.objects["dataset"].feature_dim),
          "hop_nnz": [h.nnz for h in tensors["adj_hops"]],
          "train_nodes": int(tensors["train_mask"].sum()),
          "logit_err": logit_err, "logit_tol": logit_tol,
          "epoch_ms": ms[0], "epoch_ms_median": ms[1],
          "first_epoch_ms": 1e3 * args.objects["epoch_times"][0],
          "prep_s": tensors["prep_seconds"], "peak_mem_bytes": peak,
          "launches": launches, "s": time.perf_counter() - t0})


def check_paths(data_dir, device):
    """Phase 13 (``paths``): steps 1-5 on the 10K graph (``syn10k``
    planetoid files, written by an earlier phase), the synthetic
    squirrel-sized GeomGCN files and the 10K graph as a SparseGraph npz,
    both written here from a seed."""
    paths_blocked(data_dir, "syn10k", "gscatter", device)
    paths_blocked(data_dir, "syn10k", "cootile", device)
    root = tempfile.mkdtemp(prefix="store_", dir=data_dir)
    paths_store_and_predict(data_dir, "syn10k", device, root)
    paths_dsl(data_dir, "syn10k", device)
    paths_attn(data_dir, "syn10k", device)
    t0 = time.perf_counter()
    geom = os.path.join(data_dir, "geomgcn")
    split = write_geomgcn(geom)
    sgdir = os.path.join(data_dir, "sparsegraph")
    os.makedirs(sgdir, exist_ok=True)
    write_sparsegraph(sgdir, "syn10k", build_graph())
    emit({"paths": "write_files", "s": time.perf_counter() - t0})
    paths_loader("geomgcn", "squirrel", geom,
                 ("--splits_file_path", split), device)
    paths_loader("sparsegraph", "syn10k", sgdir,
                 ("--setting", "gcn", "--split_seed", "15"), device)


# --------------------------------------------------------------------------
# Phase 14 (experiments): the experiments pipeline at syn-products' config
# --------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# the two graphs of the published syn-products config the phase sweeps
# (graph_index 1), with its split index 0
EXP_H = (0.0, 0.9)
# the setup whose child is run again in-process (H2GCN-2 with dropout)
EXP_SETUP = "M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO"
# the extra child: the same setup through #3 with the sharded precompute
EXP_EXTRA = ("H2GCN --network_setup " + EXP_SETUP + " --adj_nhood 1 2 "
             "--sparse_backend cootile --precompute_workers 4")


class _Timed:
    """Records the seconds of each call of the named functions of
    ``module`` (looked up at call time, so a caller inside the module
    calls the wrapper) as ``(name, statepoint graphName, seconds)``."""

    def __init__(self, module, names):
        self.module, self.names, self.calls = module, names, []

    def __enter__(self):
        self._orig = {n: getattr(self.module, n) for n in self.names}
        for name, fn in self._orig.items():
            def timed(job, *a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(job, *a, **kw)
                self.calls.append((_name, job.sp.get("graphName"),
                                   time.perf_counter() - t0))
                return out
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)


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
    accuracies, and launched ``kernel``; its seconds from start to exit
    against its epoch ms (``--timing``)."""
    lines = []
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
        timing = job.doc["timing"]
        if timing["launches"].get(kernel, 0) == 0:
            raise AssertionError(f"{tag}: {args} on h={graph_job.sp.h} "
                                 f"never launched {kernel}: "
                                 f"{timing['launches']}")
        line = {"experiments": tag, "h": graph_job.sp.h,
                "setup": args.split()[2], "wall_s": job.doc["wall_s"],
                # before main: the interpreter's start and the imports
                "startup_s": job.doc["wall_s"] - timing["main_s"],
                "main_s": timing["main_s"], "prep_s": timing["prep_s"],
                "epoch_ms": timing["epoch_ms"],
                "epoch_ms_median": timing["epoch_ms_median"],
                "first_epoch_ms": timing["first_epoch_ms"],
                "epochs_s": 1e-3 * (timing["first_epoch_ms"] + (
                    timing["epochs"] - 1) * timing["epoch_ms"]),
                "launches": timing["launches"],
                "train_acc": accs[0], "val_acc": accs[1],
                "test_accuracy": accs[2]}
        emit(line)
        lines.append(line)
    return lines


def exp_split_check(name, adj):
    """The exact-hop split [I, A1, A2] over 4 host workers (threads, the
    path of ``--precompute_workers 4``) against one worker, entry for
    entry; the seconds of each and the halo volumes."""
    from h2gcn_tpu_torch.parallel.spgemm import dist_nhood_split
    from h2gcn_tpu_torch.sparse import transforms

    t0 = time.perf_counter()
    one = transforms.nhood_split(adj, 2)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four, stats = dist_nhood_split(adj, 2, n_workers=4, return_stats=True)
    four_s = time.perf_counter() - t0
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
          "hop_nnz": [int(m.nnz) for m in one], "workers_1_s": one_s,
          "workers_4_s": four_s, "rounds": stats.rounds,
          "halo_rows": stats.halo_rows, "halo_bytes": stats.halo_bytes,
          "total_halo_bytes": stats.total_halo_bytes,
          "shard_nnz": stats.shard_nnz})


def check_experiments(device):
    """Phase 14 (``experiments``): ``python -m
    h2gcn_tpu_torch.experiments`` at the published syn-products config
    (two of its graphs, h = 0.0 and 0.9, split index 0) on the card:
    init and generate; a sweep of ``configs/syn-products/h2gcn.json`` (its
    four H2GCN setups at hidden 64) with ``-p 2 --epochs 5 --extra_args
    --timing``: 8 children through #1 (``auto``); a second sweep that
    spawns none; summarize (8 rows); one extra child through #3 with
    ``--precompute_workers 4``; the stored logits of the h = 0.9 EXP_SETUP
    child against an in-process run of its argv and that run's segment
    path; the split at 4 workers against 1 on the 10K and 250K graphs.
    The project stays under ``chiprun_out/experiments``."""
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
    t0 = time.perf_counter()
    exp_main(["init", root, "-c", gen_cfg])
    ops = ("generate_graph", "calculate_statistics", "generate_feature",
           "generate_split")
    with _Timed(generation, ops) as timed:
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
         "homoEdgeRatio": j.doc["homoEdgeRatio"],
         "seconds": {op: sum(s for o, g, s in timed.calls
                             if o == op and g == j.sp.graphName)
                     for op in ops}} for j in graphs],
        "s": time.perf_counter() - t0})

    # step 2: the sweep, 8 children on the card through #1
    t0 = time.perf_counter()
    exp_main(["sweep", root, "-c", sweep_cfg, "-p", "2", "--epochs",
              str(EPOCHS), "--extra_args=--timing"])
    runs, log_bytes = _exp_state(root, config)
    sweep_s = time.perf_counter() - t0
    if len(runs) != 2 * len(config["model_args"]):
        raise AssertionError(f"experiments: the sweep spawned {len(runs)} "
                             "children, not 8")
    children = _exp_children("sweep_child", runs, "gscatter_spmm")
    emit({"experiments": "sweep", "graphs": len(graphs),
          "children": len(runs),
          "children_wall_s": sum(c["wall_s"] for c in children),
          "children_epochs_s": sum(c["epochs_s"] for c in children),
          "s": sweep_s})

    # step 3: a second sweep finds every run done and spawns nothing (a
    # child would add a run or, run again, append to its split's log)
    t0 = time.perf_counter()
    exp_main(["sweep", root, "-c", sweep_cfg, "-p", "2", "--epochs",
              str(EPOCHS), "--extra_args=--timing"])
    again, again_bytes = _exp_state(root, config)
    spawned = len(again) - len(runs)
    if spawned or again_bytes != log_bytes:
        raise AssertionError("experiments: the second sweep spawned a child")
    emit({"experiments": "resweep", "children": spawned,
          "s": time.perf_counter() - t0})

    # step 4: summarize
    t0 = time.perf_counter()
    out_csv = os.path.join(base, "results.csv")
    exp_main(["summarize", root, "-f", sweep_cfg, "-o", out_csv])
    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != len(runs):
        raise AssertionError(f"experiments: summarize wrote {len(rows)} "
                             f"rows, not {len(runs)}")
    emit({"experiments": "summarize", "rows": len(rows),
          "columns": list(rows[0]), "s": time.perf_counter() - t0})

    # step 5: the extra child, through #3 with the sharded precompute
    t0 = time.perf_counter()
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
    emit({"experiments": "extra", "children": 1,
          "s": time.perf_counter() - t0})

    # step 6: the h = 0.9 EXP_SETUP child's stored logits against the same
    # argv run in-process (its own store) and that run's segment path
    t0 = time.perf_counter()
    (_, split_job, fg_name, args_str, run_id, job), = [
        r for r in runs if r[0].sp.h == EXP_H[1] and EXP_SETUP in r[3]]
    argv = workflow.dataset_args(args_str, split_job, fg_name, run_id)
    argv[argv.index("--signac_root") + 1] = os.path.join(base, "in_process")
    argv += ["--epochs", str(EPOCHS), "--timing"]
    args, launches, _, secs = _cli(argv, device)
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
          "tol": max(run_tol, seg_tol), "in_process_s": secs,
          "launches": launches, "s": time.perf_counter() - t0})

    # step 7: the split at 4 workers against 1, at 10K and 250K nodes
    t0 = time.perf_counter()
    adj_lists, _, _ = generation.load_graph_artifacts(graphs[1])
    exp_split_check(graphs[1].sp.graphName, adj_lists_to_scipy(adj_lists))
    exp_split_check("syn250k", scale_graph())
    emit({"experiments": "splits", "s": time.perf_counter() - t0})


# One turn of the A/B comparison, run by ``python3 -c`` from the root of a
# tree (this one, or another commit's unpacked beside it): the COO-chunk
# kernels at the 10K graph's layer 1, "highest" (CUDA-event means of 20
# eager calls), and B5's three kernels at the Cora-shaped graph's layer 1
# (also as device time in a CUDA graph), then GAT for EPOCHS epochs through
# the CLI on the Cora-shaped graph (the BSR payload, ``--attn_drop 0``) and
# with ``--attn_impl coo`` on the 10K graph; with ``profile`` on argv, those
# two CLI runs are profiled instead (epochs 3-5) and summarized. Uses only
# what both trees have.
_AB_TURN = r"""
import json, os, shutil, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as c
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.sparse import SparseMatrix, _build, attention as att
from h2gcn_tpu_torch.sparse import attention_coo as coo

dev = run_experiments.resolve_device("cuda")
sup = c.self_looped(c.build_graph())
ac = coo.build_attn_coo(sup, device=dev)
n, n_pad = sup.shape[0], ac.n_tiles * ac.tile
gen = torch.Generator(device=dev).manual_seed(2)
H, F = 8, 8
f1, f2 = (att.pad_rows(torch.randn(n, H, generator=gen, device=dev), n_pad)
          for _ in range(2))
h, g = (att.pad_rows(torch.randn(n, H * F, generator=gen, device=dev),
                     n_pad) for _ in range(2))
kw = dict(num_heads=H, feat=F)
out, m, l = coo.coo_fwd_stats_plain(ac, f1, f2, h, **kw)
d = att.head_dots(g, out, H, F)
bwd = (ac, f1, f2, h, g, m, l, d)
c.emit({"ab_kernels_ms": {
    "coo_fwd_stats": c.time_ms(lambda: coo.coo_fwd_stats(ac, f1, f2, h, **kw),
                               20),
    "coo_bwd_row": c.time_ms(lambda: coo.coo_bwd_row(*bwd, **kw), 20),
    "coo_bwd_col": c.time_ms(lambda: coo.coo_bwd_col(*bwd, **kw), 20)}})
# B5's kernels at the Cora-shaped graph's layer 1, eager and in a CUDA
# graph (both trees' wrappers launch without host synchronization)
cora = c.self_looped(c.cora_graph())
bsr = SparseMatrix.from_scipy(cora, backend="bsr", block_size=256,
                              device=dev).bsr
nc, ncp = cora.shape[0], bsr.n_row_blocks * bsr.block_size
cf1, cf2 = (att.pad_rows(torch.randn(nc, H, generator=gen, device=dev), ncp)
            for _ in range(2))
ch, cg = (att.pad_rows(torch.randn(nc, H * F, generator=gen, device=dev),
                       ncp) for _ in range(2))
cout, cm, cl = att.gat_fwd_stats_plain(bsr, cf1, cf2, ch, **kw)
cbwd = (bsr, cf1, cf2, ch, cg, cm, cl, att.head_dots(cg, cout, H, F))
b5 = {"gat_fwd_stats": lambda: att.gat_fwd_stats(bsr, cf1, cf2, ch, **kw),
      "gat_bwd_row": lambda: att.gat_bwd_row(*cbwd, **kw),
      "gat_bwd_col": lambda: att.gat_bwd_col(*cbwd, **kw)}
c.emit({"ab_b5": {k: {"kernel_ms": c.time_ms(fn, 20),
                      "device_ms": c.time_graph_ms(fn)}
                  for k, fn in b5.items()}})
_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
data = tempfile.mkdtemp(prefix="ab_", dir=_build.BUILD_DIR)
try:
    c.write_planetoid(data, "syncora", c.cora_graph())
    c.write_planetoid(data, "syn10k", c.build_graph())
    runs = (("syncora", ()), ("syn10k", ("--attn_impl", "coo")))
    if "profile" in sys.argv:
        from h2gcn_tpu_torch import trace_summary
        for name, extra in runs:
            trace = os.path.join(data, "trace_" + name)
            run_experiments.main([
                "GAT", "planetoid", "--dataset", "ind." + name,
                "--dataset_path", data, "--fused_attention", "--attn_drop",
                "0", "--epochs", str(c.EPOCHS), "--random_seed", "123",
                *extra, "--checkpoint_dir", os.path.join(data, "ckpt"),
                "--profile_dir", trace])
            with open(os.path.join(trace, "trace.json")) as f:
                c.emit({"ab_profile": trace_summary.summarize(json.load(f),
                                                              3),
                        "graph": name})
    else:
        c.run_gat_cli(data, "syncora", dev, 0)
        c.run_gat_cli(data, "syn10k", dev, 0, route="coo", attn_impl="coo")
finally:
    shutil.rmtree(data, ignore_errors=True)
"""


# --------------------------------------------------------------------------
# Phase 15 (distributed): the distributed layer on the card
# --------------------------------------------------------------------------

DIST_SHARDS = 4  # the shards of the per-shard holds
DIST_MODES = ("ring", "allgather", "halo", "halo-cootile")


def _receive_buffers(send_idx, xs):
    """Each shard's receive buffer, built from the send tables without a
    collective: row ``s*H + i`` is shard ``s``'s row ``send_idx[s, d, i]``."""
    import torch

    D = len(xs)
    idx = torch.from_numpy(send_idx.astype(np.int64)).to(xs[0].device)
    return [torch.cat([xs[s][idx[s, d]] for s in range(D)]) for d in range(D)]


def dist_spmm_holds(mats, device):
    """B3 through every shard of the D = 4 halo-cootile partition of the
    10K graph's A1 and A2 at F = 64 and 128: each shard's interior and halo
    reduce, forward and Aᵀg, against the plain version, and the shards'
    outputs put together against scipy's A x. A line a shard with its
    halo, its bytes, its matrices' entries and chunks and the device time
    of its two reduces in a CUDA graph."""
    import torch

    from h2gcn_tpu_torch.parallel import dist as pdist
    from h2gcn_tpu_torch.parallel.mesh import Mesh
    from h2gcn_tpu_torch.sparse import spmm
    from h2gcn_tpu_torch.sparse.cootile import cootile_spmm, cootile_spmm_plain

    D = DIST_SHARDS
    gen = torch.Generator(device=device).manual_seed(5)
    for mname, mat in mats.items():
        t0 = time.perf_counter()
        hcm, n_pad = pdist.shard_matrix_halo_cootile(mat, D)
        shards = [hcm.local(Mesh(rank=d, size=D, device=device))
                  for d in range(D)]
        n, n_local, h_pad = mat.shape[0], hcm.n_local, hcm.halo
        emit({"dist_shards": mname, "D": D, "n_local": n_local,
              "h_pad": h_pad, "build_s": time.perf_counter() - t0})
        for F in (64, 128):
            t0 = time.perf_counter()
            x = torch.zeros(n_pad, F, device=device)
            x[:n] = torch.randn(n, F, generator=gen, device=device)
            g = torch.randn(n_pad, F, generator=gen, device=device)
            xs, gs = list(x.split(n_local)), list(g.split(n_local))
            recvs = _receive_buffers(hcm.send_idx, xs)
            outs = []
            for d, sh in enumerate(shards):
                errs = {}
                for part, sm, xin in (("interior", sh.interior, xs[d]),
                                      ("halo", sh.halo_mat, recvs[d])):
                    what = f"halo-cootile {mname} F={F} shard {d} {part}"
                    errs[part] = _gate(what, "outputs",
                                       cootile_spmm(sm.coot, xin),
                                       cootile_spmm_plain(sm.coot, xin))[0]
                    t = sm.transpose_view()
                    errs[f"{part}_t"] = _gate(
                        f"{what} transpose", "outputs",
                        cootile_spmm(t.coot, gs[d]),
                        cootile_spmm_plain(t.coot, gs[d]))[0]

                def local(sh=sh, d=d):
                    return spmm(sh.interior, xs[d]) + spmm(sh.halo_mat,
                                                           recvs[d])

                outs.append(local())
                emit({"dist_spmm": "halo-cootile", "matrix": mname, "F": F,
                      "shard": d, "h_pad": h_pad,
                      # the rows it receives that its edges read
                      "halo_rows": int(np.unique(hcm.halos[d].indices).size),
                      "recv_bytes": D * h_pad * F * 4,
                      "interior_nnz": sh.interior.nnz,
                      "halo_nnz": sh.halo_mat.nnz,
                      "chunks": [sh.interior.coot.num_chunks,
                                 sh.halo_mat.coot.num_chunks],
                      "max_abs_err": errs,
                      "device_ms": time_graph_ms(local)})
            got = torch.cat(outs)[:n].cpu().numpy()
            ref = mat @ x[:n].cpu().numpy()
            err = float(np.abs(got - ref).max())
            tol = TOL * max(1.0, float(np.abs(ref).max()))
            if not err <= tol:
                raise AssertionError(f"halo-cootile {mname} F={F}: the "
                                     f"shards' A x differs from scipy's by "
                                     f"{err} > {tol}")
            emit({"dist_spmm": "halo-cootile", "matrix": mname, "F": F,
                  "assembled_err": err, "tol": tol,
                  "s": time.perf_counter() - t0})


def dist_gat_holds(support, device):
    """#10 through every shard of the D = 4 dest-stripe partition of the
    self-looped 10K support at Cora's layer 1 (8 heads of 8): the four
    combines of a training step on each shard's rectangular tables against
    the plain version."""
    import torch

    from h2gcn_tpu_torch.parallel import attention as pattn
    from h2gcn_tpu_torch.parallel.mesh import Mesh
    from h2gcn_tpu_torch.sparse import attention_gather as gat

    D, (H, F) = DIST_SHARDS, GAT_WIDTHS[0]
    t0 = time.perf_counter()
    dga, _ = pattn.shard_attention_gather(support, D)
    emit({"dist_gat_shards": D, "support_nnz": support.nnz,
          "n_local": dga.n_local, "h_pad": dga.h_pad, "n_cat": dga.n_cat,
          "e_pad": dga.e_pad, "build_s": time.perf_counter() - t0})
    gen = torch.Generator(device=device).manual_seed(6)
    for d in range(D):
        t0 = time.perf_counter()
        ga = dga.local(Mesh(rank=d, size=D, device=device)).attn
        f1 = torch.randn(dga.n_local, H, generator=gen, device=device)
        f2 = torch.randn(dga.n_cat, H, generator=gen, device=device)
        h = torch.randn(dga.n_cat, H * F, generator=gen, device=device)
        g = torch.randn(dga.n_local, H * F, generator=gen, device=device)
        s_, p, live = gat._edge_terms(ga, f1, f2, 0.2)
        q = (torch.where(s_ >= 0, 1.0, 0.2)
             * torch.where(live, p, 0.0)).contiguous()
        gl = torch.randn(dga.n_local, H, generator=gen, device=device)
        ones = torch.ones(dga.n_cat, H, device=device)
        combines = {
            "forward": (ga.fwd, ga.slot2edge_fwd, p, gat._augx(h, ones, H, F),
                        p),
            "dh": (ga.bwd, ga.slot2edge_bwd, p, g, None),
            "df1": (ga.fwd, ga.slot2edge_fwd, q, gat._augx(h, ones, H, F), q),
            "df2": (ga.bwd, ga.slot2edge_bwd, q, gat._augx(g, gl, H, F), q),
        }
        line = {"dist_gat": d, "edges": int((ga.slot2edge_fwd
                                             < dga.e_pad).sum()),
                "work_items": [len(ga.items_fwd[0][1]),
                               len(ga.items_bwd[0][1])]}
        for cname, (gs, s2e, wf, x, wl) in combines.items():
            items = ga.items_fwd if gs is ga.fwd else ga.items_bwd

            def run(gs=gs, s2e=s2e, wf=wf, x=x, wl=wl, items=items):
                return gat.gscatter_weighted(gs, s2e, wf, x, num_heads=H,
                                             wl=wl, items=items)

            err, tol = _gate(f"gscatter_weighted {cname} shard {d}",
                             "outputs", run(),
                             gat.gscatter_weighted_plain(gs, s2e, wf, x,
                                                         num_heads=H, wl=wl))
            line[f"{cname}_err"], line[f"{cname}_tol"] = err, tol
            if cname in ("forward", "dh"):
                line[f"{cname}_device_ms"] = time_graph_ms(run)
        emit(dict(line, s=time.perf_counter() - t0))


# the kernels of the distributed phase's routes
_DIST_WRAPPERS = ("cootile_spmm", "gscatter_spmm", "gscatter_weighted")


def _dist_run(tag, argv, device):
    """One CLI run for the phase: (its logits, its line)."""
    import torch

    from h2gcn_tpu_torch import run_experiments

    args, launches, peak, secs = _cli(argv, device, _DIST_WRAPPERS)
    stats = args.objects["epoch_stats"]
    _finite(tag, stats)
    with torch.no_grad():
        logits = args.objects["predict_step"](**args.objects["tensors"])
    mean_ms, median_ms = run_experiments.steady_epoch_ms(
        args.objects["epoch_times"])
    return logits, {"launches": launches, "epoch_ms": mean_ms,
                    "epoch_ms_median": median_ms, "peak_mem_bytes": peak,
                    "final_val_acc": float(stats["val_acc"]), "s": secs}


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
    The logits are gated at TOL; returns the distributed runs'
    launches."""
    import torch.distributed as tdist

    from h2gcn_tpu_torch.parallel import dryrun
    from h2gcn_tpu_torch.parallel.mesh import init_group

    rendezvous = tempfile.mkdtemp(prefix="rendezvous_", dir=data_dir)
    mesh = init_group(f"file://{os.path.join(rendezvous, 'store')}", 1, 0,
                      device.type)
    emit({"dist_world": mesh.size, "backend": mesh.backend,
          "device": str(mesh.device)})
    launches = {}
    try:
        for mode in DIST_MODES + ("gat",):
            t0 = time.perf_counter()
            out = dryrun.run(1, mode=mode)
            emit({"dist_dryrun": mode, "loss": out["loss"],
                  "acc": out["acc"], "s": time.perf_counter() - t0})

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
                                         "--checkpoint_dir", ck], device)
                emit({"dist_ref": route, "model": model, **refs[route][1]})
            ck = os.path.join(data_dir, f"ckpt_dist_{tag}")
            with world_of_one():
                logits, line = _dist_run(
                    f"{model} world of one {tag}",
                    [model, *base, *flags, "--halo_mode", mode,
                     "--checkpoint_dir", ck], device)
            err, tol = _gate(f"distributed {tag}", "logits", logits,
                             refs[route][0])
            kernel = {"halo-cootile": "cootile_spmm",
                      "gat": "gscatter_weighted"}.get(tag)
            if kernel and line["launches"][kernel] == 0:
                raise AssertionError(f"distributed {tag}: {kernel} was "
                                     "never launched")
            emit({"dist_cli": tag, "model": model, "route": route,
                  "logit_err": err, "logit_tol": tol, **line})
            launches[tag] = line["launches"]

        # where a world-of-one epoch's time goes beside the one-device
        # epoch on the same kernel: a trace of epochs 3-5 of each
        from h2gcn_tpu_torch import run_experiments, trace_summary

        for tag, runtime in (("one_device", contextlib.nullcontext),
                             ("halo-cootile", world_of_one)):
            t0 = time.perf_counter()
            trace = os.path.join(data_dir, f"trace_dist_{tag}")
            with runtime():
                run_experiments.main(
                    ["H2GCN", *base, "--sparse_backend", "cootile",
                     "--halo_mode", "halo-cootile", "--checkpoint_dir",
                     os.path.join(data_dir, "ckpt_trace"),
                     "--profile_dir", trace])
            with open(os.path.join(trace, "trace.json")) as f:
                summary = trace_summary.summarize(json.load(f), 3, top=8)
            emit({"dist_profile": tag, **summary,
                  "s": time.perf_counter() - t0})
    finally:
        tdist.destroy_process_group()
    return launches


def dist_one_card(data_dir, name):
    """``--mesh_shards`` one past the card count with ``--device cuda``
    fails before it spawns a rank."""
    import torch

    n = torch.cuda.device_count() + 1
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "h2gcn_tpu_torch.run_experiments", "H2GCN",
         "planetoid", "--dataset", f"ind.{name}", "--dataset_path", data_dir,
         "--mesh_shards", str(n), "--device", "cuda"],
        capture_output=True, text=True, timeout=300)
    want = f"requested {n} devices, have {n - 1}"
    if proc.returncode == 0 or want not in proc.stderr:
        raise AssertionError(f"--mesh_shards {n}: exit {proc.returncode}, "
                             f"stderr {proc.stderr[-2000:]}")
    emit({"dist_one_card": n, "exit": proc.returncode, "message": want,
          "s": time.perf_counter() - t0})


def check_distributed(data_dir, device):
    """Phase 15: the per-shard holds of B3 and #10 at D = 4, the
    distributed runtime at world size 1 over NCCL, and the one-card
    contract of ``--mesh_shards``. Returns the runtime's launches."""
    from h2gcn_tpu_torch.sparse import transforms

    t0 = time.perf_counter()
    adj = build_graph()
    split = transforms.nhood_split(adj, 2)
    mats = {"A1": transforms.normalize(split[1]).tocsr(),
            "A2": transforms.normalize(split[2]).tocsr()}
    dist_spmm_holds(mats, device)
    dist_gat_holds(self_looped(adj), device)
    emit({"phase": "distributed_kernels", "s": time.perf_counter() - t0})
    launches = dist_runtime(data_dir, "syn10k", device)
    dist_one_card(data_dir, "syn10k")
    return launches


def ab_main(parent: str) -> int:
    """``python3 chip_smoke.py --ab DIR``: the attention kernels, the Cora
    BSR GAT epoch and the ``--attn_impl coo`` GAT epoch at 10K in this tree
    and in the tree at DIR (another commit, unpacked), in turns: DIR, this,
    this, DIR, twice (the epochs are host-bound, and the host's speed
    drifts within a call); then one profiled run of each. Prints each
    turn's lines tagged with its tree; fails if a turn fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    turns = [(name, ()) for name in ("parent", "change", "change",
                                     "parent") * 2]
    turns += [("change", ("profile",)), ("parent", ("profile",))]
    for i, (name, extra) in enumerate(turns):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _AB_TURN, *extra],
                              cwd=trees[name], capture_output=True,
                              text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"ab_turn": i, "tree": name,
                                  **json.loads(line)}), flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise AssertionError(f"A/B turn {i} ({name}) failed")
        emit({"ab_turn": i, "tree": name, "s": time.perf_counter() - t0})
    return 0


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
    _, build_s = _build.library()
    emit({"build_s": build_s, "library": _build.library_path().name,
          "s": time.perf_counter() - t0})
    # the host path of the exact-hop split and the cluster order: the
    # port's native library, not scipy's (whose RCM order differs)
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native graph library did not build or "
                             "load: the host path would be scipy's")
    emit({"host_path": "native", "library": native.library_path().name,
          "openmp_threads": native.openmp_threads(),
          "s": time.perf_counter() - t0})

    t0 = time.perf_counter()
    cases = check_kernels(device)
    emit({"phase": "kernels", "s": time.perf_counter() - t0})

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=_build.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        write_planetoid(data_dir, "syn10k", build_graph())
        emit({"phase": "planetoid", "s": time.perf_counter() - t0})
        launches = {f"{b}_spmm": run_cli(b, data_dir, "syn10k", device)
                    for b in ("gscatter", "bsr")}

        t0 = time.perf_counter()
        gat_cases = check_gat_kernels(device)
        cases.update(gat_cases)
        emit({"phase": "gat_kernels", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        write_planetoid(data_dir, "syncora", cora_graph())
        launches.update(run_gat_cli(data_dir, "syncora", device, 0))
        run_gat_cli(data_dir, "syncora", device, 0.6)
        emit({"phase": "gat_cli", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        scale_cases, _ = check_gat_scale_kernels(device)
        cases.update(scale_cases)
        emit({"phase": "gat_scale_kernels", "s": time.perf_counter() - t0})

        # the 10K graph is past the BSR budget: auto takes the gather
        # payload, which trains fused with the published attention dropout
        t0 = time.perf_counter()
        launches.update(run_gat_cli(data_dir, "syn10k", device, 0.6,
                                    route="gather"))
        run_gat_cli(data_dir, "syn10k", device, 0, route="gather")
        launches.update(run_gat_cli(data_dir, "syn10k", device, 0,
                                    route="coo", attn_impl="coo"))
        emit({"phase": "gat_scale_cli", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        cases["cootile_spmm"] = check_cootile_kernels(device)
        emit({"phase": "cootile_kernels", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        run_cli("cootile", data_dir, "syn10k", device)
        t1 = time.perf_counter()
        write_planetoid(data_dir, "syn250k", scale_graph())
        emit({"phase": "planetoid_250k", "s": time.perf_counter() - t1})
        # the slice's own path: the 250K graph, cluster-ordered, with sparse
        # features; its launches are the ones the kernels line reports
        launches["cootile_spmm"] = run_cli(
            "cootile", data_dir, "syn250k", device,
            extra=("--reorder", "cluster", "--sparse_features"))
        emit({"phase": "cootile_cli", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        for kernel, kcases in check_baseline_kernels(device).items():
            cases[kernel] += kcases
        emit({"phase": "baseline_kernels", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        for run in BASELINE_RUNS:
            run_baseline_cli(run[0], data_dir, run[1], device, *run[2:])
        emit({"phase": "baselines_cli", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        check_paths(data_dir, device)
        emit({"phase": "paths", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        check_experiments(device)
        emit({"phase": "experiments", "s": time.perf_counter() - t0})

        t0 = time.perf_counter()
        check_distributed(data_dir, device)
        emit({"phase": "distributed", "s": time.perf_counter() - t0})
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    sources = {"gscatter_spmm": ("h2gcn_tpu_torch/csrc/gscatter.cu",
                                 "h2gcn_tpu/sparse/pallas_gscatter.py:251"),
               "bsr_spmm": ("h2gcn_tpu_torch/csrc/bsr_spmm.cu",
                            "h2gcn_tpu/sparse/pallas_spmm.py:34"),
               "gat_fwd_stats": ("h2gcn_tpu_torch/csrc/gat_attention_coo.cu",
                                 "h2gcn_tpu/sparse/pallas_attention.py:143"),
               "gat_bwd_row": ("h2gcn_tpu_torch/csrc/gat_attention_coo.cu",
                               "h2gcn_tpu/sparse/pallas_attention.py:300"),
               "gat_bwd_col": ("h2gcn_tpu_torch/csrc/gat_attention_col.cu",
                               "h2gcn_tpu/sparse/pallas_attention.py:326"),
               "coo_fwd_stats": ("h2gcn_tpu_torch/csrc/gat_attention_coo.cu",
                                 "h2gcn_tpu/sparse/pallas_attention_coo.py:188"),
               "coo_bwd_row": ("h2gcn_tpu_torch/csrc/gat_attention_coo.cu",
                               "h2gcn_tpu/sparse/pallas_attention_coo.py:221"),
               "coo_bwd_col": ("h2gcn_tpu_torch/csrc/gat_attention_col.cu",
                               "h2gcn_tpu/sparse/pallas_attention_coo.py:250"),
               "gscatter_weighted": (
                   "h2gcn_tpu_torch/csrc/gscatter_weighted.cu",
                   "h2gcn_tpu/sparse/pallas_attention_gather.py:141"),
               "cootile_spmm": ("h2gcn_tpu_torch/csrc/cootile_spmm.cu",
                                "h2gcn_tpu/sparse/pallas_cootile.py:516")}
    kernels = []
    for name, (source, replaces) in sources.items():
        if name in scale_cases:
            # the headline shape: the 10K graph at layer 1's width (the
            # combine: the forward's augmented one)
            head = next(c for c in cases[name]
                        if c["graph"] == "syn10k" and c["H"] == 8
                        and c.get("combine", "forward") == "forward")
        elif name in gat_cases:
            # the headline shape: the Cora-shaped graph at layer 1's width
            head = next(c for c in cases[name]
                        if c["graph"] == "cora_shaped" and c["H"] == 8)
        else:
            # the headline shape: the 10K graph's A2, F=128, highest,
            # forward
            head = next(c for c in cases[name]
                        if c["matrix"] == "A2" and c["F"] == 128
                        and c["precision"] == "highest"
                        and c["direction"] == "forward")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            # the kernels timed in a CUDA graph: that (device) time
            "ms": head.get("device_ms", head["kernel_ms"]),
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        sys.exit(ab_main(sys.argv[2]))
    sys.exit(main())
