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
   with the table slots (gscatter) or blocks (BSR) per item; then the
   gscatter geometry sweep at A2, F = 128 (stripe tile x features a thread
   block);
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
   256-blocks;
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
   with the combine's work items and its largest item's slots, and at the
   10K graph's layer 1 the combine's sweep (``combine_sweep`` lines: the
   gather tables' tile x the warps of a thread block, forward and dh);
   the COO-chunk forward and column pass walk work items over per-row
   (per-column) edge lists: each of their cases also prints its items
   (edges an item, warps a block, a row's cost, how many, the split rows
   and their pieces, the workspace bytes) and its device time in a CUDA
   graph beside the eager call's, and at the 10K graph's layer 1 their
   sweep (``coo_sweep`` lines: edges an item x warps a block, then a row's
   cost); then times one attention layer forward and forward + backward
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
11. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Every phase line carries its seconds (``"s"``). Any failure raises.

    python3 chip_smoke.py --ab DIR

compares this tree with another commit unpacked at DIR (``git archive``),
in turns DIR, this, this, DIR, twice: the COO-chunk kernels at the 10K
graph's layer 1 and the ``--attn_impl coo`` GAT epoch at 10K, then one
profiled epoch window (``--profile_dir``, summarized by
``trace_summary``) of each.
"""

from __future__ import annotations

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


def check_kernels(device):
    """Phase 3: every kernel against its plain version at the path's
    shapes. Returns {kernel: [case dicts]}."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix, spmm, transforms
    from h2gcn_tpu_torch.sparse.bsr_spmm import bsr_spmm, bsr_spmm_plain
    from h2gcn_tpu_torch.sparse.gscatter import gscatter_spmm, gscatter_spmm_plain

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
        n, m = mat.shape
        lib_a = _library_csr(mat, device)
        for kernel in ("gscatter_spmm", "bsr_spmm"):
            backend = kernel.split("_")[0]
            for precision in ("highest", "default"):
                sm = SparseMatrix.from_scipy(mat, backend=backend,
                                             precision=precision,
                                             device=device)
                smT = sm.transpose_view()
                for F in (64, 128):
                    t0 = time.perf_counter()
                    x = torch.randn(m, F, generator=gen, device=device)
                    g = torch.randn(n, F, generator=gen, device=device)
                    if backend == "gscatter":
                        def run(x=x, sm=sm):
                            return gscatter_spmm(sm.gsc, x,
                                                 precision=sm.precision)

                        def plain(a, v, prec=precision):
                            return gscatter_spmm_plain(a.gsc, v,
                                                       precision=prec)
                    else:
                        def run(x=x, sm=sm):
                            return bsr_spmm(sm.bsr, x, n_out=n,
                                            precision=sm.precision)

                        def plain(a, v, prec=precision):
                            return bsr_spmm_plain(a.bsr, v, n_out=a.shape[0],
                                                  precision=prec)
                    xr = x.clone().requires_grad_(True)
                    y = spmm(sm, xr)
                    y.backward(g)
                    torch.cuda.synchronize()
                    for direction, got, ref in (
                            ("forward", y.detach(), plain(sm, x)),
                            ("backward", xr.grad, plain(smT, g))):
                        if got.shape != ref.shape or not torch.isfinite(got).all():
                            raise AssertionError(
                                f"{kernel} {mname} F={F} {precision} "
                                f"{direction}: bad output {tuple(got.shape)}")
                        err = float((got - ref).abs().max())
                        tol = TOL * max(1.0, float(ref.abs().max()))
                        case = dict(kernel=kernel, matrix=mname, nnz=mat.nnz,
                                    F=F, precision=precision,
                                    direction=direction, max_abs_err=err,
                                    tol=tol)
                        if err > tol:
                            emit(case)
                            raise AssertionError(
                                f"{kernel} disagrees with its plain version: "
                                f"{case}")
                        if direction == "forward":
                            case.update(_times(kernel, sm, x, run, plain,
                                               lib_a, precision))
                        case["s"] = time.perf_counter() - t0
                        emit(case)
                        results[kernel].append(case)
        if mname == "A2":
            gscatter_sweep(mat, device, gen)
    return results


# B1's geometry sweep: stripe tile -> the features a thread block takes
SWEEP_GSCATTER = {128: (64, 128), 256: (64, 128), 512: (32, 64)}


def gscatter_sweep(mat, device, gen):
    """The gscatter kernel at the 10K A2, F = 128, "highest", over the
    stripe tile and the features one thread block takes (tile x width f32
    of shared memory): the sweep that set the card's geometry."""
    import torch

    from h2gcn_tpu_torch.sparse.gscatter import build_gscatter, gscatter_spmm

    x = torch.randn(mat.shape[1], 128, generator=gen, device=device)
    for tile, widths in SWEEP_GSCATTER.items():
        t0 = time.perf_counter()
        gs = build_gscatter(mat, tile=tile, device=device)
        build_s = time.perf_counter() - t0
        for width in widths:
            emit(dict(_gscatter_shape(gs, 128, device, width),
                      gscatter_sweep="A2", F=128, precision="highest",
                      kernel_ms=time_ms(lambda: gscatter_spmm(
                          gs, x, width=width), 20),
                      build_s=build_s, s=time.perf_counter() - t0))
        del gs


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
        shape_info = _gscatter_shape(sm.gsc, F, x.device)
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


def _gscatter_shape(gs, F, device, width=None):
    """What sets a gscatter SpMM's work beside its edges: the heaviest
    stripe, and the work items the kernel launches (each walks at most a
    budget of table slots; a heavy stripe is spread over several)."""
    from h2gcn_tpu_torch.sparse.gscatter import work_items

    w, launches = work_items(gs, F, device, width)
    slots = np.concatenate([np.diff(ptr.cpu().numpy()) * lv.e_b
                            for lv, _, ptr, _ in launches])
    stripe_slots = np.concatenate([np.diff(seg.chunk_ptr.cpu().numpy())
                                   * lv.e_b for lv, seg, _, _ in launches])
    return {"tile": gs.tile, "width": w, "launches": len(launches),
            "work_items": int(slots.size),
            "max_slots_per_item": int(slots.max()),
            "mean_slots_per_item": float(slots.mean()),
            "max_stripe_slots": int(stripe_slots.max())}


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

    from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
    from h2gcn_tpu_torch.sparse.cootile import cootile_spmm, cootile_spmm_plain

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
            sT = s.transpose_view()
            for F in (64, 128):
                t0 = time.perf_counter()
                x = torch.randn(m, F, generator=gen, device=device)
                g = torch.randn(n, F, generator=gen, device=device)
                xr = x.clone().requires_grad_(True)
                y = spmm(s, xr)
                y.backward(g)
                torch.cuda.synchronize()

                def run(x=x, s=s):
                    return cootile_spmm(s.coot, x, precision=s.precision)

                def plain(a, v, prec=precision):
                    return cootile_spmm_plain(a.coot, v, precision=prec)

                for direction, got, ref in (
                        ("forward", y.detach(), plain(s, x)),
                        ("backward", xr.grad, plain(sT, g))):
                    if got.shape != ref.shape or not torch.isfinite(got).all():
                        raise AssertionError(
                            f"cootile_spmm {mname} F={F} {precision} "
                            f"{direction}: bad output {tuple(got.shape)}")
                    err = float((got - ref).abs().max())
                    tol = TOL * max(1.0, float(ref.abs().max()))
                    case = dict(kernel="cootile_spmm", matrix=mname,
                                nnz=sm.nnz, F=F, precision=precision,
                                direction=direction, max_abs_err=err,
                                tol=tol)
                    if err > tol:
                        emit(case)
                        raise AssertionError("cootile_spmm disagrees with "
                                             f"its plain version: {case}")
                    if direction == "forward":
                        case.update(_times("cootile_spmm", s, x, run, plain,
                                           lib_a, precision))
                    case["s"] = time.perf_counter() - t0
                    emit(case)
                    results.append(case)
                del x, g, xr, y
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
    from h2gcn_tpu_torch.sparse.bsr_spmm import bsr_spmm
    from h2gcn_tpu_torch.sparse.cootile import cootile_spmm
    from h2gcn_tpu_torch.sparse.gscatter import gscatter_spmm

    t0 = time.perf_counter()
    tag = " ".join([name, backend, *extra])
    ckpt_dir = os.path.join(data_dir, f"ckpt_{name}_{backend}")
    argv = ["H2GCN", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--sparse_backend", backend,
            "--epochs", str(EPOCHS), "--timing", "--random_seed", "123",
            "--checkpoint_dir", ckpt_dir, *extra]
    counters = {"gscatter_spmm": gscatter_spmm, "bsr_spmm": bsr_spmm,
                "cootile_spmm": cootile_spmm}
    for counter in counters.values():
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated(device)
    launches = {k: c.launches for k, c in counters.items()}
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


def check_gat_kernels(device):
    """Phase 5: the GAT attention kernels against their plain versions,
    timed. Returns {kernel: [case dicts]}."""
    import torch

    from h2gcn_tpu_torch.sparse import SparseMatrix
    from h2gcn_tpu_torch.sparse import attention as att

    # the same Cora shape without hubs tells the mask scan (the same 121
    # blocks) from the serial walk of a hub row
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
        emit({"graph": gname, "n": n, "support_nnz": E, "block_size": 256,
              "max_row_nnz": int(np.diff(support.indptr).max()),
              "blocks": bsr.num_blocks,
              "mask_bytes": bsr.blocks.numel() * 4,
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
            for kernel, (run, plain) in calls.items():
                err, tol = _max_err(f"{kernel} {gname} H={H} F={F}",
                                    _tuple(run()), _tuple(plain()), TOL)
                torch.cuda.synchronize()
                bound_ms, bound_by = _gat_bounds(kernel, E, n, H, F)
                case = dict(kernel=kernel, graph=gname, n=n, support_nnz=E,
                            H=H, F=F, max_abs_err=err, tol=tol,
                            kernel_ms=time_ms(run, 20),
                            plain_ms=time_ms(plain, 5),
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None,
                            s=time.perf_counter() - t0)
                emit(case)
                results[kernel].append(case)
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
# the kernels that walk per-row (per-column) lists in work items
_COO_ITEMS = {"coo_fwd_stats": "fwd", "coo_bwd_col": "col"}


def _coo_items_shape(it, H, F, warps=None):
    """The work items ``it`` the forward or the column pass launches over:
    edges an item, items a block, a row's cost, how many, the rows cut into
    pieces and the workspace the pieces' partial states take at H heads of
    F."""
    from h2gcn_tpu_torch.sparse import attention_coo as coo

    per_piece = H * (2 + F) if it.kind == "fwd" else H * (1 + F)
    return {"budget": it.budget, "warps": warps or coo.ITEM_WARPS,
            "row_cost": it.row_cost, "work_items": it.n_items,
            "max_rows_per_item": int((it.items[:, 1]
                                      - it.items[:, 0]).max()),
            "split_rows": it.n_split,
            "pieces": it.n_pieces,
            "workspace_bytes": 4 * it.n_pieces * per_piece}


def coo_sweep(ac, calls, H, F):
    """The forward's and the column pass's device times over edges an item
    x warps a block, then over the cost of a row (``coo_sweep`` lines,
    "highest"): the sweep that set ``EDGE_BUDGET``, ``ITEM_WARPS`` and
    ``ROW_COST``."""
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
            emit(dict(_coo_items_shape(it, H, F, warps), coo_sweep=kernel,
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
              "coo_max_tile_slots": max(sg.max_tile_slots for sg in ac.fwd),
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
                    case.update(_coo_items_shape(it, H, F),
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
    from h2gcn_tpu_torch.sparse import attention as att
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
    counters = {fn.__name__: fn for fn in (
        att.gat_fwd_stats, att.gat_bwd_row, att.gat_bwd_col,
        coo.coo_fwd_stats, coo.coo_bwd_row, coo.coo_bwd_col,
        gat.gscatter_weighted)}
    for fn in counters.values():
        fn.launches = 0
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
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


# One turn of the A/B comparison, run by ``python3 -c`` from the root of a
# tree (this one, or another commit's unpacked beside it): the COO-chunk
# kernels at the 10K graph's layer 1, "highest" (CUDA-event means of 20
# eager calls), then GAT for EPOCHS epochs through the CLI with
# ``--attn_impl coo``; with ``profile`` on argv, that CLI run is profiled
# instead (epochs 3-5) and summarized. Uses only what both trees have.
_AB_TURN = r"""
import json, os, shutil, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as c
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.sparse import _build, attention as att
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
_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
data = tempfile.mkdtemp(prefix="ab_", dir=_build.BUILD_DIR)
try:
    c.write_planetoid(data, "syn10k", c.build_graph())
    if "profile" in sys.argv:
        trace = os.path.join(data, "trace")
        run_experiments.main([
            "GAT", "planetoid", "--dataset", "ind.syn10k", "--dataset_path",
            data, "--fused_attention", "--attn_drop", "0", "--epochs",
            str(c.EPOCHS), "--random_seed", "123", "--attn_impl", "coo",
            "--checkpoint_dir", os.path.join(data, "ckpt"), "--profile_dir",
            trace])
        from h2gcn_tpu_torch import trace_summary
        with open(os.path.join(trace, "trace.json")) as f:
            c.emit({"ab_profile": trace_summary.summarize(json.load(f), 3)})
    else:
        c.run_gat_cli(data, "syn10k", dev, 0, route="coo", attn_impl="coo")
finally:
    shutil.rmtree(data, ignore_errors=True)
"""


def ab_main(parent: str) -> int:
    """``python3 chip_smoke.py --ab DIR``: the COO-chunk kernels and the
    ``--attn_impl coo`` GAT epoch at 10K in this tree and in the tree at
    DIR (another commit, unpacked), in turns: DIR, this, this, DIR, twice
    (the epoch is host-bound, and the host's speed drifts within a call);
    then one profiled run of each. Prints each turn's lines tagged with its
    tree; fails if a turn fails."""
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
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    sources = {"gscatter_spmm": ("h2gcn_tpu_torch/csrc/gscatter.cu",
                                 "h2gcn_tpu/sparse/pallas_gscatter.py:251"),
               "bsr_spmm": ("h2gcn_tpu_torch/csrc/bsr_spmm.cu",
                            "h2gcn_tpu/sparse/pallas_spmm.py:34"),
               "gat_fwd_stats": ("h2gcn_tpu_torch/csrc/gat_attention.cu",
                                 "h2gcn_tpu/sparse/pallas_attention.py:143"),
               "gat_bwd_row": ("h2gcn_tpu_torch/csrc/gat_attention.cu",
                               "h2gcn_tpu/sparse/pallas_attention.py:300"),
               "gat_bwd_col": ("h2gcn_tpu_torch/csrc/gat_attention.cu",
                               "h2gcn_tpu/sparse/pallas_attention.py:326"),
               "coo_fwd_stats": ("h2gcn_tpu_torch/csrc/gat_attention_coo.cu",
                                 "h2gcn_tpu/sparse/pallas_attention_coo.py:188"),
               "coo_bwd_row": ("h2gcn_tpu_torch/csrc/gat_attention_coo.cu",
                               "h2gcn_tpu/sparse/pallas_attention_coo.py:221"),
               "coo_bwd_col": ("h2gcn_tpu_torch/csrc/gat_attention_coo.cu",
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
