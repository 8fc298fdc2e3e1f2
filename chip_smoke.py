#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (h2gcn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc; exits non-zero without them. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``h2gcn_tpu_torch/csrc`` with nvcc;
3. holds each kernel (gscatter_spmm, bsr_spmm) against its plain PyTorch
   version on the card, forward and autograd backward, in both precisions,
   at the shapes of the main path: the 10K-node synthetic graph of
   bench.py (exact-hop split, symmetric normalization: A1 and A2) at the
   widths H2GCN-2 aggregates (64 and 128), plus the random-walk normalized
   A1, whose transpose payload the backward reads. Each case prints its
   error, its tolerance and the kernel's, plain version's and
   ``torch.sparse.mm``'s times beside the card's lower bound;
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
7. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Every phase line carries its seconds (``"s"``). Any failure raises.
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


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
        coo = mat.tocoo()
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            lib_a = torch.sparse_coo_tensor(
                torch.from_numpy(np.vstack([coo.row, coo.col]).astype(np.int64)),
                torch.from_numpy(coo.data.astype(np.float32)),
                (n, m), check_invariants=True).to(device).to_sparse_csr()
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
    return results


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
        # the heaviest 512-row stripe: one thread block per feature tile
        # walks all of its edges
        csr = sm.to_scipy()
        shape_info = {"max_stripe_nnz": int(np.add.reduceat(
            np.diff(csr.indptr), np.arange(0, n, sm.gsc.tile)).max())}
    else:
        # what the dense 128 x 128 blocks cost at least: the padding the
        # BSR layout adds on top of the bound
        b = sm.bsr
        dense_block_ms, _ = _bound(
            b.num_blocks * (b.block_size ** 2 * b.blocks.element_size() + 4)
            + m * F * xbytes + n * F * 4,
            2 * b.num_blocks * b.block_size ** 2 * F, dtype)
        shape_info = {"blocks": b.num_blocks,
                      "dense_block_ms": dense_block_ms}
    return dict(shape_info,
                kernel_ms=time_ms(run, 20),
                plain_ms=time_ms(lambda: plain(sm, x), 5),
                library_ms=time_ms(lambda: torch.sparse.mm(lib_a, x), 20),
                bound_ms=bound_ms, bound_by=bound_by)


def run_cli(backend, data_dir, name, device):
    """Phase 4: H2GCN-2 for EPOCHS epochs through the CLI."""
    import glob

    import torch

    from h2gcn_tpu_torch import run_experiments
    from h2gcn_tpu_torch.sparse import SparseMatrix
    from h2gcn_tpu_torch.sparse.bsr_spmm import bsr_spmm
    from h2gcn_tpu_torch.sparse.gscatter import gscatter_spmm

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(data_dir, f"ckpt_{backend}")
    argv = ["H2GCN", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--sparse_backend", backend,
            "--epochs", str(EPOCHS), "--timing", "--random_seed", "123",
            "--checkpoint_dir", ckpt_dir]
    gscatter_spmm.launches = 0
    bsr_spmm.launches = 0
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    launches = {"gscatter_spmm": gscatter_spmm.launches,
                "bsr_spmm": bsr_spmm.launches}
    kernel = f"{backend}_spmm"
    if launches[kernel] == 0:
        raise AssertionError(f"--sparse_backend {backend}: {kernel} was "
                             "never launched")
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(float(stats[key])):
            raise AssertionError(f"{backend}: {key} = {float(stats[key])}")
    if not glob.glob(os.path.join(ckpt_dir, "*", "ckpt.pt")):
        raise AssertionError(f"{backend}: no checkpoint under {ckpt_dir}")

    # the trained weights through the kernels and through index_add_
    tensors = args.objects["tensors"]
    model = args.objects["model"]
    with torch.no_grad():
        logits = args.objects["predict_step"](**tensors)
        seg_hops = [SparseMatrix.from_scipy(h.to_scipy(), backend="segment",
                                            device=device)
                    for h in tensors["adj_hops"]]
        ref = model(tensors["adj"], tensors["features"], seg_hops)
    n, n_classes = tensors["y_all"].shape
    if tuple(logits.shape) != (n, n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"{backend}: bad logits {tuple(logits.shape)}")
    logit_err = float((logits - ref).abs().max())
    logit_tol = TOL * max(1.0, float(ref.abs().max()))
    if logit_err > logit_tol:
        raise AssertionError(f"{backend}: logits differ from the plain SpMM "
                             f"by {logit_err} > {logit_tol}")
    times = args.objects["epoch_times"]
    epoch_ms, epoch_ms_median = run_experiments.steady_epoch_ms(times)
    emit({"cli": backend, "epochs": len(times),
          "epoch_ms": epoch_ms, "epoch_ms_median": epoch_ms_median,
          "first_epoch_ms": 1e3 * times[0],
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches, "logit_err": logit_err,
          "logit_tol": logit_tol, "s": time.perf_counter() - t0})
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
                got, ref = run(), plain()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                torch.cuda.synchronize()
                err, tol = 0.0, 0.0
                for a, b in zip(got, ref):
                    # rows without an entry keep the sentinel max exactly
                    live = b > att.NEG_INF / 2
                    if (a.shape != b.shape or not torch.isfinite(a).all()
                            or not torch.equal(a[~live], b[~live])):
                        raise AssertionError(
                            f"{kernel} {gname} H={H} F={F}: bad output "
                            f"{tuple(a.shape)}")
                    e = float((a[live] - b[live]).abs().max())
                    t = TOL * max(1.0, float(b[live].abs().max()))
                    if e > t:
                        emit({"kernel": kernel, "graph": gname, "H": H,
                              "F": F, "max_abs_err": e, "tol": t})
                        raise AssertionError(
                            f"{kernel} disagrees with its plain version on "
                            f"{gname} H={H} F={F}: {e} > {t}")
                    err, tol = max(err, e), max(tol, t)
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


def run_gat_cli(data_dir, name, device, attn_drop):
    """Phase 6: GAT for EPOCHS epochs through the CLI with
    ``--fused_attention``. Returns the launch counts of the run."""
    import glob

    import torch

    from h2gcn_tpu_torch import run_experiments
    from h2gcn_tpu_torch.sparse import attention as att

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(data_dir, f"ckpt_gat_{attn_drop}")
    argv = ["GAT", "planetoid", "--dataset", f"ind.{name}",
            "--dataset_path", data_dir, "--fused_attention",
            "--attn_drop", str(attn_drop), "--epochs", str(EPOCHS),
            "--timing", "--random_seed", "123", "--checkpoint_dir", ckpt_dir]
    counters = (att.gat_fwd_stats, att.gat_bwd_row, att.gat_bwd_col)
    for fn in counters:
        fn.launches = 0
    args = run_experiments.main(argv)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    # attention dropout needs per-edge alpha: training then takes the
    # segment path, and only the evaluations run the forward kernel
    trains_fused = attn_drop == 0
    for kernel, count in launches.items():
        if (count > 0) != (trains_fused or kernel == "gat_fwd_stats"):
            raise AssertionError(f"GAT --attn_drop {attn_drop}: {kernel} "
                                 f"launched {count} times")
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(float(stats[key])):
            raise AssertionError(f"GAT: {key} = {float(stats[key])}")
    if not glob.glob(os.path.join(ckpt_dir, "*", "ckpt.pt")):
        raise AssertionError(f"GAT: no checkpoint under {ckpt_dir}")

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
        raise AssertionError(f"GAT: bad logits {tuple(logits.shape)}")
    logit_err = float((logits - ref).abs().max())
    logit_tol = TOL * max(1.0, float(ref.abs().max()))
    if logit_err > logit_tol:
        raise AssertionError(f"GAT: logits through the kernels differ from "
                             f"the segment path by {logit_err} > {logit_tol}")
    times = args.objects["epoch_times"]
    epoch_ms, epoch_ms_median = run_experiments.steady_epoch_ms(times)
    emit({"cli": "GAT", "attn_drop": attn_drop, "epochs": len(times),
          "support_nnz": tensors["adj"].nnz,
          "epoch_ms": epoch_ms, "epoch_ms_median": epoch_ms_median,
          "first_epoch_ms": 1e3 * times[0],
          "final_train_loss": float(stats["train_loss"]),
          "final_val_acc": float(stats["val_acc"]),
          "launches": launches, "logit_err": logit_err,
          "logit_tol": logit_tol, "s": time.perf_counter() - t0})
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    # fails in a directory without the package, before any result
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
                               "h2gcn_tpu/sparse/pallas_attention.py:326")}
    kernels = []
    for name, (source, replaces) in sources.items():
        if name in gat_cases:
            # the headline shape: the Cora-shaped graph at layer 1's width
            head = next(c for c in cases[name]
                        if c["graph"] == "cora_shaped" and c["H"] == 8)
        else:
            # the headline shape: A2, F=128, highest, forward
            head = next(c for c in cases[name]
                        if c["matrix"] == "A2" and c["F"] == 128
                        and c["precision"] == "highest"
                        and c["direction"] == "forward")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
