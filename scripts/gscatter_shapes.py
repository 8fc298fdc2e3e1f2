"""#1 (``csrc/gscatter.cu``) at the shapes the main path gives it, on the
card.

    python3 scripts/gscatter_shapes.py [--seed 1671832396] [--calls 20]
                                       [--no_a2] [--spmm_only] [--root DIR]

The matrices: the 10K ``bench.py`` graph's Â₂ (``chip_smoke``; PERF.md
§6's headline, F = 128), the benchmark's squirrel graph's Â₁ (F = 64 and
128) and its arXiv-year graph, both at ``--seed``: Ã (the symmetric normalization of A + I, GCNII's support, F =
64) and Â₂ (the exact 2-hop pattern, ``benchmark/reference.exact_hops``,
symmetrically normalized: H2GCN-2's widest hop, F = 64 and 128). Each
matrix is timed through ``spmm`` (``SparseMatrix.from_scipy``'s
``gscatter`` route, which every version of the port has) by CUDA events
over ``--calls`` calls after three untimed ones, beside the least time of
``benchmark/work.spmm`` and the rate of the gathered x rows (an entry a
row of F floats). Without ``--spmm_only`` also: the plain version's time
and the kernel's gap to it (not for Â₂, whose products alone would take
134 GB), ``torch.sparse.mm``'s time on the same CSR, the gap to it, and
#1 over each entries-an-item budget of the sweep. ``--no_a2`` leaves
arXiv-year's Â₂ out; ``--root`` imports the port, ``chip_smoke`` and
``benchmark`` from another checkout (an older commit's, with
``--spmm_only``). Prints one JSON line a case (also appended to
``chiprun_out/gscatter_shapes.jsonl``).
"""

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SWEEP = {"10k_A2": (128, 256, 512, 1024, 2048),
         "squirrel_A1": (16, 32, 64, 128, 256),
         "arxiv_At": (32, 64, 128, 256, 512),
         "arxiv_A2": (256, 512, 1024, 2048, 4096, 8192)}


def _normalized(rows, cols, n):
    """D^-1/2 P D^-1/2 of the pattern ``rows``, ``cols`` (row-major
    sorted, on the card) as a scipy CSR on the host."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    deg = torch.bincount(rows, minlength=n).to(torch.float32)
    inv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    vals = (inv[rows] * inv[cols]).cpu().numpy()
    ptr = np.concatenate([[0], np.cumsum(
        torch.bincount(rows, minlength=n).cpu().numpy())])
    return sp.csr_matrix((vals, cols.to(torch.int32).cpu().numpy(), ptr),
                         shape=(n, n))


def matrices(seed: int, with_a2: bool, dev):
    """``(name, csr, widths)`` in the order they are timed."""
    import scipy.sparse as sp
    import torch

    import chip_smoke
    from benchmark import graphs, reference
    from h2gcn_tpu_torch.sparse import transforms

    split = transforms.nhood_split(chip_smoke.build_graph(), 2)
    yield "10k_A2", transforms.normalize(split[2]).tocsr(), (128,)
    traffic = json.loads((ROOT / "benchmark/traffic/squirrel.json")
                         .read_text())
    g = graphs.generate(traffic, seed)
    yield "squirrel_A1", transforms.normalize(g.adjacency()).tocsr(), (64, 128)
    traffic = json.loads((ROOT / "benchmark/traffic/arxiv-year.json")
                         .read_text())
    g = graphs.generate(traffic, seed)
    a = g.adjacency() + sp.eye(g.n, dtype="float32", format="csr")
    yield "arxiv_At", transforms.normalize(a).tocsr(), (64,)
    if with_a2:
        _, (r2, c2) = reference.exact_hops(g.src, g.dst, g.n, dev)
        a2 = _normalized(r2, c2, g.n)
        del r2, c2
        torch.cuda.empty_cache()
        yield "arxiv_A2", a2, (64, 128)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=1671832396)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--no_a2", action="store_true")
    p.add_argument("--spmm_only", action="store_true")
    p.add_argument("--root", default=str(ROOT))
    a = p.parse_args(argv)
    sys.path.insert(0, a.root)

    import numpy as np
    import torch

    from benchmark import work
    from benchmark.metrics import _kernel_time as kt
    from h2gcn_tpu_torch.sparse import SparseMatrix, spmm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(a.seed % 2**31)

    def emit(row, log):
        line = json.dumps(dict(row, card=card.strip()))
        print(line, flush=True)
        log.write(line + "\n")

    with open(out_dir / "gscatter_shapes.jsonl", "a") as log:
        for name, mat, widths in matrices(a.seed, not a.no_a2, dev):
            t0 = time.perf_counter()
            n, m = mat.shape
            sm = SparseMatrix.from_scipy(mat, backend="gscatter", device=dev)
            build_s = time.perf_counter() - t0
            lib = None
            if not a.spmm_only:
                with warnings.catch_warnings():  # "sparse CSR is in beta"
                    warnings.simplefilter("ignore", UserWarning)
                    lib = torch.sparse_csr_tensor(
                        torch.from_numpy(mat.indptr.astype(np.int64)),
                        torch.from_numpy(mat.indices.astype(np.int64)),
                        torch.from_numpy(mat.data), mat.shape).to(dev)
            for f in widths:
                x = torch.randn(m, f, generator=gen, device=dev)
                with torch.no_grad():
                    ms = kt.ms_per_call(lambda: spmm(sm, x), calls=a.calls)
                    y = spmm(sm, x)
                least, _ = work.least_seconds(*work.spmm(mat.nnz, n, m, f))
                row = {"matrix": name, "n": n, "nnz": mat.nnz, "F": f,
                       "precision": "highest", "kernel_ms": ms,
                       "bound_ms": 1e3 * least,
                       "roofline_pct": 100.0 * least / (ms / 1e3),
                       "gathered_gb": mat.nnz * f * 4 / 1e9,
                       "gather_tb_per_s": mat.nnz * f * 4 / (ms / 1e3) / 1e12,
                       "max_row_entries": int(np.diff(mat.indptr).max()),
                       "build_s": build_s}
                if not a.spmm_only:
                    from h2gcn_tpu_torch.sparse import gscatter as tgs

                    rm = sm.gsc
                    row.update(work_items=rm.n_items, split_rows=rm.n_split,
                               max_entries_per_item=int(np.diff(
                                   rm.items[:, 0].cpu().numpy()).max()))
                    scale = max(1.0, float(y.abs().max()))
                    with torch.no_grad():
                        row["library_ms"] = kt.ms_per_call(
                            lambda: torch.sparse.mm(lib, x), calls=a.calls)
                        row["library_gap"] = float(
                            (torch.sparse.mm(lib, x) - y).abs().max()) / scale
                        if name != "arxiv_A2":
                            row["plain_ms"] = kt.ms_per_call(
                                lambda: tgs.gscatter_rows_plain(rm, x),
                                calls=3, warmup=1)
                            row["plain_gap"] = float((
                                tgs.gscatter_rows_plain(rm, x) - y
                            ).abs().max()) / scale
                emit(row, log)
                if a.spmm_only:
                    continue
                for budget in SWEEP[name]:
                    rm = tgs.build_row_major(mat.indptr, sm.cols, sm.vals, m,
                                             budget=budget)
                    with torch.no_grad():
                        ms = kt.ms_per_call(lambda: tgs.gscatter_spmm(rm, x),
                                            calls=a.calls)
                        gap = float((tgs.gscatter_spmm(rm, x) - y).abs()
                                    .max()) / scale
                    emit({"sweep": name, "F": f, "budget": budget,
                          "work_items": rm.n_items, "split_rows": rm.n_split,
                          "kernel_ms": ms, "gap": gap}, log)
                    del rm
                del x, y
            del sm, lib
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
