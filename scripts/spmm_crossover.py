"""The crossover of the two hop SpMM kernels, gscatter (#1,
``csrc/gscatter.cu``, each row summed in registers over the row-major
entries) and BSR (#2, ``csrc/bsr_spmm.cu``), by entries per occupied
128-block, on the card.

    python3 scripts/spmm_crossover.py [--seed 1671832396] [--calls 20]

The matrices: squirrel's Â₂ (the ``squirrel`` traffic of ``benchmark/``
at ``--seed``) thinned at random, symmetrically, to 1-86% fill of its
128-blocks; squirrel's Â₁; the 10K ``bench.py`` graph's Â₂ (``chip_smoke``)
whole and thinned to a half and a quarter, and its Â₁. Each matrix is
built through ``SparseMatrix.from_scipy`` with each backend, and timed
through ``spmm`` forward at F = 64 and 128, in ``highest`` (f32) and
``default`` (bf16 operands) precision: CUDA events over ``--calls`` calls
after three untimed ones. Prints one JSON line a matrix and precision
(also written to ``chiprun_out/spmm_crossover.jsonl``), with what
``auto`` chooses for the matrix, and the BSR output's largest gap to
gscatter's over the output's scale.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FILLS = (0.01, 0.02, 0.04, 0.06, 0.08, 0.10, 0.12, 0.15, 0.20, 0.30, 0.50,
         0.70)
PRECISIONS = ("highest", "default")


def thinned(mat, keep: float, rng):
    """``mat`` (symmetric) with each entry of its upper triangle kept with
    probability ``keep``, mirrored: symmetric again."""
    import scipy.sparse as sp

    up = sp.triu(mat, format="coo")
    sel = rng.random(up.nnz) < keep
    up = sp.coo_matrix((up.data[sel], (up.row[sel], up.col[sel])),
                       shape=mat.shape).tocsr()
    return (up + sp.triu(up, k=1, format="csr").T).tocsr()


def matrices(seed: int):
    """``(name, thinned_to, csr)`` in the order they are timed:
    ``thinned_to`` the fill asked of squirrel's Â₂, the share of entries
    kept of the 10K Â₂, None for a matrix as it is."""
    import numpy as np

    import chip_smoke
    from benchmark import graphs
    from h2gcn_tpu_torch.sparse import transforms

    root = Path(__file__).resolve().parent.parent
    traffic = json.loads((root / "benchmark/traffic/squirrel.json")
                         .read_text())
    split = transforms.nhood_split(graphs.generate(traffic, seed).adjacency(),
                                   2)
    a1, a2 = (transforms.normalize(split[k]).tocsr() for k in (1, 2))
    rng = np.random.default_rng(seed)
    from h2gcn_tpu_torch.sparse.matrix import block_occupancy

    full = a2.nnz / (block_occupancy(a2)[0] * 128 * 128)
    yield "squirrel_A1", None, a1
    for fill in FILLS:
        yield "squirrel_A2", fill, thinned(a2, fill / full, rng)
    yield "squirrel_A2", None, a2
    split = transforms.nhood_split(chip_smoke.build_graph(), 2)
    b1, b2 = (transforms.normalize(split[k]).tocsr() for k in (1, 2))
    yield "10k_A1", None, b1
    for keep in (0.25, 0.5):
        yield "10k_A2", keep, thinned(b2, keep, rng)
    yield "10k_A2", None, b2


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=1671832396)
    p.add_argument("--calls", type=int, default=20)
    a = p.parse_args(argv)

    import torch

    from benchmark.metrics import _kernel_time as kt
    from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
    from h2gcn_tpu_torch.sparse.matrix import _auto_backend, block_occupancy

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(a.seed % 2**31)
    with open(out_dir / "spmm_crossover.jsonl", "w") as log:
        for name, fill, mat in matrices(a.seed):
            occupied, fillers = block_occupancy(mat)
            xs = {f: torch.randn(mat.shape[1], f, generator=gen, device=dev)
                  for f in (64, 128)}
            rows = {precision: {
                "matrix": name, "thinned_to": fill, "nnz": mat.nnz,
                "blocks": occupied, "fillers": fillers,
                "entries_per_block": mat.nnz / occupied,
                "precision": precision,
                "auto": _auto_backend(mat, symmetric=True,
                                      precision=precision,
                                      device_type="cuda"),
                "card": card.strip()} for precision in PRECISIONS}
            outs = {}
            for backend in ("gscatter", "bsr"):
                sm = None
                for precision in PRECISIONS:
                    # gscatter's row-major payload serves both
                    # precisions; the BSR payload is stored in the
                    # precision's type
                    if sm is None or backend == "bsr":
                        sm = SparseMatrix.from_scipy(
                            mat, backend=backend, precision=precision,
                            device=dev)
                    sm = dataclasses.replace(sm, precision=precision)
                    with torch.no_grad():
                        for f, x in xs.items():
                            rows[precision][f"{backend}_ms_F{f}"] = \
                                kt.ms_per_call(lambda: spmm(sm, x),
                                               calls=a.calls)
                            outs[backend, precision, f] = spmm(sm, x)
                del sm
                torch.cuda.empty_cache()
            for precision, row in rows.items():
                for f in xs:
                    ref = outs["gscatter", precision, f]
                    scale = max(1.0, float(ref.abs().max()))
                    row[f"bsr_gap_F{f}"] = float(
                        (outs["bsr", precision, f] - ref).abs().max()) / scale
                line = json.dumps(row)
                print(line, flush=True)
                log.write(line + "\n")


if __name__ == "__main__":
    main()
