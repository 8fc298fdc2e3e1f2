"""h2gcn_tpu_torch: the PyTorch/CUDA port of h2gcn_tpu.

The H2GCN model family and its baselines (GCN, MixHop, GraphSAGE, GAT)
trained full-batch on an NVIDIA GPU: the same layer
DSL, data layer, exact-hop aggregation and training runtime as the JAX
package ``h2gcn_tpu``, with its TPU Pallas kernels replaced by CUDA kernels
written for Hopper (``csrc/``), each beside a plain PyTorch version that the
CPU runs. Entry point: ``python -m h2gcn_tpu_torch.run_experiments``.
"""

__version__ = "0.1.0"


def __getattr__(name):  # PEP 562: lazy submodule access
    # keeps `import h2gcn_tpu_torch` free of torch for host-only tooling
    import importlib

    if name in ("sparse", "datasets", "models", "modules", "nn"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
