"""The network module compiled from the layer DSL.

:class:`NetworkModel` is the port of ``h2gcn_tpu.nn.model.NetworkModel``
for every layer kind: dense (with or without bias; on sparse features a
:class:`SparseMatrix` X, through ``spmm``), dropout, graph aggregation over
the hop matrices, ReLU, vectorize, concat of tagged outputs, identity
(sparse to dense), slice, stop-gradient, lambda and experimental (``X``)
layers, with the ``E`` (embedding) and ``L`` (supervision) modifiers and
the JAX package's ``return_before`` / ``execute_after`` /
``add_supervision`` routing. Concat layers see the tagged-output table in
tag creation order; graph layers stack one aggregate per selected hop on a
new axis. Dense kernels keep the JAX layout ``[in, out]`` (``y = x @
kernel + bias``), keyed by layer index, so :func:`load_jax_params` can
carry the JAX package's weights over unchanged;
:func:`load_jax_gat_params` does the same for GAT's per-head parameters.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..sparse import SparseMatrix, spmm
from . import _lambda_ns
from .dsl import Layer
from .metrics import masked_softmax_cross_entropy
from .ops import dropout

# X<name>_<conf> layers: name -> factory(conf, output_dim) -> fn(params,
# adj, x, adjhops, tagged) -> x, the JAX package's contract. An X layer
# owns no parameters: ``params`` is always ``{}``.
experimental_registry: Dict[str, Any] = {}

_NAMES = {Layer.DENSE: "dense", Layer.DROPOUT: "dropout", Layer.GCN: "graph",
          Layer.RELU: "relu", Layer.VECTORIZE: "flatten",
          Layer.CONCAT: "concat", Layer.SLICE: "slice",
          Layer.IDENTITY: "identity", Layer.LAMBDA: "lambda",
          Layer.STOP_GRADIENT: "stop_gradient"}


def _aggregate(a, x):
    """SpMM dispatch: a :class:`SparseMatrix`, or a rank's shard of a
    distributed hop matrix (:mod:`h2gcn_tpu_torch.parallel.dist`)."""
    if isinstance(a, SparseMatrix):
        return spmm(a, x)
    from ..parallel import dist

    if isinstance(a, dist.DistSparseMatrix):
        return dist.dist_spmm(a, x)
    if isinstance(a, dist.RingShard):
        return dist.dist_spmm_ring(a, x)
    if isinstance(a, dist.HaloShard):
        return dist.dist_spmm_halo(a, x)
    if isinstance(a, dist.HaloCooTileShard):
        return dist.dist_spmm_halo_cootile(a, x)
    raise TypeError(f"cannot aggregate over {type(a).__name__}")


def _safe_lambda(expr: str):
    """Evaluate a DSL lambda with ``jnp`` and ``nn`` bound to the torch
    shim (:mod:`._lambda_ns`) and no builtins, as the JAX package does
    with ``jax.numpy`` and ``jax.nn``."""
    return eval(  # noqa: S307: restricted globals, config-provided string
        expr, {"__builtins__": {}, "jnp": _lambda_ns.jnp, "nn": _lambda_ns.nn})


class NetworkModel(nn.Module):
    """A layer program plus its parameters. Call :meth:`init` once with the
    input width before the first forward."""

    def __init__(self, layer_setups, l2_regularize_weight: float = 0.0):
        super().__init__()
        self.layer_setups = [(kind, dict(conf)) for kind, conf in layer_setups]
        self.l2_regularize_weight = float(l2_regularize_weight)
        self.tags: Dict[int, str] = {}
        self.names: List[str] = []
        self.supervised_inds = set()
        self.embedding_ind: Optional[int] = None
        self.output_ind: Optional[int] = None
        for ind, (kind, conf) in enumerate(self.layer_setups):
            tag = conf.pop("tag", None)
            if kind == Layer.DENSE:
                if conf.get("isEmbedding", False):
                    self.embedding_ind = ind
                if conf.get("beginOutput", False):
                    self.output_ind = ind
            elif kind == Layer.LAMBDA:
                conf["fn"] = _safe_lambda(conf["lambda"])
            elif kind == Layer.EXPERIMENTAL:
                factory = experimental_registry[conf["name"]]
                conf["fn"] = factory(conf.get("conf", ""),
                                     conf.get("output_dim"))
            elif kind not in _NAMES:
                raise ValueError(f"Unsupported layer type {kind}")
            self.names.append(f"x_{conf['name']}"
                              if kind == Layer.EXPERIMENTAL else _NAMES[kind])
            if conf.get("supervised", False):
                self.supervised_inds.add(ind)
            if tag:
                self.tags[ind] = tag
        self.kernels = nn.ParameterDict()
        self.biases = nn.ParameterDict()

    @property
    def num_layers(self) -> int:
        return len(self.layer_setups)

    # ------------------------------------------------------------------ init
    def init(self, input_dim: int, num_hops: int, generator: torch.Generator,
             device="cpu") -> "NetworkModel":
        """Create the parameters by running a 4-node dummy forward on the
        CPU: glorot-uniform kernels drawn from ``generator`` in layer order,
        zero biases. Then move them to ``device``."""
        import scipy.sparse as sp

        n = 4
        eye = SparseMatrix.from_scipy(sp.eye(n, format="csr", dtype=np.float32),
                                      backend="segment")
        x = torch.zeros(n, input_dim, dtype=torch.float32)
        with torch.no_grad():
            self._forward(eye, x, [eye] * max(1, num_hops), training=False,
                          generator=None, init_gen=generator)
        return self.to(device)

    # --------------------------------------------------------------- forward
    def forward(self, adj: SparseMatrix, x: torch.Tensor,
                adjhops: Sequence[SparseMatrix], *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                capture: Optional[dict] = None, return_before: int = 0,
                execute_after: int = 0, add_supervision: bool = False):
        """Logits for every node. ``generator`` drives dropout in training;
        ``capture`` (a dict) receives every layer's output under
        ``activations/<ind>-<name>``. ``return_before=i`` returns the input
        of layer ``i`` (``i <= 0`` counts from the end, 0: run every
        layer); ``execute_after=i`` starts at layer ``i`` with ``x`` as its
        input (negative: from the end). With ``add_supervision`` it returns
        ``(x, outputs)``, ``outputs`` the output network
        (:meth:`call_output_network`) run on each ``L``-marked layer's
        output."""
        return self._forward(adj, x, adjhops, training=training,
                             generator=generator, capture=capture,
                             return_before=return_before,
                             execute_after=execute_after,
                             add_supervision=add_supervision)

    def _forward(self, adj, x, adjhops, *, training, generator,
                 capture=None, return_before=0, execute_after=0,
                 add_supervision=False, init_gen=None):
        tagged: Dict[str, torch.Tensor] = {}
        supervised_outputs = []
        if capture is not None:
            capture["inputs/inputs"] = x
        n_layers = self.num_layers
        if return_before <= 0:
            return_before = n_layers + return_before
        if execute_after < 0:
            execute_after = n_layers + execute_after
        for ind, (kind, conf) in enumerate(self.layer_setups):
            if ind == return_before:
                return x
            if ind < execute_after:
                continue
            key = str(ind)
            if kind == Layer.DENSE:
                if init_gen is not None:
                    fan_in, fan_out = x.shape[-1], conf["units"]
                    limit = math.sqrt(6.0 / (fan_in + fan_out))
                    w = (torch.rand(fan_in, fan_out, generator=init_gen) * 2
                         - 1) * limit
                    self.kernels[key] = nn.Parameter(w)
                    if conf["use_bias"]:
                        self.biases[key] = nn.Parameter(torch.zeros(fan_out))
                if isinstance(x, SparseMatrix):
                    # sparse features: X W through the SpMM core (its
                    # gradient to W is X^T g through the transpose view)
                    x = spmm(x, self.kernels[key])
                else:
                    x = torch.matmul(x, self.kernels[key])
                if key in self.biases:
                    x = x + self.biases[key]
            elif kind == Layer.DROPOUT:
                x = dropout(x, conf["dropout_rate"], generator,
                            training=training)
            elif kind == Layer.GCN:
                hops = conf.get("hops")
                x = torch.stack([_aggregate(a, x)
                                 for h, a in enumerate(adjhops)
                                 if hops is None or h in hops], dim=-2)
            elif kind == Layer.RELU:
                x = torch.relu(x)
            elif kind == Layer.VECTORIZE:
                x = x.reshape(x.shape[0], -1)
            elif kind == Layer.IDENTITY:
                # the sparse-to-dense boundary; a no-op on dense input
                if isinstance(x, SparseMatrix):
                    x = x.todense()
            elif kind == Layer.CONCAT:
                selected = [v for t, v in tagged.items() if t in conf["tags"]]
                if conf.get("addInputs", True):
                    selected = [x] + selected
                x = torch.cat(selected, dim=-1)
            elif kind == Layer.SLICE:
                src = tagged[conf["loadTag"]] if conf["loadTag"] else x
                x = src[:, conf["sliceObj"]]
            elif kind == Layer.LAMBDA:
                x = conf["fn"](x)
            elif kind == Layer.STOP_GRADIENT:
                x = x.detach()
            elif kind == Layer.EXPERIMENTAL:
                x = conf["fn"]({}, adj, x, adjhops, tagged)
            if add_supervision and ind in self.supervised_inds:
                supervised_outputs.append(self._forward(
                    adj, x, adjhops, training=training, generator=generator,
                    execute_after=self.output_ind))
            if capture is not None:
                capture[f"activations/{ind}-{self.names[ind]}"] = x
            if ind in self.tags:
                tagged[self.tags[ind]] = x
        if add_supervision:
            return x, supervised_outputs
        return x

    # ------------------------------------------------------------- accessors
    def get_embeddings(self, adj, x, adjhops):
        """The output of the ``E``-marked layer."""
        assert self.embedding_ind is not None, "no E-marked layer in the DSL"
        return self(adj, x, adjhops, return_before=self.embedding_ind + 1)

    def call_output_network(self, adj, x, adjhops, **kw):
        """The layers from the output head (``FO``/``MO``) on, applied to
        ``x``."""
        assert self.output_ind is not None, "no *O output head in the DSL"
        return self(adj, x, adjhops, execute_after=self.output_ind, **kw)

    # ------------------------------------------------------------------ loss
    def l2_loss(self) -> torch.Tensor:
        """keras-style l2: ``weight * sum(kernel^2)`` over dense kernels
        (biases excluded), with an optional per-layer ``l2_scale``."""
        total = 0.0
        for key, w in self.kernels.items():
            scale = self.layer_setups[int(key)][1].get("l2_scale", 1.0)
            if scale:
                total = total + scale * torch.sum(torch.square(w))
        return self.l2_regularize_weight * total

    def loss(self, logits, labels, mask) -> torch.Tensor:
        return masked_softmax_cross_entropy(logits, labels, mask) + self.l2_loss()


def load_jax_params(model: NetworkModel, params) -> NetworkModel:
    """Load the JAX ``NetworkModel``'s parameter list (one dict per layer,
    ``{"kernel", "bias"}`` as numpy arrays) into an initialized port model,
    so both packages compute the same function."""
    with torch.no_grad():
        for ind, p in enumerate(params):
            for name, store in (("kernel", model.kernels), ("bias", model.biases)):
                if not isinstance(p, dict) or name not in p:
                    continue
                key = str(ind)
                if key not in store:
                    raise KeyError(f"layer {ind} has no {name} in the port model")
                src = torch.from_numpy(np.array(p[name], dtype=np.float32))
                if tuple(src.shape) != tuple(store[key].shape):
                    raise ValueError(f"layer {ind} {name}: {tuple(src.shape)} "
                                     f"!= {tuple(store[key].shape)}")
                store[key].copy_(src)
    return model


def load_jax_gat_params(model, params):
    """Load the JAX ``GATNetwork``'s pytree ``{"layers": [[{W, a1, a2, b1,
    b2, bias, Wres?, bres?}, ...], ...]}`` (numpy arrays) into an
    initialized port ``GATNetwork`` (``models/GAT.py``), so both packages
    compute the same function."""
    layers = params["layers"]
    if len(layers) != len(model.layers):
        raise ValueError(f"{len(layers)} layers for a {len(model.layers)}-"
                         "layer model")
    with torch.no_grad():
        for li, (heads, t_heads) in enumerate(zip(layers, model.layers)):
            if len(heads) != len(t_heads):
                raise ValueError(f"layer {li}: {len(heads)} heads for "
                                 f"{len(t_heads)}")
            for hi, (p, tp) in enumerate(zip(heads, t_heads)):
                if set(p) != set(tp.keys()):
                    raise KeyError(f"layer {li} head {hi}: {sorted(p)} != "
                                   f"{sorted(tp.keys())}")
                for key, value in p.items():
                    src = torch.from_numpy(np.array(value, dtype=np.float32))
                    if src.numel() == 1 == tp[key].numel():
                        src = src.reshape(tp[key].shape)  # b1, b2: () or (1,)
                    if tuple(src.shape) != tuple(tp[key].shape):
                        raise ValueError(
                            f"layer {li} head {hi} {key}: "
                            f"{tuple(src.shape)} != {tuple(tp[key].shape)}")
                    tp[key].copy_(src)
    return model
