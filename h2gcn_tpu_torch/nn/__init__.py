"""Model layer: the layer-DSL compiler, the network module, metrics."""

from .dsl import Layer, parse_network_setup
from .metrics import masked_accuracy, masked_softmax_cross_entropy
from .model import NetworkModel, load_jax_gat_params, load_jax_params

__all__ = [
    "Layer",
    "parse_network_setup",
    "NetworkModel",
    "load_jax_params",
    "load_jax_gat_params",
    "masked_softmax_cross_entropy",
    "masked_accuracy",
]
