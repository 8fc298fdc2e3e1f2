"""The network-setup string DSL.

Architectures are configured with compact strings such as the H2GCN-2 default
``M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO``. Token grammar (kept fully compatible
with the reference DSL, h2gcn/models/__init__.py:47-150):

=========  ====================================================================
``F<n>``   Dense layer with bias, ``n`` units (``FO`` = output dim, marks the
           output head start)
``M<n>``   Dense layer without bias (``MO`` as above)
``D<p>``   Dropout with rate ``p`` (default rate if omitted)
``G[h_..]`` Graph aggregation over the listed hop indices (all hops if bare);
           stacks one aggregated copy per hop on a new axis
``R``      ReLU
``V``      Vectorize: flatten per-node trailing axes
``C<t_..>`` Concat the current input with the tagged outputs ``t..``
``I``      Sparse→dense identity
``S<tag>_<a>_<b>`` Slice columns ``a:b`` of the tagged (or current) output
``X<name>_<conf>`` Experimental layer from the registry
``lambda …`` Restricted lambda layer
Modifiers: ``E`` = embedding marker, ``L`` = auxiliary supervision,
``T<tag>`` = tag the previous layer's output.
=========  ====================================================================
"""

from __future__ import annotations

import re
from typing import List, Tuple


class Layer:
    DENSE = "F"
    DROPOUT = "D"
    GCN = "G"
    RELU = "R"
    CONCAT = "C"
    VECTORIZE = "V"
    IDENTITY = "I"
    SLICE = "S"
    EXPERIMENTAL = "X"
    LAMBDA = "lambda"
    STOP_GRADIENT = "SG"  # referenced-but-undefined in the reference; real here


def parse_network_setup(
    network_setup_str: str,
    output_dim: int,
    _dense_units: int = None,
    _dropout_rate: float = None,
) -> List[Tuple[str, dict]]:
    """Compile a network-setup string into a list of ``(Layer, conf)`` pairs."""
    tokens = re.split(r"-(?![^[]*\])", network_setup_str)
    conf: List[Tuple[str, dict]] = []
    embedding_defined = False
    for tok in tokens:
        if tok[0] == "[" and tok[-1] == "]":
            tok = tok[1:-1].strip()

        if tok.startswith("lambda"):
            conf.append((Layer.LAMBDA, {"lambda": tok}))
        elif tok[0] in ("F", "M"):
            kwargs = {}
            if len(tok) > 1:
                if tok[1:] == "O":
                    units = output_dim
                    kwargs["beginOutput"] = True
                else:
                    units = int(tok[1:])
            else:
                assert _dense_units is not None, "bare F/M requires --hidden"
                units = _dense_units
            conf.append(
                (Layer.DENSE, dict(units=units, use_bias=(tok[0] == "F"), **kwargs))
            )
        elif tok[0] == "D":
            if len(tok) > 1:
                rate = float(tok[1:])
            else:
                assert _dropout_rate is not None, "bare D requires --dropout"
                rate = _dropout_rate
            conf.append((Layer.DROPOUT, dict(dropout_rate=rate)))
        elif tok[0] == "G":
            hops = set(int(i) for i in tok[1:].split("_")) if len(tok) > 1 else None
            conf.append((Layer.GCN, dict(hops=hops)))
        elif tok[0] == "C":
            tags = tok[1:].split("_")
            conf.append((Layer.CONCAT, dict(tags=tags, addInputs=True)))
        elif tok[0] == "R":
            conf.append((Layer.RELU, {}))
        elif tok[0] == "V":
            conf.append((Layer.VECTORIZE, {}))
        elif tok[0] == "I":
            conf.append((Layer.IDENTITY, {}))
        elif tok == "SG":
            conf.append((Layer.STOP_GRADIENT, {}))
        elif tok[0] == "S":
            m = re.search(r"^S([^_]*)(?:_|$)((?:[^_]*(?:_|$))*)", tok)
            tag = m.group(1) or None
            if m.group(2):
                parts = [(int(x) if x else None) for x in m.group(2).split("_")]
                slc = slice(*parts)
            else:
                slc = slice(None)
            conf.append((Layer.SLICE, dict(loadTag=tag, sliceObj=slc)))
        elif tok[0] == "X":
            m = re.search(r"X([^_]*)(?:_|$)(.*)", tok)
            conf.append(
                (
                    Layer.EXPERIMENTAL,
                    dict(name=m.group(1), conf=m.group(2), output_dim=output_dim),
                )
            )
        # Modifiers: attach to the previous layer's conf dict.
        elif tok[0] == "E":
            assert not embedding_defined, "only one embedding layer allowed"
            conf[-1][-1]["isEmbedding"] = True
            embedding_defined = True
        elif tok[0] == "L":
            conf[-1][-1]["supervised"] = True
        elif tok[0] == "T":
            conf[-1][-1]["tag"] = tok[1:]
        else:
            raise ValueError(f"Unknown layer token {tok!r} in {network_setup_str!r}")
    return conf
