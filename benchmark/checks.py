"""The comparison that decides ``correct``: the program's readings of its
first three training steps against the plain reference's.

Each number is a relative gap, and the worst over the steps or the leaves:

- ``loss``: each step's training loss (before its update);
- ``eval_loss``: each step's validation loss (the evaluation after it);
- ``grad1``: each leaf's first-gradient norm;
- ``delta3``: each leaf's norm of its change over the three steps, leaving
  out the leaves whose reference first gradient is under a thousandth of
  the median leaf's (round-off alone moves those under Adam).

A leaf's gap is ``| |prog| - |ref| |`` over the larger of its reference
norm and the median leaf's.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss", "eval_loss", "grad1", "delta3", "grad1_median",
         "delta3_median")
# a leaf whose reference gradient lies under this share of the median
# leaf's is left out of delta3
NEGLIGIBLE_GRAD = 1e-3


def _worst(gaps) -> float:
    return max((g if math.isfinite(g) else math.inf) for g in gaps)


def _scalars(prog, ref):
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program steps, {len(ref)} reference")
    return _worst(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def _leaf_gaps(prog: dict, ref: dict) -> list:
    med = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref]


def worst_leaves(prog: dict, ref: dict, part: str, k: int = 4) -> list:
    """The ``k`` leaves with the largest gaps of ``part`` (``grad1`` or
    ``delta3``): ``[name, gap, program norm, reference norm, reference
    first-gradient norm]``, for looking into a reading."""
    med = statistics.median(ref[part].values())
    rows = [[n, abs(prog[part][n] - r) / max(r, med), prog[part][n], r,
             ref["grad1"][n]] for n, r in ref[part].items()]
    return sorted(rows, key=lambda row: -row[1])[:k]


def compare(prog: dict, ref: dict) -> dict:
    """``{name: value}`` for :data:`NAMES`; a non-finite reading gives
    ``inf``."""
    for part in ("grad1", "delta3"):
        if set(prog[part]) != set(ref["grad1"]):
            raise ValueError(f"{part}: program leaves {sorted(prog[part])}, "
                             f"reference {sorted(ref['grad1'])}")
    med_g = statistics.median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items()
             if g >= NEGLIGIBLE_GRAD * med_g]
    g = _leaf_gaps(prog["grad1"], ref["grad1"])
    d = _leaf_gaps({k: prog["delta3"][k] for k in moved},
                   {k: ref["delta3"][k] for k in moved})
    out = {
        "loss": _scalars(prog["loss"], ref["loss"]),
        "eval_loss": _scalars(prog["eval_loss"], ref["eval_loss"]),
        "grad1": _worst(g),
        "delta3": _worst(d),
        "grad1_median": statistics.median(g),
        "delta3_median": statistics.median(d),
    }
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def verdict(values: dict, limits: dict) -> bool:
    """True where the cell compares some numbers and each is within its
    limit."""
    return bool(limits) and all(values[k] <= lim for k, lim in limits.items())
