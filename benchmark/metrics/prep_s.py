"""The program's own host set-up seconds (``tensors["prep_seconds"]``,
summed: the exact-hop split, the reorder and the export of the matrices
with their payloads' tables)."""


def read(run):
    prep = run.program.tensors.get("prep_seconds") or {}
    return float(sum(prep.values())) if prep else None
