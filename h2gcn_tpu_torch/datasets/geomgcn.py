"""GeomGCN edge-list dataset plugin: not ported yet (ROADMAP A3)."""


def add_subparser_args(parser):
    raise NotImplementedError(
        "the GeomGCN loader is not ported to h2gcn_tpu_torch yet "
        "(ROADMAP A3); use the planetoid format")
