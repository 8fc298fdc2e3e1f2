"""Experiment pipeline: synthetic graph generation, feature transplant,
split generation, graph statistics, sweep orchestration, summarization.

The port's copy of ``h2gcn_tpu.experiments`` (the reference's signac-flow
pipeline, rebuilt on the run store): the same graph → features → splits →
models workspace hierarchy, job ids and content-hashed, resumable run
identity, with sweeps that train through ``h2gcn_tpu_torch.run_experiments``.
``python -m h2gcn_tpu_torch.experiments --help`` lists the commands.
"""
