"""Training-runtime modules: argument/hook engine, logging, checkpointing,
monitors and early stopping."""
