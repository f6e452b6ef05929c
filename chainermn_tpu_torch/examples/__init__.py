"""Runnable examples of the port (``python -m
chainermn_tpu_torch.examples.<name>``), twins of the JAX package's
``examples/``."""
