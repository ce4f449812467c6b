"""Helpers with the JAX package's ``xmca_tpu.tools`` entry points."""
