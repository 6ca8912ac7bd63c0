"""PyTorch/CUDA port of xggm_tpu for NVIDIA Hopper.

The layout mirrors `xggm_tpu/` module for module. This package imports
`torch` and never `jax`, `flax` or `xggm_tpu`; the JAX package stays the
reference the port is tested against. Entry points run on `cuda` unless the
caller passes `device="cpu"`, and raise when no card is present.
"""
