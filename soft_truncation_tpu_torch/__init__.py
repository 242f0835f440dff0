"""PyTorch + CUDA port of soft_truncation_tpu for NVIDIA Hopper.

A second package beside the JAX reference: it imports torch and numpy,
never jax or the JAX package. See ROADMAP.md for the slices ported so far.
"""
