"""PyTorch/CUDA port of dafne_tpu: oriented object detection on NVIDIA Hopper.

The JAX package ``dafne_tpu`` is the reference this package is held against;
nothing here imports it.
"""
