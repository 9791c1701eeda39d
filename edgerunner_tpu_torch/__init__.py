"""edgerunner_tpu_torch: the PyTorch / CUDA port of edgerunner_tpu for NVIDIA Hopper.

Point-cloud-conditioned, grammar-constrained mesh generation with the ArAE
model, its attention running in hand-written CUDA kernels (csrc/) on the
card. The JAX package `edgerunner_tpu` is the reference it is held against;
this package imports nothing of it.
"""
