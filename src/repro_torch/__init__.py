"""PyTorch / CUDA port of the repro package for one NVIDIA H100 (Hopper).

It imports torch and numpy and nothing of ``repro`` or jax; its module names
mirror the JAX package's, which stays in the repository as the reference.
"""
