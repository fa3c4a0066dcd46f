"""PyTorch/CUDA port of the Forge-UGC reproduction.

Mirrors ``src/repro`` module for module; imports torch and numpy, never
jax and never the JAX package.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""
