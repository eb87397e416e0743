"""PyTorch + CUDA port of the Helios reproduction (see ``src/repro`` for the
JAX reference it is held against).

This package imports ``torch`` and ``numpy`` only.  Its layout mirrors the
JAX package module for module; the masked dense layers, the LM's attention
and the hybrid's SSD intra-chunk term run on hand-written CUDA kernels for
Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
"""
