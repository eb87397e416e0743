"""PyTorch + CUDA port of the Helios reproduction (see ``src/repro`` for the
JAX reference it is held against).

This package imports ``torch`` and ``numpy`` only.  Its layout mirrors the
JAX package module for module; the masked dense layers, the LM's attention
and the hybrid's SSD intra-chunk term run on hand-written CUDA kernels for
Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Importing the package calls each CPU math function that torch hands to
Intel MKL's vector math library (``exp_vml_cpu`` and its kin) once on one
element.  MKL sets such a function up on its first call; when that first
call comes from several OpenMP threads at once (a tensor large enough for
torch to split), some of the threads can return wrong values: on torch
2.13.0+cpu under a loaded host, the first ``torch.exp`` of a process was
off by up to 1e-4 in ~4 % of fresh processes, and ``log``, ``sin``,
``cos``, ``sqrt`` and ``tanh`` likewise.  A one-element call runs on one
thread, and every later call is then exact.
"""
import torch as _torch

#: torch's CPU functions whose kernels are its vector math ones
#: (``<name>_vml_cpu``; MKL's library where torch was built with it)
_VML_FUNCTIONS = ("acos", "asin", "atan", "cos", "erf", "erfc", "erfinv",
                  "exp", "expm1", "i0", "lgamma", "log", "log10", "log1p",
                  "log2", "round", "sin", "sqrt", "tan", "tanh")


def _set_up_vml() -> None:
    for dtype in (_torch.float32, _torch.float64):
        one = _torch.full((1,), 0.5, dtype=dtype)
        for name in _VML_FUNCTIONS:
            getattr(_torch, name)(one)


_set_up_vml()
