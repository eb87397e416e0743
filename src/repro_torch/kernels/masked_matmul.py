# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Block-sparse masked matmul: wrappers of the CUDA kernels in
``csrc/masked_matmul.cu``.

* :func:`masked_matmul` — y = x @ w with the dead OUTPUT-column blocks
  skipped (zero in y, their weights never read): the soft-training forward
  and dw.
* :func:`masked_matmul_dk` — y = x @ w with the dead CONTRACTION blocks
  skipped, exact when the skipped operand entries are zero: the dx of the
  masked layer.

Both take the mask as ``live``, the ascending int32 indices of the live
blocks (:func:`live_blocks` builds it from per-block flags), plus the mask
block width.  On a CUDA tensor a wrapper checks its operands, allocates a
zero-filled output, launches its kernel on the current stream and raises on
a failed launch; on a CPU tensor it computes the plain version in
``kernels/ref.py``.  ``LAUNCHES`` counts kernel launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, ref

SOURCE = "masked_matmul"

#: kernel launches per wrapper (plain CPU calls are not counted)
LAUNCHES: Dict[str, int] = {"masked_matmul": 0, "masked_matmul_dk": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def live_blocks(block_alive: torch.Tensor) -> torch.Tensor:
    """Per-block 0/1 flags -> int32 indices of the live blocks (ascending).
    On a CUDA tensor this waits for the flags: the count sets the grid."""
    return torch.nonzero(block_alive).flatten().to(torch.int32)


def _fn(name: str):
    fn = getattr(build.library(SOURCE), f"helios_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _strided_ok(t: torch.Tensor) -> bool:
    """A 2-D view with one unit stride (row- or column-major, any pitch)."""
    return t.dim() == 2 and (t.stride(1) == 1 or t.stride(0) == 1)


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
            block: int) -> torch.Tensor:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not (M, K) and (K, N)")
    if not (x.is_cuda and w.is_cuda and live.is_cuda) or \
            len({x.device, w.device, live.device}) != 1:
        raise ValueError(f"{name}: x, w and live must lie on one CUDA device")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x and w must share dtype float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if live.dtype != torch.int32 or live.dim() != 1 or \
            not live.is_contiguous():
        raise TypeError(f"{name}: live must be a contiguous 1-D int32 tensor")
    if not (_strided_ok(x) and _strided_ok(w)):
        raise ValueError(f"{name}: x and w need a unit stride in one of "
                         f"their two dims, got strides {x.stride()} and "
                         f"{w.stride()}")
    if block < 1:
        raise ValueError(f"{name}: mask block must be >= 1, got {block}")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0 or live.numel() == 0:
        # nothing live: the zeros are the answer
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    # the column kernel writes live tiles only, so its dead columns come
    # from the zero fill; the dk kernel writes every element
    alloc = torch.zeros if name == "masked_matmul" else torch.empty
    y = alloc((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn(name)(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
                   live.data_ptr(), live.numel(), block, m, n, k,
                   x.stride(0), x.stride(1), w.stride(0), w.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    return y


def masked_matmul(x: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
                  block_n: int) -> torch.Tensor:
    """y = x @ w with the N-blocks not in ``live`` zero and unread.

    x: (M, K); w: (K, N); live: int32 indices of live ``block_n``-column
    blocks.  Output in x's dtype, accumulated in f32.
    """
    if x.device.type == "cpu":
        return ref.masked_matmul_ref(x, w, live, block_n)
    return _launch("masked_matmul", x, w, live, block_n)


def masked_matmul_dk(x: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
                     block_k: int) -> torch.Tensor:
    """y = x @ w summing over the ``block_k``-row contraction blocks in
    ``live`` only (exact when x's other columns are zero)."""
    if x.device.type == "cpu":
        return ref.masked_matmul_dk_ref(x, w, live, block_k)
    return _launch("masked_matmul_dk", x, w, live, block_k)
