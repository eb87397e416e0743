# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Flash attention forward: the wrapper of the CUDA kernel in
``csrc/flash_attention.cu``.

:func:`flash_attention` computes ``softmax(q kᵀ · hd^-0.5) v`` over
(B, H, S, hd) operands, causal or full, in one pass over the key tiles with
an online softmax (the scores never reach device memory).  The kernel runs
both products on the tensor cores as 3xTF32 split products (f32 parity;
the source note says how).  GQA heads are repeated by the caller.  On a
CUDA tensor the wrapper checks its operands, picks the kernel's copy
variant (``aligned``: 16-byte ``cp.async`` copies where every base pointer
and B, H, S stride of q, k and v is a multiple of 16 bytes; else
``unaligned``, element copies), allocates the output in q's layout,
launches the kernel on the current stream and raises on a failed launch;
on a CPU tensor it computes the plain version in ``kernels/ref.py``.
``LAUNCHES`` counts kernel launches, nothing else, and ``CONFIG_LAUNCHES``
the same launches by copy variant.  There is no backward kernel here:
``kernels/ops.py`` differentiates the plain version, as the reference does.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, ref

SOURCE = "flash_attention"

#: kernel launches (plain CPU calls are not counted)
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
#: the same launches by copy variant
CONFIG_LAUNCHES: Dict[str, int] = {"aligned": 0, "unaligned": 0}

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 64, 128)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])


def reset_launches() -> None:
    for counts in (LAUNCHES, CONFIG_LAUNCHES):
        for k in counts:
            counts[k] = 0


def aligned(*ts: torch.Tensor) -> bool:
    """Every base pointer, and every stride but the unit-stride last one,
    is a multiple of 16 bytes: each row can be copied in 16-byte chunks."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1])
               for t in ts)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> None:
    """The reference's preconditions: (B, H, S, hd) operands, k matching v,
    q matching k in batch, heads and head dim, and Sq == Sk under the causal
    mask.  Each violation raises ``ValueError``."""
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError(f"flash_attention: q/k/v must be (B, H, S, hd), got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or \
            q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"vs k {tuple(k.shape)} vs v {tuple(v.shape)}")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: causal needs Sq == Sk (got "
                         f"{q.shape[2]} vs {k.shape[2]})")


def _fn():
    fn = build.library(SOURCE).helios_flash_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or \
            len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v must lie on one CUDA "
                         "device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q, k and v must share dtype "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"flash_attention: the head dim must be unit "
                         f"stride, got strides {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    # the output takes q's layout (a (B, S, H, hd) buffer seen as
    # (B, H, S, hd) when q is such a view), so the caller's transpose back
    # is free
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    vec = aligned(q, k, v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn()(_DTYPES[q.dtype], hd, int(vec), q.data_ptr(), k.data_ptr(),
               v.data_ptr(), o.data_ptr(), b, h, sq, sk, int(causal),
               hd ** -0.5,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["flash_attention"] += 1
    CONFIG_LAUNCHES["aligned" if vec else "unaligned"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, H, Sk, hd) -> (B, H, Sq, hd) in q's
    dtype.  Ragged lengths need no padding: the kernel masks them."""
    check_operands(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    return _launch(q, k, v, causal)
