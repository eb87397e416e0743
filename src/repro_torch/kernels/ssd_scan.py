# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Mamba2 SSD intra-chunk term: the wrapper of the CUDA kernels in
``csrc/ssd_scan.cu``.

:func:`ssd_diag` computes ``y[l, p] = Σ_{m≤l} (C_l·B_m) · exp(cum_l −
cum_m) · dtx[m, p]`` per (batch, chunk, head), the diagonal-block term of
the chunked SSD algorithm, without the (L, L, nh) decay tensors in device
memory.  The CUDA path is two kernels: the first computes C·Bᵀ once per
(batch, chunk) into an f32 workspace the wrapper allocates, the second
multiplies each head's decayed scores by its dtx; both run their products
on the tensor cores as 3xTF32 split products (f32 parity; the source note
says how).  On a CUDA tensor the wrapper checks its operands, picks the
kernels' copy variant (``aligned``: 16-byte ``cp.async`` copies where the
base pointers and the strides but the last of cr, br and dtx are
multiples of 16 bytes; else ``unaligned``, element copies), allocates the
output in dtx's layout and the workspace, launches both kernels on the
current stream and raises on a failed launch; on a CPU tensor it computes
the plain version in ``kernels/ref.py``.  ``LAUNCHES`` counts wrapper
calls that launched (one per call, whatever number of kernels it runs),
nothing else, and ``CONFIG_LAUNCHES`` the same calls by copy variant.
There is no backward kernel here: ``kernels/ops.py`` differentiates the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import aligned

SOURCE = "ssd_scan"

#: wrapper calls that launched on the card (CPU calls are not counted)
LAUNCHES: Dict[str, int] = {"ssd_diag": 0}
#: the same launches by copy variant
CONFIG_LAUNCHES: Dict[str, int] = {"aligned": 0, "unaligned": 0}

#: state and head dims the kernel is compiled for
DIMS = (16, 32, 64, 128)

#: rows of the kernels' l and m tiles
TILE = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 18 + [ctypes.c_void_p])


def reset_launches() -> None:
    for counts in (LAUNCHES, CONFIG_LAUNCHES):
        for k in counts:
            counts[k] = 0


def check_operands(cr: torch.Tensor, br: torch.Tensor, cum: torch.Tensor,
                   dtx: torch.Tensor) -> None:
    """The reference's shapes: cr, br (B, nc, L, ds); cum (B, nc, L, nh);
    dtx (B, nc, L, nh, hd).  Each violation raises ``ValueError``."""
    if cr.dim() != 4 or br.shape != cr.shape:
        raise ValueError(f"ssd_diag: cr and br must be one (B, nc, L, ds) "
                         f"shape, got {tuple(cr.shape)} and {tuple(br.shape)}")
    if cum.dim() != 4 or cum.shape[:3] != cr.shape[:3]:
        raise ValueError(f"ssd_diag: cum must be (B, nc, L, nh) = "
                         f"{tuple(cr.shape[:3])} + (nh,), got "
                         f"{tuple(cum.shape)}")
    if dtx.dim() != 5 or dtx.shape[:4] != cum.shape:
        raise ValueError(f"ssd_diag: dtx must be (B, nc, L, nh, hd) = "
                         f"{tuple(cum.shape)} + (hd,), got {tuple(dtx.shape)}")


def _fn():
    fn = build.library(SOURCE).helios_ssd_diag
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(cr: torch.Tensor, br: torch.Tensor, cum: torch.Tensor,
            dtx: torch.Tensor) -> torch.Tensor:
    ts = (cr, br, cum, dtx)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("ssd_diag: cr, br, cum and dtx must lie on one CUDA "
                         "device")
    if not (cr.dtype == br.dtype == dtx.dtype) or dtx.dtype not in _DTYPES:
        raise TypeError(f"ssd_diag: cr, br and dtx must share dtype float32 "
                        f"or bfloat16, got {cr.dtype}, {br.dtype}, "
                        f"{dtx.dtype}")
    b, nc, L, ds = cr.shape
    nh, hd = dtx.shape[3], dtx.shape[4]
    if ds not in DIMS or hd not in DIMS:
        raise ValueError(f"ssd_diag: state dim {ds} and head dim {hd} must "
                         f"be in {DIMS}")
    cum = cum.float()                       # a no-op for the model's f32 cum
    if cr.stride(3) != 1 or br.stride(3) != 1 or cum.stride(3) != 1 or \
            dtx.stride(4) != 1:
        raise ValueError(f"ssd_diag: the last dim of every operand must be "
                         f"unit stride, got strides {cr.stride()}, "
                         f"{br.stride()}, {cum.stride()}, {dtx.stride()}")
    y = torch.empty_like(dtx)
    if y.numel() == 0:
        return y
    vec = aligned(cr, br, dtx)
    # C·Bᵀ of every chunk, in whole tiles, for the second kernel (the C
    # side refuses a smaller workspace)
    side = TILE * -(-L // TILE)
    cb = torch.empty(b * nc * side * side, dtype=torch.float32,
                     device=dtx.device)
    stream = torch.cuda.current_stream(dtx.device).cuda_stream
    rc = _fn()(_DTYPES[dtx.dtype], ds, hd, int(vec),
               cr.data_ptr(), br.data_ptr(), cum.data_ptr(), dtx.data_ptr(),
               y.data_ptr(), cb.data_ptr(), cb.numel(), b, nc, nh, L,
               *cr.stride()[:3], *br.stride()[:3], *cum.stride()[:3],
               *dtx.stride()[:4], *y.stride()[:4], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_diag: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES["ssd_diag"] += 1
    CONFIG_LAUNCHES["aligned" if vec else "unaligned"] += 1
    return y


def ssd_diag(cr: torch.Tensor, br: torch.Tensor, cum: torch.Tensor,
             dtx: torch.Tensor) -> torch.Tensor:
    """cr, br: (B, nc, L, ds); cum: (B, nc, L, nh); dtx: (B, nc, L, nh, hd)
    -> (B, nc, L, nh, hd) in dtx's dtype.  Ragged L needs no padding: the
    kernel masks it."""
    check_operands(cr, br, cum, dtx)
    if dtx.device.type == "cpu":
        return ref.ssd_diag_ref(cr, br, cum, dtx)
    return _launch(cr, br, cum, dtx)
