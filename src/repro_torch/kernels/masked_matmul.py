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
block width.  On a CUDA tensor a wrapper checks its operands, lets
:func:`plan` pick a configuration from the shapes, allocates the output
(and the split-K workspace), launches on the current stream and raises on a
failed launch; on a CPU tensor it computes the plain version in
``kernels/ref.py``.

:func:`masked_matmul_clients` / :func:`masked_matmul_dk_clients` are the
pair over a leading client axis, one launch for a cohort: y[c] = x[c] @
w[c] with client c's own dead blocks skipped, from a (C, nb) table of live
indices and (C,) counts (:func:`live_table`, built on the device without
waiting for it).  An operand may be shared by the whole cohort through a
client stride of 0 (``expand``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

SOURCE = "masked_matmul"

#: configurations of the kernel pair; the index is the C side's config id
CONFIGS = ("general", "tile128", "splitk")
#: (rows, columns, contraction depth) of one output tile and stage
TILES = {"general": (32, 64, 32), "tile128": (128, 128, 16),
         "splitk": (32, 64, 32)}
#: SMs of an H100 SXM; split-K fills up to two waves of them
SMS = 132
#: least contraction a split of the column kernel walks
MIN_SPLIT_K = 128

#: wrapper calls that ran on the card, one per call whatever number of
#: kernels (a split-K call launches two) it took; CPU calls are not counted
LAUNCHES: Dict[str, int] = {"masked_matmul": 0, "masked_matmul_dk": 0}
#: the same calls, by the configuration :func:`plan` picked
CONFIG_LAUNCHES: Dict[str, int] = {c: 0 for c in CONFIGS}
#: calls of the client-axis entry points on the card, one per cohort call
CLIENT_LAUNCHES: Dict[str, int] = {"masked_matmul": 0, "masked_matmul_dk": 0}
#: the same calls, by configuration
CLIENT_CONFIG_LAUNCHES: Dict[str, int] = {c: 0 for c in CONFIGS}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 7 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_void_p])
_CLIENT_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                    + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 11
                    + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])


def reset_launches() -> None:
    for counts in (LAUNCHES, CONFIG_LAUNCHES, CLIENT_LAUNCHES,
                   CLIENT_CONFIG_LAUNCHES):
        for k in counts:
            counts[k] = 0


def live_blocks(block_alive: torch.Tensor) -> torch.Tensor:
    """Per-block 0/1 flags -> int32 indices of the live blocks (ascending).
    On a CUDA tensor this waits for the flags: the count sets the grid."""
    return torch.nonzero(block_alive).flatten().to(torch.int32)


def live_table(block_alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, nb) per-block 0/1 flags -> ((C, nb) int32 table, (C,) int32
    counts): row c lists client c's live block indices ascending, then its
    dead ones (which the kernels never read).  Nothing here waits for the
    device: the client-axis grid covers every block."""
    dead = (block_alive == 0).to(torch.int32)
    table = torch.sort(dead, dim=1, stable=True).indices.to(torch.int32)
    return table, (block_alive != 0).sum(dim=1, dtype=torch.int32)


@dataclass(frozen=True)
class Plan:
    """How one call runs: the kernel's grid is (tiles_m, tiles_n, splits),
    on the client axis (clients · tiles_m, tiles_n, splits).

    ``k_split`` is what one split walks: contraction rows for the column
    kernel, live blocks of the list for the dk kernel.  ``workspace`` is the
    (splits, M, N) f32 buffer of the split-K partial sums, on the client
    axis (splits, C, M, N), or None.  ``tiles_m`` is one client's row tiles.
    """
    config: str
    tile: Tuple[int, int, int]
    splits: int
    k_split: int
    grid: Tuple[int, int, int]
    workspace: Optional[Tuple[int, ...]]
    tiles_m: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte chunks along the unit-stride dim stay 16-byte aligned: an
    aligned start and a pitch (the other stride) a multiple of 4 floats;
    on the client axis (3-D) a client stride that is one too."""
    s0, s1 = t.stride()[-2:]
    pitch = s1 if s0 == 1 else s0 if s1 == 1 else 1
    lead = t.stride(0) if t.dim() == 3 else 0
    return pitch % 4 == 0 and lead % 4 == 0 and t.data_ptr() % 16 == 0


def plan(kind: str, m: int, n: int, k: int, n_live: int, block: int,
         x: torch.Tensor, w: torch.Tensor,
         clients: Optional[int] = None) -> Plan:
    """The configuration of one call, from its shapes alone (no CUDA call).

    ``kind`` is ``"masked_matmul"`` (column kernel) or
    ``"masked_matmul_dk"``.  ``tile128`` for f32 at M >= 128 with a mask
    block that is a multiple of 128 and 16-byte aligned operands;
    ``splitk`` at M < 128, with as many splits S as keep at least 128
    contraction rows (dk: one live block) a split, up to two waves of
    blocks over all clients (S may be 1, and then no workspace); ``general``
    otherwise.  ``clients`` is C on the client axis (None: the single-client
    entry points); there ``n_live`` is the table's width, every block a
    client could have.  Raises ValueError when the grid exceeds CUDA's
    limits.
    """
    skip_k = kind == "masked_matmul_dk"
    if m < 128:
        config = "splitk"
    elif (x.dtype == torch.float32 and w.dtype == torch.float32
          and block % 128 == 0 and max(m, n, k) < 2 ** 31
          and _vec_ok(x) and _vec_ok(w)):
        config = "tile128"
    else:
        config = "general"
    bm, bn, bk = TILES[config]
    tiles_m = _cdiv(m, bm)
    tiles_n = _cdiv(n, bn) if skip_k else n_live * _cdiv(block, bn)
    depth = n_live if skip_k else k           # what the splits partition
    c = clients or 1
    splits = 1
    if config == "splitk":
        most = n_live if skip_k else k // MIN_SPLIT_K
        splits = max(1, min(2 * SMS // (c * tiles_m * tiles_n), most))
    k_split = _cdiv(depth, splits)
    if not skip_k:
        k_split = _cdiv(k_split, bk) * bk     # whole stages a split
    splits = _cdiv(depth, k_split)
    if tiles_n > 65535 or splits > 65535 or c * tiles_m > 2 ** 31 - 1:
        raise ValueError(f"{kind}: grid ({c * tiles_m}, {tiles_n}, {splits}) "
                         "exceeds CUDA's limits (x <= 2^31 - 1, y and z <= "
                         "65535)")
    ws = None if splits == 1 else (splits, m, n) if clients is None else \
        (splits, clients, m, n)
    return Plan(config, (bm, bn, bk), splits, k_split,
                (c * tiles_m, tiles_n, splits), ws, tiles_m)


def _fn(name: str):
    fn = getattr(build.library(SOURCE), f"helios_{name}")
    if fn.argtypes is None:
        fn.argtypes = _CLIENT_ARGTYPES if name.endswith("_clients") \
            else _ARGTYPES
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
    p = plan(name, m, n, k, live.numel(), block, x, w)
    # the column kernel's tiles write live columns only, so its dead columns
    # come from the zero fill; the dk kernel and the split-K reduce write
    # every element
    alloc = torch.zeros if name == "masked_matmul" and p.workspace is None \
        else torch.empty
    y = alloc((m, n), dtype=x.dtype, device=x.device)
    ws = None if p.workspace is None else \
        torch.empty(p.workspace, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn(name)(_DTYPES[x.dtype], CONFIGS.index(p.config), x.data_ptr(),
                   w.data_ptr(), y.data_ptr(),
                   None if ws is None else ws.data_ptr(), live.data_ptr(),
                   live.numel(), block, m, n, k, x.stride(0), x.stride(1),
                   w.stride(0), w.stride(1), *p.grid, p.k_split, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    CONFIG_LAUNCHES[p.config] += 1
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


def _launch_clients(name: str, x: torch.Tensor, w: torch.Tensor,
                    live: torch.Tensor, counts: torch.Tensor,
                    block: int) -> torch.Tensor:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"{name}_clients: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (C, M, K) and (C, K, N)")
    c, m, k = x.shape
    n = w.shape[2]
    if tuple(counts.shape) != (c,) or live.dim() != 2 or \
            live.shape[0] != c or live.shape[1] < 1:
        raise ValueError(f"{name}_clients: live {tuple(live.shape)} and "
                         f"counts {tuple(counts.shape)} are not (C, nb) and "
                         f"(C,) with C = {c}")
    tensors = (x, w, live, counts)
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}_clients: x, w, live and counts must lie on "
                         "one CUDA device")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"{name}_clients: x and w must share dtype float32 "
                        f"or bfloat16, got {x.dtype} and {w.dtype}")
    if live.dtype != torch.int32 or counts.dtype != torch.int32 or \
            live.stride(1) != 1:
        raise TypeError(f"{name}_clients: live and counts must be int32, "
                        "live's rows contiguous")
    if not (_strided_ok(x[0]) and _strided_ok(w[0])):
        raise ValueError(f"{name}_clients: a client's x and w need a unit "
                         f"stride in one of their two dims, got strides "
                         f"{x.stride()} and {w.stride()}")
    if block < 1:
        raise ValueError(f"{name}_clients: mask block must be >= 1, got "
                         f"{block}")
    nb = live.shape[1]
    if m == 0 or n == 0 or k == 0 or c == 0:
        return torch.zeros((c, m, n), dtype=x.dtype, device=x.device)
    p = plan(name, m, n, k, nb, block, x, w, clients=c)
    alloc = torch.zeros if name == "masked_matmul" and p.workspace is None \
        else torch.empty
    y = alloc((c, m, n), dtype=x.dtype, device=x.device)
    ws = None if p.workspace is None else \
        torch.empty(p.workspace, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn(f"{name}_clients")(
        _DTYPES[x.dtype], CONFIGS.index(p.config), x.data_ptr(), w.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(), live.data_ptr(),
        counts.data_ptr(), nb, block, c, m, n, k, x.stride(0), x.stride(1),
        x.stride(2), w.stride(0), w.stride(1), w.stride(2), live.stride(0),
        counts.stride(0), p.tiles_m, p.grid[1], p.splits, p.k_split, stream)
    if rc != 0:
        raise RuntimeError(f"{name}_clients: kernel launch failed with CUDA "
                           f"error {rc}")
    CLIENT_LAUNCHES[name] += 1
    CLIENT_CONFIG_LAUNCHES[p.config] += 1
    return y


def masked_matmul_clients(x: torch.Tensor, w: torch.Tensor,
                          live: torch.Tensor, counts: torch.Tensor,
                          block_n: int) -> torch.Tensor:
    """y[c] = x[c] @ w[c] with the N-blocks not among client c's
    ``live[c, :counts[c]]`` zero and unread, one launch for the cohort.

    x: (C, M, K); w: (C, K, N) (a client stride of 0 shares one operand);
    live, counts: :func:`live_table` of the (C, N / block_n) flags.
    """
    if x.device.type == "cpu":
        return ref.masked_matmul_clients_ref(x, w, live, counts, block_n)
    return _launch_clients("masked_matmul", x, w, live, counts, block_n)


def masked_matmul_dk_clients(x: torch.Tensor, w: torch.Tensor,
                             live: torch.Tensor, counts: torch.Tensor,
                             block_k: int) -> torch.Tensor:
    """y[c] = x[c] @ w[c] summing over client c's live ``block_k``-row
    contraction blocks only, one launch for the cohort."""
    if x.device.type == "cpu":
        return ref.masked_matmul_dk_clients_ref(x, w, live, counts, block_k)
    return _launch_clients("masked_matmul_dk", x, w, live, counts, block_k)
