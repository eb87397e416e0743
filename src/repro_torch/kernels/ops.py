# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Differentiable wrappers of the CUDA kernels: the execution seam of
kernel-backed soft-training (masked matmuls, flash attention and the SSD
intra-chunk term).

The model layers call :func:`masked_dense` / :func:`masked_contract` with
``impl="reference" | "cuda"`` (``"pallas"`` is an alias of ``"cuda"``, so
JAX configs carry over) and get the same numbers either way:

* the kernel path multiplies its output by the unit mask, so it is exact
  for ANY 0/1 mask, not only block-constant ones, while dead blocks are
  also skipped on the card;
* its ``torch.autograd.Function`` backward skips dead blocks too: dx by the
  contraction-skipping kernel over dy·mask, dw by the column-skipping
  kernel, with EXACTLY-zero gradients for masked-out columns (Helios
  frozen-neuron semantics) and no gradient for the mask.

:func:`flash_attention` runs the attention kernel forward and, as the
reference does, differentiates by recomputing the plain attention under
autograd in its backward (no backward kernel).  :func:`ssd_diag` does the
same for the Mamba2 intra-chunk term (the reference has no VJP for it).

Every Function runs under ``torch.func.vmap`` too (the batched round
engines vmap a local step over a cohort), one launch for the cohort: the
masked Functions' ``vmap`` rules move the client axis to the front and
call the client-axis kernels, and their backward calls the raw products
through small Functions that carry vmap rules of their own (an operand
the same for every client, ``in_dims=None``, reaches the kernels with a
client stride of 0); the flash attention and SSD Functions fold the
client axis into the kernels' batch axis, and their recompute backwards
go through ``torch.func.vjp``, which the transforms compose with.

On a CPU tensor the kernel wrappers compute their plain versions, so the
same autograd structure runs in the CPU tests.  The kernels mask ragged
edges themselves: no operand is padded here.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import masked_matmul as K
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as SS

#: canonical values of the ``kernels`` / ``impl`` knobs
CUDA = "cuda"
REFERENCE = "reference"
_ALIASES = {"pallas": CUDA, CUDA: CUDA, REFERENCE: REFERENCE}


def canonical_impl(impl: str) -> str:
    """``"pallas"`` -> ``"cuda"``; anything unknown raises."""
    try:
        return _ALIASES[impl]
    except KeyError:
        raise ValueError(f"kernels/impl must be one of {sorted(_ALIASES)}, "
                         f"got {impl!r}") from None


# ---------------------------------------------------------------------------
# block-aligned masks
# ---------------------------------------------------------------------------


def _pad_last(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % mult
    return F.pad(x, (0, pad)) if pad else x


def block_align_mask(unit_mask: torch.Tensor, block_n: int) -> torch.Tensor:
    """Round a unit mask UP to block granularity: idempotent, a superset of
    the input, and block-constant (every block of the padded mask is all-0
    or all-1)."""
    n = unit_mask.shape[-1]
    m = _pad_last(unit_mask, block_n)
    blocks = m.reshape(m.shape[:-1] + (-1, block_n)).amax(dim=-1)
    return blocks.repeat_interleave(block_n, dim=-1)[..., :n]


def _block_alive(unit_mask: torch.Tensor, block_n: int) -> torch.Tensor:
    """(N,) 0/1 mask -> (ceil(N/bn),) per-block flags (a block with ANY live
    unit runs; padding columns are dead)."""
    return _pad_last(unit_mask, block_n).reshape(-1, block_n).amax(dim=1)


#: unit mask -> (version, block, live list); a mask tensor lives for a whole
#: local-training cycle, so its live list is built (and, on the card, waited
#: for) once per cycle instead of once per launch
_LIVE = WeakIdKeyDictionary()


def _live(unit_mask: torch.Tensor, block: int) -> torch.Tensor:
    hit = _LIVE.get(unit_mask)
    if hit is not None and hit[0] == unit_mask._version and hit[1] == block:
        return hit[2]
    live = K.live_blocks(_block_alive(unit_mask, block))
    _LIVE[unit_mask] = (unit_mask._version, block, live)
    return live


#: (C, N) cohort masks -> their live tables.  Under vmap a mask reaches the
#: rules as a fresh view on every call, so entries are keyed by what the
#: view reads (address, shape, strides, version, block) and hold the view,
#: which keeps that memory from being reused while the entry lives.  A
#: cohort's masks live for a round: each table is built once a round.
_CLIENT_LIVE: "OrderedDict[tuple, tuple]" = OrderedDict()
_CLIENT_LIVE_SIZE = 64


def _client_live(masks: torch.Tensor,
                 block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, N) unit masks -> the client-axis kernels' (C, nb) live table and
    (C,) counts, built on the device without a host wait."""
    key = (masks.data_ptr(), masks.device, masks.dtype, tuple(masks.shape),
           masks.stride(), masks._version, block)
    hit = _CLIENT_LIVE.get(key)
    if hit is not None:
        _CLIENT_LIVE.move_to_end(key)
        return hit[1], hit[2]
    flags = _pad_last(masks, block).reshape(masks.shape[0], -1, block)
    table, counts = K.live_table(flags.amax(dim=-1))
    _CLIENT_LIVE[key] = (masks, table, counts)
    if len(_CLIENT_LIVE) > _CLIENT_LIVE_SIZE:
        _CLIENT_LIVE.popitem(last=False)
    return table, counts


def _clients_first(info, t: torch.Tensor, dim) -> torch.Tensor:
    """A vmap rule's operand with the client axis in front; one that every
    client shares (``dim`` None) as a stride-0 expansion."""
    if dim is None:
        return t.expand(info.batch_size, *t.shape)
    return t.movedim(dim, 0)


# ---------------------------------------------------------------------------
# masked dense layer (column-block skip) and masked contraction
# ---------------------------------------------------------------------------


def _mm(x, w, unit_mask, live, block_n):
    """Column-skipping kernel, exact ``x @ (w·mask)``: the multiply by the
    unit mask restores exactness for masks that are not block-constant and
    pins dead columns to zero."""
    y = K.masked_matmul(x, w, live, block_n)
    return y * unit_mask.to(y.dtype)[None, :]


def _mm_clients(x, w, masks, block_n):
    """:func:`_mm` over the client axis: x (C, M, K), w (C, K, N), masks
    (C, N), one launch."""
    live, counts = _client_live(masks, block_n)
    y = K.masked_matmul_clients(x, w, live, counts, block_n)
    return y * masks.to(y.dtype)[:, None, :]


def _dk_clients(x, w, masks, block_k):
    live, counts = _client_live(masks, block_k)
    return K.masked_matmul_dk_clients(x, w, live, counts, block_k)


class _Product(torch.autograd.Function):
    """A raw kernel product inside a masked Function's backward, vmappable:
    the column-skipping ``x @ (w·mask)`` or, with ``skip_k``, the
    contraction-skipping ``x @ w`` over the mask's live rows.  Never
    differentiated itself."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, w, unit_mask, block, skip_k):
        live = _live(unit_mask, block)
        if skip_k:
            return K.masked_matmul_dk(x, w, live, block)
        return _mm(x, w, unit_mask, live, block)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, dy):
        raise RuntimeError("a masked kernel product is not differentiated "
                           "twice")

    @staticmethod
    def vmap(info, in_dims, x, w, unit_mask, block, skip_k):
        x, w, m = (_clients_first(info, t, d)
                   for t, d in zip((x, w, unit_mask), in_dims))
        return (_dk_clients if skip_k else _mm_clients)(x, w, m, block), 0


class _MaskedDense(torch.autograd.Function):
    """``y = x @ (w · mask)`` at one mask-block granularity.

    Backward: dx = (dy·mask) @ wᵀ with dead N-blocks skipped in the
    contraction; dw = xᵀ @ (dy·mask) with dead column blocks skipped and
    masked columns exactly zero; no gradient for the mask.
    """

    generate_vmap_rule = False

    @staticmethod
    def forward(x, w, unit_mask, block_n):
        return _mm(x, w, unit_mask, _live(unit_mask, block_n), block_n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, unit_mask, block_n = inputs
        ctx.save_for_backward(x, w, unit_mask)
        ctx.block_n = block_n

    @staticmethod
    def backward(ctx, dy):
        x, w, unit_mask = ctx.saved_tensors
        bn = ctx.block_n
        dym = dy * unit_mask.to(dy.dtype)[None, :]
        dx = _Product.apply(dym, w.t(), unit_mask, bn, True)
        dw = _Product.apply(x.t(), dym, unit_mask, bn, False)
        return dx, dw, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, unit_mask, block_n):
        x, w, m = (_clients_first(info, t, d)
                   for t, d in zip((x, w, unit_mask), in_dims))
        return _mm_clients(x, w, m, block_n), 0


class _MaskedContract(torch.autograd.Function):
    """``y = h @ w`` where the CONTRACTION dim is unit-masked (exact when the
    masked columns of ``h`` are zero, as they are after :func:`masked_dense`).

    Backward: dh = dy @ wᵀ with masked columns zeroed; dw = hᵀ @ dy with
    dead row blocks skipped and masked rows exactly zero (computed as dwᵀ
    by the column-skipping kernel).
    """

    generate_vmap_rule = False

    @staticmethod
    def forward(h, w, unit_mask, block_n):
        return K.masked_matmul_dk(h * unit_mask.to(h.dtype)[None, :], w,
                                  _live(unit_mask, block_n), block_n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, w, unit_mask, block_n = inputs
        ctx.save_for_backward(h, w, unit_mask)
        ctx.block_n = block_n

    @staticmethod
    def backward(ctx, dy):
        h, w, unit_mask = ctx.saved_tensors
        bn = ctx.block_n
        dy = dy.contiguous()          # a broadcast cotangent has zero strides
        dh = _Product.apply(dy, w.t(), unit_mask, bn, False)
        dw = _Product.apply(dy.t(), h, unit_mask, bn, False).t()
        return dh, dw, None, None

    @staticmethod
    def vmap(info, in_dims, h, w, unit_mask, block_n):
        h, w, m = (_clients_first(info, t, d)
                   for t, d in zip((h, w, unit_mask), in_dims))
        return _dk_clients(h * m.to(h.dtype)[:, None, :], w, m, block_n), 0


def _collapse(x: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    """(..., K) -> (M, K) plus the leading dims to restore."""
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def masked_dense(x: torch.Tensor, w: torch.Tensor, unit_mask: torch.Tensor,
                 *, impl: str = REFERENCE, block_n: int = 128) -> torch.Tensor:
    """Soft-training dense layer: ``y = x @ (w · unit_mask[None, :])``.

    x: (..., K); w: (K, N); unit_mask: (N,) float 0/1.  ``impl="cuda"``
    runs the block-sparse kernel pair (forward and backward skip dead
    column blocks); ``"reference"`` is the plain semantics the kernels are
    held to.  Masked columns of y, and of every gradient, are exactly 0.
    """
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"masked_dense: x (..., K={x.shape[-1]}) does not "
                         f"contract with w {tuple(w.shape)} (want (K, N))")
    if tuple(unit_mask.shape) != (w.shape[1],):
        raise ValueError(f"masked_dense: unit_mask {tuple(unit_mask.shape)} "
                         f"must be (N,) = ({w.shape[1]},)")
    if canonical_impl(impl) == REFERENCE:
        return x @ (w * unit_mask.to(w.dtype)[None, :])
    x2, lead = _collapse(x)
    y = _MaskedDense.apply(x2, w, unit_mask, block_n)
    return y.reshape(lead + y.shape[-1:])


def masked_contract(h: torch.Tensor, w: torch.Tensor, unit_mask: torch.Tensor,
                    *, impl: str = REFERENCE,
                    block_n: int = 128) -> torch.Tensor:
    """Second half of a masked MLP: ``y = (h · unit_mask) @ w`` over the
    masked contraction dim.  h: (..., N); w: (N, K); unit_mask: (N,)."""
    if w.dim() != 2 or h.shape[-1] != w.shape[0]:
        raise ValueError(f"masked_contract: h (..., N={h.shape[-1]}) does not "
                         f"contract with w {tuple(w.shape)} (want (N, K))")
    if tuple(unit_mask.shape) != (w.shape[0],):
        raise ValueError(f"masked_contract: unit_mask "
                         f"{tuple(unit_mask.shape)} must be (N,) = "
                         f"({w.shape[0]},)")
    if canonical_impl(impl) == REFERENCE:
        return (h * unit_mask.to(h.dtype)) @ w
    h2, lead = _collapse(h)
    y = _MaskedContract.apply(h2, w, unit_mask, block_n)
    return y.reshape(lead + y.shape[-1:])


def masked_matmul(x: torch.Tensor, w: torch.Tensor, unit_mask: torch.Tensor,
                  *, block_n: int = 128) -> torch.Tensor:
    """y = x @ (w * unit_mask) on the column-skipping kernel, for a unit
    mask of ANY length (a ragged tail block is simply a shorter block)."""
    return _mm(x, w, unit_mask, _live(unit_mask, block_n), block_n)


# ---------------------------------------------------------------------------
# flash attention + recompute backward
# ---------------------------------------------------------------------------


def _fold_clients(info, in_dims, *ts) -> Tuple[torch.Tensor, ...]:
    """A batched-kernel vmap rule's operands with the client axis folded
    into the leading batch axis: (C, B, ...) -> (C·B, ...), a view where
    the layout allows (a shared operand is copied C times)."""
    return tuple(_clients_first(info, t, d).flatten(0, 1)
                 for t, d in zip(ts, in_dims))


def _unfold_clients(info, y: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(C·B, ...) -> (C, B, ...) with the client axis at 0."""
    return y.unflatten(0, (info.batch_size, -1)), 0


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; the backward re-evaluates the plain attention and
    differentiates it (``torch.func.vjp``, so it runs under the batched
    engine's transforms too), and the O(S²) scores live only inside the
    backward (the reference's ``_flash_diff``).  Under ``torch.func.vmap``
    the client axis folds into B: one launch for the cohort."""

    generate_vmap_rule = False

    @staticmethod
    def forward(q, k, v, causal):
        return FA.flash_attention(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal

    @staticmethod
    def backward(ctx, dy):
        _, vjp = torch.func.vjp(
            lambda q, k, v: ref.flash_attention_ref(q, k, v, ctx.causal),
            *ctx.saved_tensors)
        return (*vjp(dy), None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal):
        q, k, v = _fold_clients(info, in_dims[:3], q, k, v)
        return _unfold_clients(info, _FlashAttention.apply(q, k, v, causal))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, impl: str = CUDA) -> torch.Tensor:
    """q, k, v: (B, H, S, hd) -> (B, H, S, hd), differentiable.

    ``impl="cuda"`` runs the flash kernel forward and the recompute
    backward; ``"reference"`` is plain autograd through the dense
    attention.  Any length works (ragged tiles are masked in the kernel);
    ``causal`` needs Sq == Sk.
    """
    FA.check_operands(q, k, v, causal)
    if canonical_impl(impl) == REFERENCE:
        return ref.flash_attention_ref(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal)


# ---------------------------------------------------------------------------
# SSD intra-chunk term + recompute backward
# ---------------------------------------------------------------------------


class _SSDDiag(torch.autograd.Function):
    """Kernel forward; the backward re-evaluates the plain intra-chunk term
    and differentiates it (``torch.func.vjp``), so the (L, L, nh) decay
    tensors live only inside the backward.  The gradient of ``cum``
    carries those of dt and A.  Under ``torch.func.vmap`` the client axis
    folds into B: one launch for the cohort."""

    generate_vmap_rule = False

    @staticmethod
    def forward(cr, br, cum, dtx):
        return SS.ssd_diag(cr, br, cum, dtx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        _, vjp = torch.func.vjp(ref.ssd_diag_ref, *ctx.saved_tensors)
        return vjp(dy)

    @staticmethod
    def vmap(info, in_dims, cr, br, cum, dtx):
        ts = _fold_clients(info, in_dims, cr, br, cum, dtx)
        return _unfold_clients(info, _SSDDiag.apply(*ts))


def ssd_diag(cr: torch.Tensor, br: torch.Tensor, cum: torch.Tensor,
             dtx: torch.Tensor, *, impl: str = CUDA) -> torch.Tensor:
    """Mamba2 intra-chunk term, differentiable.  cr, br: (B, nc, L, ds);
    cum: (B, nc, L, nh); dtx: (B, nc, L, nh, hd) -> (B, nc, L, nh, hd).

    ``impl="cuda"`` runs the kernel forward and the recompute backward;
    ``"reference"`` is plain autograd through the einsum form.
    """
    SS.check_operands(cr, br, cum, dtx)
    if canonical_impl(impl) == REFERENCE:
        return ref.ssd_diag_ref(cr, br, cum, dtx)
    return _SSDDiag.apply(cr, br, cum, dtx)
