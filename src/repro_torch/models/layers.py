# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Core transformer layers (functional, over param dicts): norms, RoPE, GQA
attention, the gated MLP, embeddings and the next-token loss.

Parameters keep the reference's layouts with head dims explicit (wq:
(d, H, hd), wo: (H, hd, d)), so Helios scores and masks reduce over the
same axes as in the JAX package and weights carry over unchanged.

Kernel routing: ``impl="cuda"`` (alias ``"pallas"``) sends full-sequence
causal self-attention through the flash kernel, and ``kernels="cuda"``
sends the masked MLP through the block-sparse masked-matmul pair.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.module import P

#: sequences this long take the chunked lowering in the reference
CHUNKED_FROM = 4096

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_spec(d: int, kind: str = "rmsnorm"):
    if kind == "rmsnorm":
        return {"scale": P((d,), ("embed",), init="ones")}
    return {"scale": P((d,), ("embed",), init="ones"),
            "bias": P((d,), ("embed",), init="zeros")}


def apply_norm(params, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMSNorm or LayerNorm, computed in f32 and cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        ms = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps) * params["scale"].float()
    else:
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S).  Half-split
    rotation (not interleaved), in f32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------


def attention_spec(d: int, n_heads: int, n_kv: int, head_dim: int,
                   bias: bool = False):
    spec = {
        "wq": P((d, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": P((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": P((n_heads, head_dim, d), ("heads", "head_dim", "embed")),
    }
    if bias:
        spec["bq"] = P((n_heads, head_dim), ("heads", "head_dim"), init="zeros")
        spec["bk"] = P((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = P((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _project_qkv(params, x, positions, theta):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def dense_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len_mask: Optional[torch.Tensor] = None):
    """Materialized-scores attention.  q: (B, Sq, H, hd); k, v:
    (B, Sk, KV, hd).  Scores in f32, masked at -1e30.  ``q_offset`` is the
    position of the first query (causal masking of a query block that
    starts later in the sequence); ``kv_len_mask`` (B, Sk) bool marks the
    keys each row may attend to."""
    groups = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    neg = torch.full((), -1e30, device=logits.device)
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, neg)
    if kv_len_mask is not None:
        logits = torch.where(kv_len_mask[:, None, None, :], logits, neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def attend(q, k, v, *, causal: bool, impl: str = "auto"):
    """Dispatch: ``impl="cuda"`` (alias ``"pallas"``) runs full-sequence
    causal self-attention shorter than :data:`CHUNKED_FROM` on the flash
    kernel (recompute backward); anything else takes ``"auto"``: dense
    attention, or the chunked lowering for long sequences, which the port
    does not have yet."""
    if impl in ("pallas", ops.CUDA):
        if causal and q.shape[1] == k.shape[1] and q.shape[1] < CHUNKED_FROM:
            groups = q.shape[2] // k.shape[2]
            kf = _repeat_kv(k, groups)
            vf = _repeat_kv(v, groups)
            out = ops.flash_attention(q.transpose(1, 2), kf.transpose(1, 2),
                                      vf.transpose(1, 2), causal=True,
                                      impl=ops.CUDA)
            return out.transpose(1, 2)
        impl = "auto"
    if impl == "auto":
        impl = "chunked" if (q.shape[1] >= CHUNKED_FROM
                             and q.shape[1] == k.shape[1]) else "dense"
    if impl == "chunked":
        raise NotImplementedError(
            "chunked_attention (sequences of 4096 and more) is not ported "
            "yet; see ROADMAP.md, modules to port, item 9")
    return dense_attention(q, k, v, causal=causal)


def attention_fwd(params, x, positions, *, causal=True, theta=10_000.0,
                  impl="auto", head_mask: Optional[torch.Tensor] = None,
                  return_kv: bool = False):
    """Full self-attention over x: (B, S, d) with RoPE.  ``head_mask``
    (H,) 0/1 multiplies whole query heads (Helios head units).  With
    ``return_kv`` (prefill) also returns the KV cache ``{"k", "v"}``
    (B, S, KV, hd), K after RoPE."""
    q, k, v = _project_qkv(params, x, positions, theta)
    if head_mask is not None:
        q = q * head_mask.to(q.dtype)[None, None, :, None]
    out = attend(q, k, v, causal=causal, impl=impl)
    out = torch.einsum("bqhk,hkd->bqd", out, params["wo"])
    return (out, {"k": k, "v": v}) if return_kv else out


def attention_decode(params, x, cache, pos: int, *, theta=10_000.0,
                     head_mask: Optional[torch.Tensor] = None):
    """One decode step: x (B, 1, d) at position ``pos`` (a host int);
    ``cache`` {"k", "v"}: (B, S_max, KV, hd).

    The new K / V are written IN PLACE at ``pos``, and the token attends to
    positions <= pos.  A ``pos`` outside the cache raises: the reference's
    ``dynamic_update_slice`` clamps it to the last slot instead, so a cache
    as long as the prompt overwrites its last entry at every step (ROADMAP
    §3); the serving layer sizes the cache for the generated tokens.
    Returns (out, cache)."""
    s_max = cache["k"].shape[1]
    if not 0 <= pos < s_max:
        raise ValueError(f"decode position {pos} outside the KV cache of "
                         f"{s_max} positions; pad the prefill cache to the "
                         f"prompt plus the generated tokens")
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    q, k_new, v_new = _project_qkv(params, x, positions, theta)
    if head_mask is not None:
        q = q * head_mask.to(q.dtype)[None, None, :, None]
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    valid = (torch.arange(s_max, device=x.device) <= pos)[None, :]
    valid = valid.expand(x.shape[0], s_max)
    out = dense_attention(q, cache["k"], cache["v"], causal=False,
                          kv_len_mask=valid)
    return torch.einsum("bqhk,hkd->bqd", out, params["wo"]), cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU), masked mode
# ---------------------------------------------------------------------------


def mlp_spec(d: int, ff: int, activation: str = "silu"):
    if activation == "silu":
        return {
            "wi": P((d, ff), ("embed", "mlp")),
            "wg": P((d, ff), ("embed", "mlp")),
            "wo": P((ff, d), ("mlp", "embed")),
        }
    return {
        "wi": P((d, ff), ("embed", "mlp")),
        "wo": P((ff, d), ("mlp", "embed")),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def mlp_fwd(params, x, activation: str = "silu",
            unit_mask: Optional[torch.Tensor] = None,
            kernels: Optional[str] = None, mask_block: int = 128):
    """Gated MLP with the Helios ``unit_mask`` (float 0/1 over d_ff).

    With ``kernels="cuda"`` the masked products run on the block-sparse
    masked-matmul pair (dead column blocks skipped forward and backward,
    masked-unit gradients exactly zero); otherwise the plain masked
    semantics.  The reference's compact mode (``active_idx``) is not
    ported yet.
    """
    wi, wo = params["wi"], params["wo"]
    wg = params.get("wg")
    if kernels is not None and ops.canonical_impl(kernels) == ops.CUDA \
            and unit_mask is not None:
        hi = ops.masked_dense(x, wi, unit_mask, impl=ops.CUDA,
                              block_n=mask_block)
        if activation == "silu":
            hg = ops.masked_dense(x, wg, unit_mask, impl=ops.CUDA,
                                  block_n=mask_block)
            h = F.silu(hg) * hi
        else:
            h = _gelu(hi)
        return ops.masked_contract(h, wo, unit_mask, impl=ops.CUDA,
                                   block_n=mask_block)
    h = x @ wi
    if activation == "silu":
        h = F.silu(x @ wg) * h
    else:
        h = _gelu(h)
    if unit_mask is not None:
        h = h * unit_mask.to(h.dtype)[None, None, :]
    return h @ wo


# ---------------------------------------------------------------------------
# Embedding / unembedding / loss
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d: int, tie: bool):
    spec = {"embedding": P((vocab, d), ("vocab", "embed"), init="embed",
                           scale=0.02)}
    if not tie:
        spec["unembed"] = P((d, vocab), ("embed", "vocab"), init="embed",
                            scale=0.02)
    return spec


def embed(params, tokens):
    # F.embedding's backward sums a row's gradients in a fixed order (an
    # indexing gather's backward on the CPU accumulates in thread order)
    return F.embedding(tokens.long(), params["embedding"])


def unembed(params, x):
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["embedding"].t()


def cross_entropy_loss(logits, targets, mask=None):
    """Mean next-token CE.  logits: (B, S, V); targets: (B, S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
