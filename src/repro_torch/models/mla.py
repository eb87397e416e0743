# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Training and prefill use the non-absorbed form (per-head K / V
materialized from the latent) through ``layers.attend``; decode uses the
ABSORBED form: scores are computed directly against the cached latent
``c_kv`` (B, S, kv_rank) and the shared RoPE key (B, S, rope_dim), so the
cache is rank + rope_dim wide instead of 2 * H * hd.

The latent bottleneck is shared across heads and is therefore NOT a
Helios maskable unit; ``heads`` is (the ``head_mask`` multiplies whole
query heads).  The layouts, axes and arithmetic are the reference's
(``repro.models.mla``); the attention takes ``impl`` as the reference's
does (``rt["attn_impl"]``), so it reaches no kernel: the flash kernel has
no head dim of 192.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import apply_norm, apply_rope, attend, \
    norm_spec
from repro_torch.models.module import P


def mla_spec(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": P((d, qr), ("embed", "q_lora")),
        "q_norm": norm_spec(qr, "rmsnorm"),
        "wq_b": P((qr, h, nope + rope), ("q_lora", "heads", "head_dim")),
        "wkv_a": P((d, kr + rope), ("embed", "kv_lora")),
        "kv_norm": norm_spec(kr, "rmsnorm"),
        "wk_b": P((kr, h, nope), ("kv_lora", "heads", "head_dim")),
        "wv_b": P((kr, h, vd), ("kv_lora", "heads", "head_dim")),
        "wo": P((h, vd, d), ("heads", "head_dim", "embed")),
    }


def _latent(params, x, positions, cfg):
    """The shared latent pipeline: (q_nope, q_rope, c_kv, k_rope), k_rope
    (B, S, 1, rope) after RoPE."""
    kr, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q_lat = apply_norm(params["q_norm"], x @ params["wq_a"])
    q = torch.einsum("bsr,rhk->bshk", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ params["wkv_a"]
    c_kv = apply_norm(params["kv_norm"], kv[..., :kr])
    k_rope = apply_rope(kv[..., kr:][:, :, None, :], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_fwd(params, x, positions, cfg, *, impl: str = "auto",
            head_mask: Optional[torch.Tensor] = None,
            return_cache: bool = False):
    """Train / prefill path (non-absorbed).  With ``return_cache`` also
    returns the latent cache ``{"c_kv": (B, S, kv_rank), "k_rope": (B, S,
    rope)}``."""
    vd = cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _latent(params, x, positions, cfg)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wk_b"])
    v = torch.einsum("bsr,rhv->bshv", c_kv, params["wv_b"])
    h = cfg.num_heads
    k_rope_b = k_rope.expand(k_rope.shape[:2] + (h, k_rope.shape[-1]))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    if head_mask is not None:
        q = q * head_mask.to(q.dtype)[None, None, :, None]
    # pad v so one attend runs over it; slice the value dims back out
    if v.shape[-1] != q.shape[-1]:
        v = torch.nn.functional.pad(v, (0, q.shape[-1] - v.shape[-1]))
    out = attend(q, k, v, causal=True, impl=impl)[..., :vd]
    y = torch.einsum("bqhv,hvd->bqd", out, params["wo"])
    if return_cache:
        return y, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
    return y


def mla_decode(params, x, cache, pos: int, cfg,
               head_mask: Optional[torch.Tensor] = None):
    """Absorbed one-token decode against the latent cache: x (B, 1, d) at
    position ``pos`` (a host int); ``cache`` {"c_kv": (B, S_max, kv_rank),
    "k_rope": (B, S_max, rope)}.

    The token's latent and RoPE key are written IN PLACE at ``pos``; a
    ``pos`` outside the cache raises (the reference's
    ``dynamic_update_slice`` clamps it to the last slot: ROADMAP §3).
    Returns (out, cache)."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    s_max = cache["c_kv"].shape[1]
    if not 0 <= pos < s_max:
        raise ValueError(f"decode position {pos} outside the latent cache "
                         f"of {s_max} positions; pad the prefill cache to "
                         f"the prompt plus the generated tokens")
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    q_nope, q_rope, c_new, kr_new = _latent(params, x, positions, cfg)
    cache["c_kv"][:, pos] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = kr_new[:, 0, 0].to(cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    # absorb W_uk into the query: score_nope = (q_nope @ W_uk^T) . c_kv
    q_eff = torch.einsum("bqhk,rhk->bqhr", q_nope, params["wk_b"])
    if head_mask is not None:
        q_eff = q_eff * head_mask.to(q_eff.dtype)[None, None, :, None]
        q_rope = q_rope * head_mask.to(q_rope.dtype)[None, None, :, None]
    scale = (nope + rope) ** -0.5
    logits = (torch.einsum("bqhr,bsr->bhqs", q_eff, c_kv)
              + torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope)).float() \
        * scale
    valid = (torch.arange(s_max, device=x.device) <= pos)[None, None, None]
    logits = torch.where(valid, logits, torch.full((), -1e30,
                                                   device=x.device))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)      # attend in latent
    out = torch.einsum("bqhr,rhv->bqhv", o_lat, params["wv_b"])
    y = torch.einsum("bqhv,hvd->bqd", out, params["wo"])
    return y, cache
