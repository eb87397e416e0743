# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Encoder-decoder assembly (the SeamlessM4T backbone): the training loss,
prefill and decode.

The audio frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings ``enc_embeds`` (B, S_enc, d_model).  Encoder
block: non-causal self-attention and the MLP; decoder block: causal
self-attention, cross-attention to the encoder output (non-causal,
unmasked) and the MLP.  Both stacks keep the reference's stacked layouts
(``enc_blocks`` / ``dec_blocks``, a leading ``layers`` axis) and run as a
Python loop over ``module.unstack``, where the reference scans.

Helios masks: ``enc_heads`` / ``enc_mlp`` over the encoder's layers,
``heads`` / ``cross_heads`` / ``mlp`` over the decoder's.  Every attention
takes ``rt["attn_impl"]`` (the cross-attention ``"auto"``) and every MLP
its plain masked form, as in the reference, so the family reaches no
kernel under any ``rt["kernels"]``.

The serving cache is ``{"kv": {"self": {"k", "v"} each (L, B, S, KV, hd),
"cross": {"k", "v"} each (L, B, S_enc, H, hd)}, "pos": host int}``: decode
writes the self-attention K / V in place and reads the cross K / V as
they are.  The cross cache keeps the encoder's length: a padded key would
take probability mass, since nothing masks it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.module import stack, unstack


def _enc_block_spec(cfg: ModelConfig):
    return {
        "attn_norm": L.norm_spec(cfg.d_model, cfg.norm),
        "attn": L.attention_spec(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, cfg.qkv_bias),
        "mlp_norm": L.norm_spec(cfg.d_model, cfg.norm),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation),
    }


def _dec_block_spec(cfg: ModelConfig):
    spec = _enc_block_spec(cfg)
    spec["cross_norm"] = L.norm_spec(cfg.d_model, cfg.norm)
    spec["cross"] = L.attention_spec(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.resolved_head_dim,
                                     cfg.qkv_bias)
    return spec


def encdec_spec(cfg: ModelConfig):
    return {
        "embed": L.embed_spec(cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings),
        "enc_blocks": stack(_enc_block_spec(cfg), cfg.enc_layers),
        "dec_blocks": stack(_dec_block_spec(cfg), cfg.dec_layers),
        "enc_norm": L.norm_spec(cfg.d_model, cfg.norm),
        "final_norm": L.norm_spec(cfg.d_model, cfg.norm),
    }


def mask_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    return {
        "enc_heads": (cfg.enc_layers, cfg.num_heads),
        "enc_mlp": (cfg.enc_layers, cfg.d_ff),
        "heads": (cfg.dec_layers, cfg.num_heads),
        "cross_heads": (cfg.dec_layers, cfg.num_heads),
        "mlp": (cfg.dec_layers, cfg.d_ff),
    }


def _layer_masks(masks, keys, i: int) -> dict:
    """Layer ``i``'s slice of each of ``keys`` present in ``masks``."""
    if not masks:
        return {}
    return {k: masks[k][i] for k in keys if k in masks}


def _cross_attend(p, h, enc_out, head_mask=None, cross_kv=None):
    """Cross-attention: q from the decoder's ``h``, K / V from the encoder
    output (or ``cross_kv``), non-causal, no RoPE.  Returns (out, its K /
    V)."""
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cross_kv is None:
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
    else:
        k, v = cross_kv["k"], cross_kv["v"]
    if head_mask is not None:
        q = q * head_mask.to(q.dtype)[None, None, :, None]
    out = L.attend(q, k, v, causal=False, impl="auto")
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"]), {"k": k, "v": v}


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, device=x.device)[None].expand(b, s)


def _encode(params, enc_embeds, cfg: ModelConfig, rt, masks=None):
    x = enc_embeds
    positions = _positions(x)
    stacked = params["enc_blocks"]
    for i, p in enumerate(unstack(stacked, cfg.enc_layers)):
        m = _layer_masks(masks, ("enc_heads", "enc_mlp"), i)
        h = L.apply_norm(p["attn_norm"], x, cfg.norm)
        x = x + L.attention_fwd(p["attn"], h, positions, causal=False,
                                theta=cfg.rope_theta, impl=rt["attn_impl"],
                                head_mask=m.get("enc_heads"))
        h = L.apply_norm(p["mlp_norm"], x, cfg.norm)
        x = x + L.mlp_fwd(p["mlp"], h, cfg.activation,
                          unit_mask=m.get("enc_mlp"))
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def _decoder(params, x, enc_out, cfg: ModelConfig, rt, masks=None,
             mode: str = "train", cache=None):
    """The decoder stack and the final norm.  ``mode``: train | prefill
    (returns the self and cross caches) | decode (one token at
    ``cache["pos"]``, its self K / V written into ``cache`` in place, the
    cross K / V read from it).  Returns (h, the prefill's cache or
    None)."""
    positions = None if mode == "decode" else _positions(x)
    self_kv, cross_kv = [], []
    for i, p in enumerate(unstack(params["dec_blocks"], cfg.dec_layers)):
        m = _layer_masks(masks, ("heads", "cross_heads", "mlp"), i)
        h = L.apply_norm(p["attn_norm"], x, cfg.norm)
        if mode == "decode":
            kv = cache["kv"]
            a, _ = L.attention_decode(
                p["attn"], h, {k: v[i] for k, v in kv["self"].items()},
                cache["pos"], theta=cfg.rope_theta, head_mask=m.get("heads"))
            layer_cross = {k: v[i] for k, v in kv["cross"].items()}
        else:
            a = L.attention_fwd(p["attn"], h, positions, causal=True,
                                theta=cfg.rope_theta, impl=rt["attn_impl"],
                                head_mask=m.get("heads"),
                                return_kv=mode == "prefill")
            if mode == "prefill":
                a, kv_i = a
                self_kv.append(kv_i)
            layer_cross = None
        x = x + a
        h = L.apply_norm(p["cross_norm"], x, cfg.norm)
        c, ckv = _cross_attend(p["cross"], h, enc_out, m.get("cross_heads"),
                               cross_kv=layer_cross)
        if mode == "prefill":
            cross_kv.append(ckv)
        x = x + c
        h = L.apply_norm(p["mlp_norm"], x, cfg.norm)
        x = x + L.mlp_fwd(p["mlp"], h, cfg.activation, unit_mask=m.get("mlp"))
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    if mode != "prefill":
        return h, None

    def stacked(rows):
        return {k: torch.stack([r[k] for r in rows]) for k in ("k", "v")}

    return h, {"self": stacked(self_kv), "cross": stacked(cross_kv)}


def encdec_loss(params, batch, cfg: ModelConfig, rt, masks=None):
    """Mean next-token cross-entropy of the decoder's ``batch["tokens"]``
    (B, S) given the encoder's ``batch["enc_embeds"]``; the last position
    has no target."""
    enc_out = _encode(params, batch["enc_embeds"], cfg, rt, masks)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    h, _ = _decoder(params, x, enc_out, cfg, rt, masks)
    logits = L.unembed(params["embed"], h)
    mask = torch.ones(tokens.shape, dtype=logits.dtype, device=logits.device)
    mask[:, -1] = 0.0
    return L.cross_entropy_loss(logits[:, :-1], tokens[:, 1:], mask[:, :-1])


def encdec_prefill(params, batch, cfg: ModelConfig, rt, masks=None
                   ) -> Tuple[torch.Tensor, dict]:
    """Encode, then run the decoder over the prompt: the last position's
    logits (B, V) and the self and cross caches (the self cache exactly as
    long as the prompt)."""
    enc_out = _encode(params, batch["enc_embeds"], cfg, rt, masks)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    h, kv = _decoder(params, x, enc_out, cfg, rt, masks, mode="prefill")
    logits = L.unembed(params["embed"], h[:, -1:])
    return logits[:, 0], {"kv": kv, "pos": tokens.shape[1]}


def encdec_decode(params, token, cache, cfg: ModelConfig, rt,
                  masks: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """One decode step: ``token`` (B, 1) at ``cache["pos"]``; the self
    cache must have room there (see :func:`layers.attention_decode`).
    Returns (logits (B, V), cache with ``pos`` advanced)."""
    x = L.embed(params["embed"], token)
    h, _ = _decoder(params, x, None, cfg, rt, masks, mode="decode",
                    cache=cache)
    logits = L.unembed(params["embed"], h)
    return logits[:, 0], {"kv": cache["kv"], "pos": cache["pos"] + 1}
