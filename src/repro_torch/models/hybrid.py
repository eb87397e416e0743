# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Hybrid Mamba2 + shared-attention assembly (Zamba2): the training loss.

``num_layers`` Mamba2 layers with stacked params; ONE shared transformer
block (attention + gated MLP, weights reused) runs before every
``attn_every``-th Mamba2 layer, so its gradients add up across its
invocations.  Zamba2's per-invocation LoRA on the shared block is omitted,
as in the reference.

Helios masks: ``ssm_heads`` (num_layers, nh) for the Mamba2 layers, and
``heads`` (1, H) / ``mlp`` (1, d_ff) for the shared block.  As in the
reference, the shared block takes ``rt["attn_impl"]`` and the plain masked
MLP (no kernel); ``rt["kernels"] == "cuda"`` sends every Mamba2 layer's
intra-chunk term through the ``ssd_diag`` kernel.  Prefill and decode are
not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.module import stack, tree_map


def hybrid_spec(cfg: ModelConfig):
    return {
        "embed": L.embed_spec(cfg.padded_vocab, cfg.d_model, True),
        "mamba_norms": stack(L.norm_spec(cfg.d_model, cfg.norm),
                             cfg.num_layers),
        "mamba": stack(ssm.mamba2_spec(cfg), cfg.num_layers),
        "shared_attn": {
            "attn_norm": L.norm_spec(cfg.d_model, cfg.norm),
            "attn": L.attention_spec(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.resolved_head_dim,
                                     cfg.qkv_bias),
            "mlp_norm": L.norm_spec(cfg.d_model, cfg.norm),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation),
        },
        "final_norm": L.norm_spec(cfg.d_model, cfg.norm),
    }


def mask_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    return {
        "ssm_heads": (cfg.num_layers, nh),
        "heads": (1, cfg.num_heads),          # shared block
        "mlp": (1, cfg.d_ff),
    }


def _attn_block(p, x, positions, cfg, rt, masks):
    hm = None if masks is None or "heads" not in masks else masks["heads"][0]
    mm = None if masks is None or "mlp" not in masks else masks["mlp"][0]
    h = L.apply_norm(p["attn_norm"], x, cfg.norm)
    x = x + L.attention_fwd(p["attn"], h, positions, theta=cfg.rope_theta,
                            impl=rt["attn_impl"], head_mask=hm)
    h2 = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    return x + L.mlp_fwd(p["mlp"], h2, cfg.activation, unit_mask=mm)


def _run(params, x, cfg, rt, masks):
    """The backbone in training mode: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i in range(cfg.num_layers):
        if cfg.attn_every and i % cfg.attn_every == 0:
            x = _attn_block(params["shared_attn"], x, positions, cfg, rt,
                            masks)
        p = tree_map(lambda t: t[i], params["mamba"])
        pn = tree_map(lambda t: t[i], params["mamba_norms"])
        hm = None if masks is None or "ssm_heads" not in masks else \
            masks["ssm_heads"][i]
        h = L.apply_norm(pn, x, cfg.norm)
        x = x + ssm.mamba2_fwd(p, h, cfg, head_mask=hm,
                               kernels=rt.get("kernels"))
    return x


def hybrid_loss(params, batch, cfg: ModelConfig, rt, masks=None):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    x = _run(params, x, cfg, rt, masks)
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], h)
    return L.cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
