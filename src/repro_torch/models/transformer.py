# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Decoder-only LM assembly, dense family: the training loss.

The layer params are STACKED as in the reference (a leading ``layers`` axis
on every leaf of ``blocks``), so Eq. 1 scores, mask expansion and Eq. 10
aggregation see the reference's layouts.  The backbone is a Python loop
over the layers; the reference's ``lax.scan`` and remat are compile devices
with the same numbers.

Helios masks enter as a dict of stacked unit masks
``{"heads": (L, H), "mlp": (L, d_ff)}``, sliced per layer; masked-out units
drop out of the forward pass, so their parameters get zero gradient.
Prefill and decode are not ported yet: they run no kernel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import stack, tree_map

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port's LM is the dense family only, got {cfg.family!r}; "
            "MoE, MLA and VLM wait (ROADMAP.md, modules to port, item 9)")


def _block_spec(cfg: ModelConfig):
    return {
        "attn_norm": L.norm_spec(cfg.d_model, cfg.norm),
        "attn": L.attention_spec(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, cfg.qkv_bias),
        "mlp_norm": L.norm_spec(cfg.d_model, cfg.norm),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation),
    }


def lm_spec(cfg: ModelConfig):
    _check_family(cfg)
    spec: Dict[str, Any] = {"embed": L.embed_spec(cfg.padded_vocab,
                                                  cfg.d_model,
                                                  cfg.tie_embeddings)}
    spec["blocks"] = stack(_block_spec(cfg), cfg.num_layers)
    spec["final_norm"] = L.norm_spec(cfg.d_model, cfg.norm)
    return spec


def mask_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    """Helios maskable-unit table: key -> (num_layers, units)."""
    _check_family(cfg)
    return {"heads": (cfg.num_layers, cfg.num_heads),
            "mlp": (cfg.num_layers, cfg.d_ff)}


def _stack_masks(masks, n_layers: int):
    """The stack's mask slices under canonical keys (heads / mlp)."""
    if not masks:
        return {}
    return {k: masks[k] for k in ("heads", "mlp")
            if k in masks and masks[k].shape[0] == n_layers}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _block_fwd(p, x, positions, cfg, rt, *, head_mask=None, mlp_mask=None):
    """One pre-norm block.  ``rt["kernels"] == "cuda"`` routes the causal
    self-attention through the flash kernel (unless the runtime asks for
    the chunked lowering) and the masked MLP through the masked-matmul
    pair."""
    kern = rt.get("kernels")
    on_kernels = kern is not None and ops.canonical_impl(kern) == ops.CUDA
    attn_impl = ops.CUDA if (on_kernels and rt["attn_impl"] != "chunked") \
        else rt["attn_impl"]
    h = L.apply_norm(p["attn_norm"], x, cfg.norm)
    x = x + L.attention_fwd(p["attn"], h, positions, theta=cfg.rope_theta,
                            impl=attn_impl, head_mask=head_mask)
    h = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    y = L.mlp_fwd(p["mlp"], h, cfg.activation, unit_mask=mlp_mask,
                  kernels=kern, mask_block=rt.get("mask_block", 128))
    return x + y


def _backbone(params, x, positions, cfg, rt, masks=None):
    stacked = params["blocks"]
    n_layers = stacked["attn"]["wq"].shape[0]
    sl = _stack_masks(masks, n_layers)
    for i in range(n_layers):
        x = _block_fwd(tree_map(lambda t: t[i], stacked), x, positions, cfg,
                       rt, head_mask=sl["heads"][i] if "heads" in sl else None,
                       mlp_mask=sl["mlp"][i] if "mlp" in sl else None)
    return L.apply_norm(params["final_norm"], x, cfg.norm)


# ---------------------------------------------------------------------------
# Entry point: the training loss
# ---------------------------------------------------------------------------


def default_runtime() -> dict:
    """Execution knobs threaded through the model functions (the
    reference's ``default_runtime`` at training lengths)."""
    return {"attn_impl": "auto", "kernels": ops.REFERENCE, "mask_block": 128}


def _embed_inputs(params, batch, cfg):
    """Token embedding (the VLM image prefix is not ported).  Returns
    (x, loss_mask)."""
    x = L.embed(params["embed"], batch["tokens"])
    return x, torch.ones(batch["tokens"].shape, dtype=x.dtype,
                         device=x.device)


def lm_loss(params, batch, cfg: ModelConfig, rt, masks=None):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S); the
    last position has no target."""
    x, loss_mask = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    h = _backbone(params, x, positions, cfg, rt, masks)
    logits = L.unembed(params["embed"], h)
    tokens = batch["tokens"]
    targets = torch.cat([tokens, torch.zeros((b, 1), dtype=tokens.dtype,
                                             device=tokens.device)], dim=1)
    mask = loss_mask.clone()
    mask[:, -1] = 0.0                                   # no target for last
    return L.cross_entropy_loss(logits, targets[:, 1:], mask)
