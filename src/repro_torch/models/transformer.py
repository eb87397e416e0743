# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Decoder-only LM assembly, dense, MoE and VLM families: the training
loss, prefill and decode.

The layer params are STACKED as in the reference (a leading ``layers`` axis
on every leaf of a stack), so Eq. 1 scores, mask expansion and Eq. 10
aggregation see the reference's layouts.  The dense family has one stack,
``blocks``; the MoE family a ``moe_blocks`` stack, after a
``dense_blocks`` stack of ``first_k_dense`` layers where the config has
them.  The backbone is a Python loop over the layers; the reference's
``lax.scan`` and remat are compile devices with the same numbers.

Helios masks enter as a dict of stacked unit masks
``{"heads": (L, H), "mlp": (L, d_ff)}`` (MoE: ``"experts": (L, E)``, with
stack-scoped head keys such as ``"moe_blocks:heads"`` when there are two
stacks), sliced per layer; masked-out units drop out of the forward pass,
so their parameters get zero gradient.

The VLM (``vlm``) is the dense LM behind a stub image frontend: the batch
carries ``image_embeds`` (B, num_image_tokens, d), placed before the token
embeddings inside the one causal sequence (flash attends over both), with
a zero loss mask; the loss scores text positions only.

DeepSeek-V2 (``use_mla``) attends through Multi-head Latent Attention
(:mod:`repro_torch.models.mla`) in every block, as the reference does:
through ``rt["attn_impl"]`` even under ``kernels="cuda"``, so MLA reaches
no kernel; its dense first layer's masked MLP does (the masked-matmul
pair).

Serving (:func:`lm_prefill`, :func:`lm_decode`) follows the reference's
code: attention takes ``rt["attn_impl"]`` and the MLP its plain masked
form, so neither reaches a kernel.  The cache is ``{"kv": [one dict a
stack], "pos": host int}``: ``{"k", "v"}`` each (L, B, S, KV, hd), or
under MLA the latent ``{"c_kv": (L, B, S, kv_rank), "k_rope": (L, B, S,
rope)}``, which decode reads in the absorbed form; decode writes each
layer's new entries into it in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mla, moe
from repro_torch.models.module import stack, unstack

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"the decoder-only LM has the dense, MoE and VLM families, got "
            f"{cfg.family!r}")


def _attn_spec(cfg: ModelConfig):
    if cfg.use_mla:
        return mla.mla_spec(cfg)
    return L.attention_spec(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, cfg.qkv_bias)


def _block_spec(cfg: ModelConfig, kind: str):
    spec = {
        "attn_norm": L.norm_spec(cfg.d_model, cfg.norm),
        "attn": _attn_spec(cfg),
        "mlp_norm": L.norm_spec(cfg.d_model, cfg.norm),
    }
    if kind == "moe":
        spec["moe"] = moe.moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation)
    return spec


def lm_spec(cfg: ModelConfig):
    _check_family(cfg)
    spec: Dict[str, Any] = {"embed": L.embed_spec(cfg.padded_vocab,
                                                  cfg.d_model,
                                                  cfg.tie_embeddings)}
    if cfg.family == "moe":
        if cfg.first_k_dense:
            spec["dense_blocks"] = stack(_block_spec(cfg, "dense"),
                                         cfg.first_k_dense)
        spec["moe_blocks"] = stack(_block_spec(cfg, "moe"),
                                   cfg.num_layers - cfg.first_k_dense)
    else:
        spec["blocks"] = stack(_block_spec(cfg, "dense"), cfg.num_layers)
    spec["final_norm"] = L.norm_spec(cfg.d_model, cfg.norm)
    return spec


def mask_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    """Helios maskable-unit table: key -> (num_layers, units).

    A MoE model with a leading dense stack uses stack-scoped head keys
    ("moe_blocks:heads") so scores and masks align with each stack.
    """
    _check_family(cfg)
    if cfg.family == "moe":
        n_moe = cfg.num_layers - cfg.first_k_dense
        if cfg.first_k_dense:
            return {"dense_blocks:heads": (cfg.first_k_dense, cfg.num_heads),
                    "moe_blocks:heads": (n_moe, cfg.num_heads),
                    "mlp": (cfg.first_k_dense, cfg.d_ff),
                    "experts": (n_moe, cfg.num_experts)}
        return {"heads": (cfg.num_layers, cfg.num_heads),
                "experts": (cfg.num_layers, cfg.num_experts)}
    return {"heads": (cfg.num_layers, cfg.num_heads),
            "mlp": (cfg.num_layers, cfg.d_ff)}


def _stack_masks(masks, name: str, kind: str, n_layers: int):
    """Per-stack mask slices under canonical keys (heads / mlp / experts)."""
    if not masks:
        return {}
    sl = {}
    hk = f"{name}:heads" if f"{name}:heads" in masks else "heads"
    if hk in masks and masks[hk].shape[0] == n_layers:
        sl["heads"] = masks[hk]
    ok = "experts" if kind == "moe" else "mlp"
    if ok in masks and masks[ok].shape[0] == n_layers:
        sl[ok] = masks[ok]
    return sl


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _block_fwd(p, x, positions, cfg, rt, *, kind: str, head_mask=None,
               mlp_mask=None, expert_mask=None, mode: str = "train",
               cache=None, pos=None):
    """One pre-norm block; returns (x, its cache entries or None in
    training).

    ``mode``: train | prefill (also returns the block's K / V, or MLA's
    latent) | decode (writes the token's entries into ``cache`` at
    ``pos``).  In training ``rt["kernels"] == "cuda"`` routes the causal
    self-attention through the flash kernel (unless the runtime asks for
    the chunked lowering) and the masked MLP through the masked-matmul
    pair; MLA keeps ``rt["attn_impl"]``, and serving takes it and the
    plain MLP, as the reference's code does.  The MoE block takes no
    kernel, as in the reference."""
    kern = rt.get("kernels") if mode == "train" else None
    on_kernels = kern is not None and ops.canonical_impl(kern) == ops.CUDA
    attn_impl = ops.CUDA if (on_kernels and rt["attn_impl"] != "chunked") \
        else rt["attn_impl"]
    h = L.apply_norm(p["attn_norm"], x, cfg.norm)
    kv = None
    if mode == "decode" and cfg.use_mla:
        a, _ = mla.mla_decode(p["attn"], h, cache, pos, cfg,
                              head_mask=head_mask)
    elif mode == "decode":
        a, _ = L.attention_decode(p["attn"], h, cache, pos,
                                  theta=cfg.rope_theta, head_mask=head_mask)
    elif cfg.use_mla:
        a = mla.mla_fwd(p["attn"], h, positions, cfg, impl=rt["attn_impl"],
                        head_mask=head_mask, return_cache=mode == "prefill")
    else:
        a = L.attention_fwd(p["attn"], h, positions, theta=cfg.rope_theta,
                            impl=attn_impl, head_mask=head_mask,
                            return_kv=mode == "prefill")
    if mode == "prefill":
        a, kv = a
    x = x + a
    h = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    if kind == "moe":
        y = moe.moe_fwd(p["moe"], h, cfg, expert_mask=expert_mask,
                        impl=rt["moe_impl"], moe_groups=rt["moe_groups"])
    else:
        y = L.mlp_fwd(p["mlp"], h, cfg.activation, unit_mask=mlp_mask,
                      kernels=kern, mask_block=rt.get("mask_block", 128))
    return x + y, kv


def _stacks(params):
    """Ordered (name, kind) of the layer stacks present."""
    return [(name, kind) for name, kind in (("dense_blocks", "dense"),
                                            ("moe_blocks", "moe"),
                                            ("blocks", "dense"))
            if name in params]


def _backbone(params, x, positions, cfg, rt, masks=None, mode: str = "train",
              cache=None):
    """The layer stacks and the final norm.  ``mode``: train | prefill |
    decode (one token at ``cache["pos"]``, each layer's entries written
    into ``cache`` in place).  Returns (h, the prefill's per-stack caches
    (``{"k", "v"}`` each (L, B, S, KV, hd), or MLA's ``{"c_kv",
    "k_rope"}``), empty otherwise)."""
    caches = []
    for ci, (name, kind) in enumerate(_stacks(params)):
        stacked = params[name]
        n_layers = stacked["attn_norm"]["scale"].shape[0]
        sl = _stack_masks(masks, name, kind, n_layers)
        unit = "experts" if kind == "moe" else "mlp"
        layer_caches = []
        for i, p in enumerate(unstack(stacked, n_layers)):
            um = sl[unit][i] if unit in sl else None
            layer_kv = None
            if mode == "decode":
                layer_kv = {k: v[i] for k, v in cache["kv"][ci].items()}
            x, kv = _block_fwd(
                p, x, positions, cfg, rt,
                kind=kind, head_mask=sl["heads"][i] if "heads" in sl else None,
                mlp_mask=um if kind == "dense" else None,
                expert_mask=um if kind == "moe" else None,
                mode=mode, cache=layer_kv,
                pos=cache["pos"] if mode == "decode" else None)
            if kv is not None:
                layer_caches.append(kv)
        if layer_caches:
            caches.append({k: torch.stack([c[k] for c in layer_caches])
                           for k in layer_caches[0]})
        del layer_caches
    return L.apply_norm(params["final_norm"], x, cfg.norm), caches


# ---------------------------------------------------------------------------
# Entry point: the training loss
# ---------------------------------------------------------------------------


def default_runtime() -> dict:
    """Execution knobs threaded through the model functions (the
    reference's ``default_runtime`` at training lengths)."""
    return {"attn_impl": "auto", "moe_impl": "grouped", "moe_groups": 1,
            "kernels": ops.REFERENCE, "mask_block": 128}


def _embed_inputs(params, batch, cfg):
    """Token embedding, after the VLM's image prefix.  Returns (x,
    loss_mask), the mask 0 over the prefix."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    loss_mask = torch.ones(tokens.shape, dtype=x.dtype, device=x.device)
    if cfg.family == "vlm":
        img = batch["image_embeds"].to(x.dtype)             # (B, Nimg, d)
        x = torch.cat([img, x], dim=1)
        loss_mask = torch.cat([img.new_zeros(img.shape[:2]), loss_mask],
                              dim=1)
    return x, loss_mask


def lm_loss(params, batch, cfg: ModelConfig, rt, masks=None):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S), scored
    from the text offset on (after a VLM's image prefix); the last
    position has no target."""
    x, loss_mask = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    h, _ = _backbone(params, x, positions, cfg, rt, masks)
    logits = L.unembed(params["embed"], h)
    tokens = batch["tokens"]
    targets = torch.cat([tokens, torch.zeros((b, 1), dtype=tokens.dtype,
                                             device=tokens.device)], dim=1)
    offset = s - tokens.shape[1]                        # image prefix length
    tgt = targets[:, 1:]
    pred = logits[:, offset:offset + tgt.shape[1]]
    mask = loss_mask[:, offset:offset + tgt.shape[1]].clone()
    mask[:, -1] = 0.0                                   # no target for last
    return L.cross_entropy_loss(pred, tgt, mask)


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------


def lm_prefill(params, batch, cfg: ModelConfig, rt, masks=None
               ) -> Tuple[torch.Tensor, dict]:
    """Forward over the prompt ``batch["tokens"]`` (B, S), after a VLM's
    image prefix; returns the last position's logits (B, V) and the cache,
    exactly as long as the sequence (prefix included)."""
    x, _ = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    h, caches = _backbone(params, x, positions, cfg, rt, masks,
                          mode="prefill")
    logits = L.unembed(params["embed"], h[:, -1:])
    return logits[:, 0], {"kv": caches, "pos": s}


def lm_decode(params, token, cache, cfg: ModelConfig, rt, masks=None
              ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  ``token`` (B, 1) int at position ``cache["pos"]``;
    each layer's K / V land in ``cache`` in place (its sequence axis must
    have room: see :func:`layers.attention_decode`).  Returns (logits
    (B, V), cache with ``pos`` advanced)."""
    x = L.embed(params["embed"], token)
    h, _ = _backbone(params, x, None, cfg, rt, masks, mode="decode",
                     cache=cache)
    logits = L.unembed(params["embed"], h)
    return logits[:, 0], {"kv": cache["kv"], "pos": cache["pos"] + 1}
