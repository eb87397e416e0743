"""Config registry of the port: the paper CNNs, the dense LM, the MoE LM,
the hybrid, and their reduced test sizes."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import deepseek_7b, granite_moe_1b_a400m, zamba2_1_2b
from repro_torch.configs.base import HeliosConfig, ModelConfig
from repro_torch.configs.paper_cnns import ALEXNET, CNNS, LENET, RESNET18

DEEPSEEK_7B = deepseek_7b.CONFIG
GRANITE_MOE_1B_A400M = granite_moe_1b_a400m.CONFIG
ZAMBA2_1_2B = zamba2_1_2b.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU tests.

    CNN: channels / 8 (at least 4), images at most 16 pixels; the dense
    widths (fc0/fc1) stay full.  Dense LM: 4 layers, d_model 64, 4 heads of
    16 at the same GQA ratio, d_ff 96, vocab 256 (the reference's sizes).
    MoE: the same, with 8 experts, top-min(2, k), expert width 32 and one
    leading dense layer where the config has any.  Hybrid: the same, with
    the shared block every 2 layers and Mamba2 heads of 16, state 16,
    chunk 32.
    """
    if cfg.family == "cnn":
        return dataclasses.replace(
            cfg, cnn_channels=tuple(max(4, c // 8) for c in cfg.cnn_channels),
            image_size=min(cfg.image_size, 16))
    if cfg.family not in ("dense", "moe", "hybrid") or cfg.use_mla:
        raise ValueError(
            f"reduced: the port has CNN, dense, MoE and hybrid configs, got "
            f"family {cfg.family!r} (use_mla={cfg.use_mla}); MLA and VLM wait"
            f" (ROADMAP.md, modules to port, item 9), xlstm and encdec too "
            f"(item 15)")
    kv_ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    heads = 4 if cfg.num_heads % 2 == 0 else 3   # keep odd-head quirk
    kv = max(1, heads // min(kv_ratio, heads))
    upd = dict(d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
               d_ff=96 if cfg.d_ff else 0, vocab_size=256, num_layers=4)
    if cfg.attn_every:
        upd["attn_every"] = 2
    if cfg.first_k_dense:
        upd["first_k_dense"] = 1
    if cfg.family == "moe":
        upd.update(num_experts=8,
                   num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                   moe_d_ff=32)
    if cfg.family == "hybrid":
        upd.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    return dataclasses.replace(cfg, **upd)


__all__ = ["ALEXNET", "CNNS", "DEEPSEEK_7B", "GRANITE_MOE_1B_A400M", "LENET",
           "RESNET18", "ZAMBA2_1_2B", "HeliosConfig", "ModelConfig",
           "reduced"]
