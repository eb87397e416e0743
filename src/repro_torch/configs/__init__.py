"""Config registry of the port: the paper CNNs and the reference's ten
LM configs (the dense LMs: DeepSeek and the three QKV-bias Qwen configs;
the MoE LMs Granite and DeepSeek-V2 with its latent attention; the
hybrid, xLSTM, the VLM and the SeamlessM4T encoder-decoder), their
reduced test sizes, and the name lookup the CLIs use."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (codeqwen1_5_7b, deepseek_7b,
                                 deepseek_v2_236b, granite_moe_1b_a400m,
                                 internvl2_1b, qwen1_5_32b, qwen2_5_32b,
                                 seamless_m4t_large_v2, xlstm_125m,
                                 zamba2_1_2b)
from repro_torch.configs.base import HeliosConfig, ModelConfig, TrainConfig
from repro_torch.configs.paper_cnns import ALEXNET, CNNS, LENET, RESNET18

SEAMLESS_M4T_LARGE_V2 = seamless_m4t_large_v2.CONFIG
DEEPSEEK_V2_236B = deepseek_v2_236b.CONFIG
DEEPSEEK_7B = deepseek_7b.CONFIG
GRANITE_MOE_1B_A400M = granite_moe_1b_a400m.CONFIG
ZAMBA2_1_2B = zamba2_1_2b.CONFIG
QWEN1_5_32B = qwen1_5_32b.CONFIG
QWEN2_5_32B = qwen2_5_32b.CONFIG
CODEQWEN1_5_7B = codeqwen1_5_7b.CONFIG
XLSTM_125M = xlstm_125m.CONFIG
INTERNVL2_1B = internvl2_1b.CONFIG

#: the LM configs by name (the reference's ``ARCHS``, in its order)
ARCHS = {c.name: c for c in (SEAMLESS_M4T_LARGE_V2, GRANITE_MOE_1B_A400M,
                             DEEPSEEK_V2_236B, DEEPSEEK_7B, QWEN1_5_32B,
                             QWEN2_5_32B, CODEQWEN1_5_7B, ZAMBA2_1_2B,
                             XLSTM_125M, INTERNVL2_1B)}
ALL_MODELS = {**ARCHS, **CNNS}


def get_model_config(name: str) -> ModelConfig:
    try:
        return ALL_MODELS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(ALL_MODELS)}") from None


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU tests.

    CNN: channels / 8 (at least 4), images at most 16 pixels; the dense
    widths (fc0/fc1) stay full.  Token LMs: 4 layers, d_model 64, 4 heads
    of 16 (3 where the head count is odd) at the same GQA ratio, d_ff 96,
    vocab 256 (the reference's sizes).  MoE: the same, with 8 experts,
    top-min(2, k), expert width 32 and one leading dense layer where the
    config has any.  MLA: q / kv latent ranks 32 / 16, q-k head dims 16
    (no RoPE) + 8 (RoPE), value head dim 16.  Hybrid and xLSTM: Mamba2
    heads of 16, state 16, chunk 32; the hybrid's shared block every 2
    layers, xLSTM's one sLSTM block at index 1.  VLM: 8 image tokens.
    Encoder-decoder: 2 encoder + 2 decoder layers.
    """
    if cfg.family == "cnn":
        return dataclasses.replace(
            cfg, cnn_channels=tuple(max(4, c // 8) for c in cfg.cnn_channels),
            image_size=min(cfg.image_size, 16))
    kv_ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    heads = 4 if cfg.num_heads % 2 == 0 else 3   # keep odd-head quirk
    kv = max(1, heads // min(kv_ratio, heads))
    upd = dict(d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
               d_ff=96 if cfg.d_ff else 0, vocab_size=256, num_layers=4)
    if cfg.family == "encdec":
        upd.update(enc_layers=2, dec_layers=2)
    if cfg.slstm_layers:
        upd["slstm_layers"] = (1,)           # one sLSTM in the reduced stack
    if cfg.attn_every:
        upd["attn_every"] = 2
    if cfg.first_k_dense:
        upd["first_k_dense"] = 1
    if cfg.family == "moe":
        upd.update(num_experts=8,
                   num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                   moe_d_ff=32)
    if cfg.use_mla:
        upd.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16)
    if cfg.family in ("hybrid", "ssm"):
        upd.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.num_image_tokens:
        upd["num_image_tokens"] = 8
    return dataclasses.replace(cfg, **upd)


__all__ = ["ALEXNET", "ALL_MODELS", "ARCHS", "CNNS", "CODEQWEN1_5_7B",
           "DEEPSEEK_7B", "DEEPSEEK_V2_236B", "GRANITE_MOE_1B_A400M",
           "INTERNVL2_1B", "LENET", "QWEN1_5_32B", "QWEN2_5_32B", "RESNET18",
           "SEAMLESS_M4T_LARGE_V2", "XLSTM_125M", "ZAMBA2_1_2B", "HeliosConfig", "ModelConfig", "TrainConfig",
           "get_model_config", "reduced"]
