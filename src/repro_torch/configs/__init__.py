"""Config registry of the port: the paper CNNs, the dense LM, and their
reduced test sizes."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import deepseek_7b
from repro_torch.configs.base import HeliosConfig, ModelConfig
from repro_torch.configs.paper_cnns import ALEXNET, CNNS, LENET, RESNET18

DEEPSEEK_7B = deepseek_7b.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU tests.

    CNN: channels / 8 (at least 4), images at most 16 pixels; the dense
    widths (fc0/fc1) stay full.  Dense LM: 4 layers, d_model 64, 4 heads of
    16 at the same GQA ratio, d_ff 96, vocab 256 (the reference's sizes).
    """
    if cfg.family == "cnn":
        return dataclasses.replace(
            cfg, cnn_channels=tuple(max(4, c // 8) for c in cfg.cnn_channels),
            image_size=min(cfg.image_size, 16))
    if cfg.family != "dense":
        raise ValueError(f"reduced: the port has CNN and dense configs, got "
                         f"family {cfg.family!r}")
    kv_ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    heads = 4 if cfg.num_heads % 2 == 0 else 3   # keep odd-head quirk
    kv = max(1, heads // min(kv_ratio, heads))
    return dataclasses.replace(cfg, d_model=64, num_heads=heads,
                               num_kv_heads=kv, head_dim=16,
                               d_ff=96 if cfg.d_ff else 0, vocab_size=256,
                               num_layers=4)


__all__ = ["ALEXNET", "CNNS", "DEEPSEEK_7B", "LENET", "RESNET18",
           "HeliosConfig", "ModelConfig", "reduced"]
