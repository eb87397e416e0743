"""Config registry of the port: the paper CNNs and their reduced test sizes."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import HeliosConfig, ModelConfig
from repro_torch.configs.paper_cnns import ALEXNET, CNNS, LENET, RESNET18


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same CNN for CPU tests: channels / 8 (at least
    4), images at most 16 pixels.  The dense widths (fc0/fc1) stay full."""
    if cfg.family != "cnn":
        raise ValueError(f"reduced: the port has only CNN configs, got "
                         f"family {cfg.family!r}")
    return dataclasses.replace(
        cfg, cnn_channels=tuple(max(4, c // 8) for c in cfg.cnn_channels),
        image_size=min(cfg.image_size, 16))


__all__ = ["ALEXNET", "CNNS", "LENET", "RESNET18", "HeliosConfig",
           "ModelConfig", "reduced"]
